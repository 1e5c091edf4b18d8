"""Synthetic training data: microvessel image/mask pairs and invasion-assay slices.

A copy of ``tmat_tpu/models/synthetic.py`` (numpy and scipy; PIL only
inside the writers): the same seeded ``RandomState`` gives the same
images, and the writers the same files, in both packages.

Usage:
    python -m tmat_torch.models.synthetic OUT_DIR [--n 200] [--size 320]
        [--kind vessels|invasion] [--seed 0]
writes ``s{i}.tif`` / ``s{i}_mask.tif`` pairs for ``train_segmentation``,
or ``no_invasion/`` + ``invasion/`` class dirs for ``train_invasion``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np
from numpy.random import RandomState
from scipy import ndimage


def _random_curve(rng: RandomState, size: int, n_ctrl: int = 4) -> np.ndarray:
    """Sampled points along a random quadratic-ish Bezier chain."""
    ctrl = rng.rand(n_ctrl, 2) * size
    ts = np.linspace(0, 1, 40)
    points = []
    for i in range(n_ctrl - 2):
        p0, p1, p2 = ctrl[i], ctrl[i + 1], ctrl[i + 2]
        seg = (
            ((1 - ts) ** 2)[:, None] * p0
            + (2 * ts * (1 - ts))[:, None] * p1
            + (ts**2)[:, None] * p2
        )
        points.append(seg)
    return np.concatenate(points)


def synth_vessel_image(
    rng: RandomState, size: int = 320, n_vessels: int = None
) -> Tuple[np.ndarray, np.ndarray]:
    """One (image uint8, mask uint8 {0,255}) pair."""
    n_vessels = n_vessels if n_vessels is not None else rng.randint(2, 7)
    mask = np.zeros((size, size), bool)

    for _ in range(n_vessels):
        pts = _random_curve(rng, size)
        width = rng.uniform(1.5, 5.0)
        canvas = np.zeros((size, size), bool)
        ij = np.clip(np.round(pts).astype(int), 0, size - 1)
        canvas[ij[:, 0], ij[:, 1]] = True
        # densify: connect consecutive samples
        for k in range(len(ij) - 1):
            n_interp = int(np.abs(ij[k + 1] - ij[k]).max()) + 1
            rr = np.linspace(ij[k, 0], ij[k + 1, 0], n_interp).round().astype(int)
            cc = np.linspace(ij[k, 1], ij[k + 1, 1], n_interp).round().astype(int)
            canvas[rr, cc] = True
        dist = ndimage.distance_transform_edt(~canvas)
        mask |= dist <= width

    brightness = rng.uniform(120, 220)
    img = np.zeros((size, size), np.float32)
    img[mask] = brightness * rng.uniform(0.7, 1.0, size=mask.sum())
    img = ndimage.gaussian_filter(img, rng.uniform(0.8, 1.6))
    # background texture + sensor noise
    img += ndimage.gaussian_filter(rng.rand(size, size) * 40, 4)
    img += rng.normal(0, 6, (size, size))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, (mask.astype(np.uint8) * 255)


def synth_invasion_image(
    rng: RandomState, size: int = 256, invaded: bool = False
) -> np.ndarray:
    """One grayscale uint8 Z-slice of a synthetic spheroid invasion assay.

    The reference's invasion-depth classifier labels each Z slice of a
    hydrogel well as invasion / no-invasion (capabilities_overview.ipynb
    cells 15-16; class_labels in invasion_depth_training_values.json).
    no_invasion: a compact bright spheroid with a smooth boundary, or a
    dim out-of-focus slice below the invasion front. invasion: the same
    spheroid plus radial strands and scattered single-cell blobs
    migrating into the surrounding gel.

    The class-conditional distributions deliberately OVERLAP so held-out
    accuracy is a meaningful model-quality metric (the reference ensemble
    scores 0.857-0.949 val_acc, BASELINE.md): no_invasion slices carry
    0-10 dim debris blobs scattered uniformly (not annular) and a rough
    spheroid rim; invaded slices can be weak — as few as 4 faint
    migrating cells and possibly no collective strands. The Bayes
    boundary is the annular concentration of cells around the core, not
    a bright/dark shortcut.
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = size / 2 + rng.uniform(-size * 0.06, size * 0.06)
    cx = size / 2 + rng.uniform(-size * 0.06, size * 0.06)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)

    img = np.zeros((size, size), np.float32)
    brightness = rng.uniform(120, 220)
    r0 = rng.uniform(size * 0.10, size * 0.20)

    dim_empty = (not invaded) and rng.rand() < 0.3
    if dim_empty:
        # slice below the spheroid: faint defocused ghost only
        img += brightness * 0.15 * np.exp(-((d / (r0 * 1.5)) ** 2))
    else:
        edge = rng.uniform(1.5, 4.0)
        rim = brightness / (1 + np.exp(np.clip((d - r0) / edge, -60, 60)))
        # rough rim: low-frequency radial lumpiness (both classes)
        lump = ndimage.gaussian_filter(rng.rand(size, size) - 0.5, 12)
        img += rim * (1 + 1.5 * lump)

    if not invaded and not dim_empty:
        # debris / dead cells. Half the negatives place their debris in
        # the SAME annulus invading cells occupy (settled debris rings
        # the spheroid in real assays) with counts overlapping the weak-
        # invasion range — the discriminative signal is then density and
        # morphology, not mere presence of blobs near the core.
        annular = rng.rand() < 0.5
        for _ in range(rng.randint(0, 13)):
            if annular:
                ang = rng.uniform(0, 2 * np.pi)
                rad = r0 * rng.uniform(1.15, 2.6)
                by, bx = cy + rad * np.sin(ang), cx + rad * np.cos(ang)
                if not (0 <= by < size and 0 <= bx < size):
                    continue
            else:
                by, bx = rng.uniform(0, size), rng.uniform(0, size)
            sig = rng.uniform(1.0, 3.0)
            amp = brightness * rng.uniform(0.15, 0.6)
            img += amp * np.exp(
                -(((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sig**2))
            )

    if invaded:
        # scattered migrating cells in an annulus around the core; weak
        # cases (few, faint cells) overlap the debris distribution, and
        # ~10% of invaded slices show NO cells at all (the invasion front
        # sits outside this focal plane) — irreducible label ambiguity,
        # so a perfect val score is unattainable by construction and the
        # tracked val_acc is a meaningful quality metric
        n_cells = 0 if rng.rand() < 0.1 else rng.randint(3, 70)
        for _ in range(n_cells):
            ang = rng.uniform(0, 2 * np.pi)
            rad = r0 * rng.uniform(1.15, 2.6)
            by, bx = cy + rad * np.sin(ang), cx + rad * np.cos(ang)
            if not (0 <= by < size and 0 <= bx < size):
                continue
            sig = rng.uniform(1.0, 3.0)
            amp = brightness * rng.uniform(0.2, 0.9)
            img += amp * np.exp(
                -(((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sig**2))
            )
        # radial strands (collective invasion fronts); sometimes absent,
        # always absent on out-of-focal-plane slices (n_cells == 0)
        for _ in range(rng.randint(0, 9) if n_cells else 0):
            ang = rng.uniform(0, 2 * np.pi)
            steps = rng.randint(15, 40)
            py, px = cy + r0 * 0.9 * np.sin(ang), cx + r0 * 0.9 * np.cos(ang)
            for _s in range(steps):
                ang += rng.normal(0, 0.18)
                py += 2.0 * np.sin(ang)
                px += 2.0 * np.cos(ang)
                if not (0 <= py < size and 0 <= px < size):
                    break
                sig = rng.uniform(0.8, 1.6)
                img += (
                    brightness
                    * rng.uniform(0.3, 0.6)
                    * np.exp(-(((yy - py) ** 2 + (xx - px) ** 2) / (2 * sig**2)))
                )

    img = ndimage.gaussian_filter(img, rng.uniform(0.6, 1.4))
    img += ndimage.gaussian_filter(rng.rand(size, size) * 30, 4)
    img += rng.normal(0, 5, (size, size))
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_invasion_dataset(
    out_dir, n_per_class: int = 300, size: int = 256, seed: int = 0
) -> None:
    """Write no_invasion/ + invasion/ class dirs for train_invasion."""
    from PIL import Image

    out_dir = Path(out_dir)
    rng = RandomState(seed)
    for name, invaded in (("no_invasion", False), ("invasion", True)):
        cls_dir = out_dir / name
        cls_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            img = synth_invasion_image(rng, size, invaded)
            Image.fromarray(img).save(cls_dir / f"{name}_{i}.tif")


def generate_dataset(out_dir, n: int = 200, size: int = 320, seed: int = 0) -> None:
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = RandomState(seed)
    for i in range(n):
        img, mask = synth_vessel_image(rng, size)
        Image.fromarray(img).save(out_dir / f"s{i}.tif")
        Image.fromarray(mask).save(out_dir / f"s{i}_mask.tif")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir", type=str)
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--kind",
        choices=("vessels", "invasion"),
        default="vessels",
        help=(
            "vessels: s{i}.tif/s{i}_mask.tif segmentation pairs; "
            "invasion: no_invasion/ + invasion/ class dirs (--n per class)"
        ),
    )
    args = p.parse_args(argv)
    if args.kind == "invasion":
        generate_invasion_dataset(args.out_dir, args.n, args.size, args.seed)
        print(f"Wrote {args.n} images per class to {args.out_dir}")
    else:
        generate_dataset(args.out_dir, args.n, args.size, args.seed)
        print(f"Wrote {args.n} image/mask pairs to {args.out_dir}")


if __name__ == "__main__":
    main()
