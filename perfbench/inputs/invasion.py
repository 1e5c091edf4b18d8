"""Invasion-assay Z stacks for the inv_depth cells, drawn from ``--seed``.

Frozen copy of the recipe of ``tmat_torch/models/synthetic.py::
synth_invasion_image`` (taken when the benchmark was written): a spheroid
with a rough rim, debris in the slices that are not invaded, migrating
cells and radial strands in those that are, then blur, background texture
and noise. Each Gaussian blob is drawn on a window of six standard
deviations around its centre instead of the whole slice (it differs there
by under 1e-7 of its amplitude), which makes a 1024 px slice fast.

Stacks are formed as ``chip_smoke.py::invasion_stacks`` forms them: stack
i holds the ``n_z`` distinct slices (not invaded and invaded in turn)
rolled by i along Z and shifted by (37 i, 53 i) px, so that no two stacks
are equal.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
from numpy.random import RandomState
from scipy import ndimage

from perfbench.inputs.vessels import seeded


def _blob(img: np.ndarray, by: float, bx: float, sig: float, amp: float) -> None:
    size = img.shape[0]
    r = int(np.ceil(6 * sig))
    y0, y1 = max(int(by) - r, 0), min(int(by) + r + 2, size)
    x0, x1 = max(int(bx) - r, 0), min(int(bx) + r + 2, size)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] += amp * np.exp(-(((yy - by) ** 2 + (xx - bx) ** 2) / (2 * sig**2)))


def invasion_slice(rng: RandomState, size: int = 256, invaded: bool = False) -> np.ndarray:
    """One grayscale uint8 slice (see the module doc)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = size / 2 + rng.uniform(-size * 0.06, size * 0.06)
    cx = size / 2 + rng.uniform(-size * 0.06, size * 0.06)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    img = np.zeros((size, size), np.float32)
    brightness = rng.uniform(120, 220)
    r0 = rng.uniform(size * 0.10, size * 0.20)

    dim_empty = (not invaded) and rng.rand() < 0.3
    if dim_empty:
        img += brightness * 0.15 * np.exp(-((d / (r0 * 1.5)) ** 2))
    else:
        edge = rng.uniform(1.5, 4.0)
        rim = brightness / (1 + np.exp(np.clip((d - r0) / edge, -60, 60)))
        lump = ndimage.gaussian_filter(rng.rand(size, size) - 0.5, 12)
        img += rim * (1 + 1.5 * lump)

    if not invaded and not dim_empty:
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
            _blob(img, by, bx, sig, brightness * rng.uniform(0.15, 0.6))

    if invaded:
        n_cells = 0 if rng.rand() < 0.1 else rng.randint(3, 70)
        for _ in range(n_cells):
            ang = rng.uniform(0, 2 * np.pi)
            rad = r0 * rng.uniform(1.15, 2.6)
            by, bx = cy + rad * np.sin(ang), cx + rad * np.cos(ang)
            if not (0 <= by < size and 0 <= bx < size):
                continue
            sig = rng.uniform(1.0, 3.0)
            _blob(img, by, bx, sig, brightness * rng.uniform(0.2, 0.9))
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
                _blob(img, py, px, sig, brightness * rng.uniform(0.3, 0.6))

    img = ndimage.gaussian_filter(img, rng.uniform(0.6, 1.4))
    img += ndimage.gaussian_filter(rng.rand(size, size) * 30, 4)
    img += rng.normal(0, 5, (size, size))
    return np.clip(img, 0, 255).astype(np.uint8)


def invasion_stacks(seed: int, n_stacks: int, n_z: int, size: int, threads: int = 8) -> np.ndarray:
    """uint8 (n_stacks, n_z, size, size) stacks (see the module doc)."""

    def one(z):
        return invasion_slice(seeded(seed, 3, z), size, invaded=bool(z % 2))

    with ThreadPoolExecutor(max(1, min(threads, n_z))) as pool:
        slices = np.stack(list(pool.map(one, range(n_z))))
    return np.stack([np.roll(np.roll(slices, i, axis=0), (37 * i, 53 * i), axis=(1, 2))
                     for i in range(n_stacks)])


def make(seed: int, traffic: Dict, device="cpu") -> np.ndarray:
    """The traffic's cycle of ``cycle_stacks`` stacks of ``z`` x ``size`` x ``size``."""
    return invasion_stacks(seed, traffic["cycle_stacks"], traffic["z"], traffic["size"])
