"""Vessel-network wells for the plate cells, drawn from ``--seed``.

Frozen copy of the recipe of ``tmat_torch/models/synthetic.py::
synth_vessel_image`` (taken when the benchmark was written; the benchmark
never imports the program's generator): random quadratic Bezier chains of
four control points, each widened by a distance transform to a half-width
drawn in [1.5, 5] px, per-pixel brightness, a Gaussian blur, a smooth
background texture and sensor noise. The recipe draws 2-6 curves in a 320
px field; a well of ``size`` px keeps that density per area by drawing
each curve in a 320 px field placed at random in the well. Only the
distance transform is taken over the curve's bounding box and not the
whole field, which gives the same mask, and the curve is sampled densely
instead of joined by straight lines.

A well is a Z stack: the network is sharp in one slice and blurred and
dimmed with the distance from it in the others, each slice with its own
noise (drawn in float32 by a generator seeded from the well's). Every seed gets the same set of curve counts (``curve_counts``), in
a seeded order, so that seeds change the content and not the amount of
work.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from numpy.random import RandomState
from scipy import ndimage

FIELD = 320  # the recipe's field, in which it draws 2-6 curves


def seeded(seed: int, *salt: int) -> RandomState:
    """A RandomState from any whole ``seed`` (more than 32 bits too) and a salt."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, *salt]).generate_state(1)
    return RandomState(int(state[0]))


def _random_curve(rng: RandomState, size: int, n_ctrl: int = 4, samples: int = 40) -> np.ndarray:
    """Points along a chain of quadratic Bezier segments through random
    control points, ``samples`` to a segment."""
    ctrl = rng.rand(n_ctrl, 2) * size
    ts = np.linspace(0, 1, samples)
    points = []
    for i in range(n_ctrl - 2):
        p0, p1, p2 = ctrl[i], ctrl[i + 1], ctrl[i + 2]
        points.append(((1 - ts) ** 2)[:, None] * p0 + (2 * ts * (1 - ts))[:, None] * p1
                      + (ts**2)[:, None] * p2)
    return np.concatenate(points)


def vessel_mask(rng: RandomState, size: int, n_vessels: int) -> np.ndarray:
    """The union of ``n_vessels`` widened curves, each in a FIELD px field.
    A curve is sampled densely (one point per px of a FIELD-long segment or
    closer) where the recipe joins 40 samples a segment by straight lines."""
    field = min(FIELD, size)
    mask = np.zeros((size, size), bool)
    for _ in range(n_vessels):
        offset = rng.randint(0, size - field + 1, size=2)
        pts = _random_curve(rng, field, samples=4 * field) + offset
        width = rng.uniform(1.5, 5.0)
        ij = np.clip(np.round(pts).astype(int), 0, size - 1)
        # the curve on a box around it, with room for the width
        pad = int(np.ceil(width)) + 2
        lo = np.maximum(ij.min(axis=0) - pad, 0)
        hi = np.minimum(ij.max(axis=0) + pad + 1, size)
        canvas = np.zeros(tuple(hi - lo), bool)
        canvas[ij[:, 0] - lo[0], ij[:, 1] - lo[1]] = True
        dist = ndimage.distance_transform_edt(~canvas)
        mask[lo[0]:hi[0], lo[1]:hi[1]] |= dist <= width
    return mask


def gaussian(x, sigma: float):
    """Separable Gaussian blur (radius 4 sigma, mirrored edges) of an (H, W) tensor."""
    import torch
    import torch.nn.functional as F

    r = max(1, int(4 * sigma + 0.5))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    y = F.pad(x[None, None], (r, r, r, r), mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, 1, -1))
    return F.conv2d(y, k.reshape(1, 1, -1, 1))[0, 0]


def vessel_well(rng: RandomState, size: int, n_z: int, n_vessels: int, device="cpu") -> np.ndarray:
    """One uint8 (n_z, size, size) well: the network sharp in one slice,
    blurred by a Gaussian of 1.5 px a slice of distance (each blur grown
    from the one before: variances add) and dimmed by 8% a slice. The
    slices are drawn on ``device`` by a ``torch.Generator`` seeded from
    ``rng``."""
    import torch

    mask = vessel_mask(rng, size, n_vessels)
    brightness = rng.uniform(120, 220)
    signal = np.zeros((size, size), np.float32)
    signal[mask] = brightness * rng.uniform(0.7, 1.0, size=int(mask.sum()))
    sigma0, z_sharp = rng.uniform(0.8, 1.6), rng.randint(0, n_z)
    gen = torch.Generator(device=device).manual_seed(int(rng.randint(2**31)))
    blurred = [gaussian(torch.from_numpy(signal).to(device), sigma0)]
    background = gaussian(torch.rand((size, size), generator=gen, device=device) * 40, 4)
    for d in range(1, max(z_sharp, n_z - 1 - z_sharp) + 1):
        blurred.append(gaussian(blurred[-1], 1.5 * np.sqrt(d * d - (d - 1) * (d - 1))))
    well = torch.empty((n_z, size, size), dtype=torch.uint8, device=device)
    for z in range(n_z):
        away = abs(z - z_sharp)
        img = blurred[away] * (1 - 0.08 * away) + background
        img += torch.randn((size, size), generator=gen, device=device) * 6
        well[z] = torch.clamp(img, 0, 255).to(torch.uint8)
    return well.cpu().numpy()


def curve_counts(n_wells: int, size: int, lo: int = 2, hi: int = 6) -> List[int]:
    """The same spread of curve counts for every seed: the recipe's lo-hi
    curves per FIELD px field, scaled to the well's area, evenly over the
    wells."""
    area = (size / FIELD) ** 2
    return [int(round(v)) for v in np.linspace(lo * area, hi * area, n_wells)]


def well_pool(seed: int, n_wells: int, size: int, n_z: int, device="cpu") -> np.ndarray:
    """uint8 (n_wells, n_z, size, size) distinct wells."""
    counts = curve_counts(n_wells, size)
    order = seeded(seed, 0).permutation(n_wells)
    return np.stack([vessel_well(seeded(seed, 1, i), size, n_z, counts[order[i]], device)
                     for i in range(n_wells)])


def d4_roll(well, k: int, shift: Sequence[int]):
    """Dihedral transform ``k`` (0-7) of each slice of a (Z, H, W) tensor,
    then a roll by ``shift``."""
    import torch

    out = torch.rot90(well, k % 4, dims=(-2, -1))
    if k >= 4:
        out = torch.flip(out, dims=(-1,))
    return torch.roll(out, tuple(int(v) for v in shift), dims=(-2, -1))


def plates(pool: np.ndarray, seed: int, n_plates: int, wells_per_plate: int,
           device="cpu") -> List[np.ndarray]:
    """``n_plates`` uint8 (wells_per_plate, Z, H, W) plates, each well one
    of the pool's under a seeded dihedral transform and roll (made on
    ``device``)."""
    import torch

    rng = seeded(seed, 2)
    size = pool.shape[-1]
    wells = torch.from_numpy(pool).to(device)
    out = []
    for _ in range(n_plates):
        picks = rng.choice(len(pool), wells_per_plate, replace=len(pool) < wells_per_plate)
        plate = torch.stack([d4_roll(wells[i], rng.randint(8), rng.randint(0, size, 2)) for i in picks])
        out.append(np.ascontiguousarray(plate.cpu().numpy()))
    return out


def make(seed: int, traffic: Dict, device="cpu") -> List[np.ndarray]:
    """The traffic's cycle of plates: ``cycle_plates`` plates of
    ``wells_per_plate`` wells of ``z`` x ``size`` x ``size``, drawn from a
    pool of ``pool_wells`` distinct wells."""
    pool = well_pool(seed, traffic["pool_wells"], traffic["size"], traffic["z"], device)
    return plates(pool, seed, traffic["cycle_plates"], traffic["wells_per_plate"], device)
