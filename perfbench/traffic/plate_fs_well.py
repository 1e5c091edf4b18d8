"""plate_fs_well's generator: whole wells as Z stacks of uneven depth, drawn from ``--seed``.

A well is a grey disc on a darker plate, with a soft rim (the disc's
indicator blurred by a Gaussian of ``rim_sigma`` px), so that the well
mask's search finds one well and the edge detection meets a gradient, not
a step. Its radius is drawn in ``radius`` (a share of the frame) and its
centre within ``centre`` of the frame's middle. Inside the disc only, a
vessel network after ``inputs/vessels.py``'s recipe (the same curve counts
for every seed, spread over the pool).

Focus varies by region: the disc is split into ``regions`` soft regions
(nearest of as many points drawn in the frame, the split blurred), each
with its own sharp slice among the first ``sharp_below`` (the smallest
depth of the plate), and in every other slice its vessels are blurred and
dimmed with the distance from it as in ``vessels.vessel_well``. So the
focus-stacking projection takes different slices in different places,
and differs from the max projection.

A plate takes ``wells_per_plate`` wells of the pool, each under a seeded
dihedral transform (no roll: a roll would cut the rim); the slices of well
``w`` at and beyond ``run_plate.z_counts[w]`` are replaced by uniform noise
over 0-255, which wins the focus argmax wherever it is counted. Every
slice is made on ``device`` from ``torch.Generator``s seeded from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.inputs.vessels import curve_counts, gaussian, seeded, vessel_mask


def _disc(rng, size: int, radius, centre, rim_sigma: float, device):
    """(hard bool, soft float32) disc of a radius drawn in ``radius`` (a
    share of the frame) centred within ``centre`` of the frame's middle."""
    import torch

    r = rng.uniform(*radius) * size
    cy, cx = size / 2 + rng.uniform(-centre, centre, 2) * size
    yy = torch.arange(size, dtype=torch.float32, device=device)[:, None] + 0.5
    xx = torch.arange(size, dtype=torch.float32, device=device)[None, :] + 0.5
    hard = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return hard, torch.clamp(gaussian(hard.float(), rim_sigma), 0, 1)


def _regions(rng, size: int, n: int, device):
    """(n, size, size) soft weights summing to 1: the nearest of ``n``
    points drawn in the frame, each indicator blurred by 12 px."""
    import torch

    pts = torch.as_tensor(rng.uniform(0, size, (n, 2)), dtype=torch.float32, device=device)
    yy = torch.arange(size, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(size, dtype=torch.float32, device=device)[None, :]
    d2 = torch.stack([(yy - p[0]) ** 2 + (xx - p[1]) ** 2 for p in pts])
    hard = torch.nn.functional.one_hot(d2.argmin(dim=0), n).permute(2, 0, 1).float()
    soft = torch.stack([gaussian(h, 12.0) for h in hard])
    return soft / soft.sum(dim=0, keepdim=True)


def fs_well(rng, traffic: Dict, n_vessels: int, device="cpu") -> np.ndarray:
    """One uint8 (z, size, size) well: disc, regions in focus in their own
    slices, background texture and per-slice sensor noise."""
    import torch

    size, n_z = traffic["size"], traffic["z"]
    g = traffic["well"]
    hard, soft = _disc(rng, size, g["radius"], g["centre"], g["rim_sigma"], device)
    mask = vessel_mask(rng, size, n_vessels) & hard.cpu().numpy()
    signal = np.zeros((size, size), np.float32)
    signal[mask] = rng.uniform(*g["vessel_level"]) * rng.uniform(0.7, 1.0, size=int(mask.sum()))
    weights = _regions(rng, size, g["regions"], device)
    sharp = rng.randint(0, g["sharp_below"], g["regions"])
    sigma0 = rng.uniform(0.8, 1.6)
    gen = torch.Generator(device=device).manual_seed(int(rng.randint(2**31)))
    blurred = [gaussian(torch.from_numpy(signal).to(device), sigma0)]
    for d in range(1, n_z):  # variances add: 1.5 px a slice of distance
        blurred.append(gaussian(blurred[-1], 1.5 * np.sqrt(d * d - (d - 1) * (d - 1))))
    lo, hi = g["outside_level"], g["inside_level"]
    base = lo + (hi - lo) * soft + gaussian(torch.rand((size, size), generator=gen, device=device) * 20, 4)
    well = torch.empty((n_z, size, size), dtype=torch.uint8, device=device)
    for z in range(n_z):
        img = base.clone()
        for r in range(g["regions"]):
            away = abs(z - int(sharp[r]))
            img += weights[r] * blurred[away] * (1 - 0.08 * away)
        img += torch.randn((size, size), generator=gen, device=device) * 6
        well[z] = torch.clamp(img, 0, 255).to(torch.uint8)
    return well.cpu().numpy()


def d4(well, k: int):
    """Dihedral transform ``k`` (0-7) of each slice of a (Z, H, W) tensor."""
    import torch

    out = torch.rot90(well, k % 4, dims=(-2, -1))
    return torch.flip(out, dims=(-1,)) if k >= 4 else out


def make(seed: int, traffic: Dict, device="cpu") -> List[np.ndarray]:
    """The cycle of ``cycle_plates`` uint8 (wells_per_plate, z, size, size)
    plates, drawn from a pool of ``pool_wells`` wells; well ``w`` of a plate
    holds noise from slice ``run_plate.z_counts[w]`` on."""
    import torch

    n, size = traffic["pool_wells"], traffic["size"]
    counts = curve_counts(n, size)
    order = seeded(seed, 0).permutation(n)
    pool = torch.from_numpy(np.stack([fs_well(seeded(seed, 1, i), traffic, counts[order[i]], device)
                                      for i in range(n)])).to(device)
    z_counts = traffic["run_plate"]["z_counts"]
    rng = seeded(seed, 2)
    gen = torch.Generator(device=device).manual_seed(int(seeded(seed, 3).randint(2**31)))
    plates = []
    for _ in range(traffic["cycle_plates"]):
        picks = rng.choice(n, traffic["wells_per_plate"], replace=n < traffic["wells_per_plate"])
        plate = torch.stack([d4(pool[i], rng.randint(8)) for i in picks])
        for w, zc in enumerate(z_counts):
            pad = plate[w, zc:]
            pad.copy_(torch.randint(0, 256, pad.shape, generator=gen, device=device, dtype=torch.uint8))
        plates.append(np.ascontiguousarray(plate.cpu().numpy()))
    return plates
