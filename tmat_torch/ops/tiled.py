"""Smooth tiled inference with dihedral test-time augmentation.

Counterpart of ``tmat_tpu/ops/tiled.py``: squared-spline 2-D window,
constant padding at the image minimum onto a square canvas that the patch
grid (step = window/subdivisions) tiles exactly, ``tta`` dihedral variants,
one model call on all patches, weighted overlap-add, division by
subdivisions**2, inverse transforms averaged. At the production geometry
(640-px canvas, patch 320) the model sees one batch of 5 x 5 x 8 = 200.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from scipy.signal.windows import triang


def spline_window(window_size: int, power: int = 2) -> np.ndarray:
    """Squared-spline 1-D window."""
    intersection = int(window_size / 4)
    wind_outer = (abs(2 * triang(window_size)) ** power) / 2
    wind_outer[intersection:-intersection] = 0
    wind_inner = 1 - (abs(2 * (triang(window_size) - 1)) ** power) / 2
    wind_inner[:intersection] = 0
    wind_inner[-intersection:] = 0
    wind = wind_inner + wind_outer
    return (wind / np.average(wind)).astype(np.float32)


def window_2d(window_size: int, power: int = 2) -> np.ndarray:
    """Outer-product 2-D window, shape (w, w, 1)."""
    wind = spline_window(window_size, power)
    return (wind[:, None] * wind[None, :])[..., None].astype(np.float32)


def _rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.rot90(x, k, dims=(0, 1))  # jnp.rot90's default axes


def _d4_do(img: torch.Tensor, tta: int = 8) -> torch.Tensor:
    """The first ``tta`` dihedral transforms of a square (H, W, C) image
    -> (tta, H, W, C)."""
    flip = torch.flip(img, dims=(1,))
    variants = [img, _rot90(img, 1), _rot90(img, 2), _rot90(img, 3),
                flip, _rot90(flip, 1), _rot90(flip, 2), _rot90(flip, 3)]
    return torch.stack(variants[:tta])


def _d4_undo_mean(stack: torch.Tensor, tta: int = 8) -> torch.Tensor:
    """Invert the first ``tta`` transforms and average."""
    undo = [
        lambda s: s,
        lambda s: _rot90(s, 3),
        lambda s: _rot90(s, 2),
        lambda s: _rot90(s, 1),
        lambda s: torch.flip(s, dims=(1,)),
        lambda s: torch.flip(_rot90(s, 3), dims=(1,)),
        lambda s: torch.flip(_rot90(s, 2), dims=(1,)),
        lambda s: torch.flip(_rot90(s, 1), dims=(1,)),
    ]
    return torch.stack([undo[k](stack[k]) for k in range(tta)]).mean(dim=0)


def _geometry(h: int, w: int, window_size: int, subdivisions: int):
    """(step, aug, side, n): patch step, pad width, canvas side, patches per side."""
    step = window_size // subdivisions
    aug = int(round(window_size * (1 - 1.0 / subdivisions)))
    n_steps = max(0, math.ceil((max(h, w) + 2 * aug - window_size) / step))
    return step, aug, window_size + n_steps * step, n_steps + 1


def tile_patches(img: torch.Tensor, window_size: int, subdivisions: int, tta: int = 8) -> torch.Tensor:
    """The model's input batch for one (H, W, C) image:
    (tta * n * n, window, window, C), variant-major then row-major."""
    h, w, c = img.shape
    step, aug, side, n = _geometry(h, w, window_size, subdivisions)
    canvas_in = img.min().expand(side, side, c).clone()
    canvas_in[aug : aug + h, aug : aug + w] = img
    aug_stack = _d4_do(canvas_in, tta)  # (tta, S, S, C)
    # (tta, n, n, C, win, win) -> (tta * n * n, win, win, C)
    patches = aug_stack.unfold(1, window_size, step).unfold(2, window_size, step)
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(tta * n * n, window_size, window_size, c)


def tiled_core(
    img: torch.Tensor,
    pred_func: Callable,
    window_size: int,
    subdivisions: int,
    out_channels: int,
    tta: int = 8,
) -> torch.Tensor:
    """Tiled prediction of one (H, W[, C]) float32 image."""
    h, w = img.shape[0], img.shape[1]
    if img.dim() == 2:
        img = img[..., None]
    step, aug, side, n = _geometry(h, w, window_size, subdivisions)
    batch = tile_patches(img, window_size, subdivisions, tta)

    preds = pred_func(batch).float()
    if preds.dim() == 3:
        preds = preds[..., None]
    spline = torch.tensor(window_2d(window_size), device=img.device)
    preds = (preds * spline[None]).reshape(tta, n, n, window_size, window_size, out_channels)

    canvas = torch.zeros((tta, side, side, out_channels), device=img.device)
    for i in range(n):
        for j in range(n):
            canvas[:, i * step : i * step + window_size, j * step : j * step + window_size] += preds[:, i, j]
    canvas = canvas / (subdivisions**2)

    merged = _d4_undo_mean(canvas, tta)
    out = merged[aug : aug + h, aug : aug + w]
    if out_channels == 1:
        out = out[..., 0]
    return out


def predict_img_with_smooth_windowing(
    input_img: torch.Tensor,
    window_size: int,
    subdivisions: int,
    pred_func: Callable,
    out_channels: int = 1,
    tta: int = 8,
) -> torch.Tensor:
    """Smoothly blended tiled prediction over a (H, W[, C]) image;
    ``tta`` is 8 (full D4), 4 (rotations) or 1 (none)."""
    if tta not in (1, 4, 8):
        raise ValueError(f"tta must be 1, 4 or 8, got {tta}")
    img = input_img.float()
    return tiled_core(img, pred_func, window_size, subdivisions, out_channels, tta)
