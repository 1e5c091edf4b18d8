"""Resampling over the trailing (H, W) axes, as ``jax.image.resize`` does it.

Counterpart of ``tmat_tpu/ops/resize.py::resize`` (``lanczos`` ->
lanczos3, ``linear``, ``nearest``; antialiased). ``F.interpolate`` uses
other weights, so the weight matrices are rebuilt in numpy from
``jax._src.image.scale.compute_weight_mat``: pixel centres aligned, the
kernel stretched by 1/scale when downsampling, each output's weights
normalised to sum 1, and outputs whose sample point lies outside the
input zeroed. They are applied as two matmuls; a dim whose size does not
change is left as it is. Integer inputs are rounded and clipped.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    radius = np.float32(3.0)
    y = radius * np.sin(np.float32(np.pi) * x) * np.sin(np.float32(np.pi) * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3, y / np.where(x != 0, np.float32(np.pi**2) * x**2, 1), 1)
    return np.where(x > radius, 0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


_KERNELS = {"lanczos": _lanczos3, "lanczos3": _lanczos3, "linear": _triangle,
            "bilinear": _triangle}


@lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 resampling weights (antialiased).
    Cached: callers copy it (``torch.tensor``) and never write to it."""
    kernel = _KERNELS[method]
    # float32 throughout, as jax computes them: float64 weights differ from
    # jax's by up to 2e-5 at 1024 -> 640
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float32)[None, :]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=1, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _F32_EPS, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= np.float32(in_size - 0.5))
    return np.where(inside[:, None], w, 0).astype(np.float32)


@lru_cache(maxsize=64)
def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """jax.image's nearest source index of each output (float32 arithmetic)."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
    return np.floor(offsets / np.float32(out_size)).astype(np.int64)


def resize(img: torch.Tensor, shape: Tuple[int, int], method: str = "linear") -> torch.Tensor:
    """Resize the trailing (H, W) axes of ``img`` to ``shape`` (rows, cols)."""
    h, w = img.shape[-2:]
    oh, ow = int(shape[0]), int(shape[1])
    dtype = img.dtype
    if method == "nearest":
        out = img
        if oh != h:
            idx = torch.tensor(nearest_index(h, oh), device=img.device)
            out = out.index_select(-2, idx)
        if ow != w:
            idx = torch.tensor(nearest_index(w, ow), device=img.device)
            out = out.index_select(-1, idx)
        return out
    if method not in _KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    out = img.float()
    if oh != h:
        wh = torch.tensor(weight_matrix(h, oh, method), device=img.device)
        out = wh @ out
    if ow != w:
        ww = torch.tensor(weight_matrix(w, ow, method), device=img.device)
        out = out @ ww.t()
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(dtype)


def target_shape_for_ratio(shape: Tuple[int, int], ratio: float) -> Tuple[int, int]:
    """round(shape * ratio), the reference's target-size rule."""
    return tuple(int(x) for x in np.round(np.multiply(shape[:2], ratio)).astype(int))
