"""Resampling over the trailing (H, W) axes, as ``jax.image.resize`` does it.

Counterpart of ``tmat_tpu/ops/resize.py::resize`` (``lanczos`` ->
lanczos3, ``lanczos4`` -> jax's lanczos5 kernel, ``cubic`` -> Keys cubic,
``linear``, ``nearest``). ``F.interpolate`` uses other weights, so the
weight matrices are rebuilt in numpy from
``jax._src.image.scale.compute_weight_mat``: pixel centres aligned, the
kernel stretched by 1/scale when downsampling (``antialias``, the
default), each output's weights
normalised to sum 1, and outputs whose sample point lies outside the
input zeroed. They are applied as two matmuls; a dim whose size does not
change is left as it is. Integer inputs are rounded and clipped.

``resize_lanczos4_host`` is the other Lanczos-4: the true a=4 kernel of
cv2's INTER_LANCZOS4, applied in numpy on the host as two GEMMs
(``tmat_tpu/ops/resize.py::resize_lanczos4_host``); the inv_depth tool's
ingest uses it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)


def _lanczos(radius: float):
    """jax.image's Lanczos kernel of ``radius`` (3 or 5), in float32."""
    radius = np.float32(radius)

    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.float32(np.pi) * x) * np.sin(np.float32(np.pi) * x / radius)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(x > 1e-3, y / np.where(x != 0, np.float32(np.pi**2) * x**2, 1), 1)
        return np.where(x > radius, 0, out).astype(np.float32)

    return kernel


_lanczos3 = _lanczos(3.0)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax.image's Keys cubic kernel (a = -0.5), in float32."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, 0, out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


# "lanczos4" is jax's lanczos5 kernel, as in the JAX package (not cv2's a=4)
_KERNELS = {"lanczos": _lanczos3, "lanczos3": _lanczos3, "lanczos4": _lanczos(5.0),
            "cubic": _keys_cubic, "linear": _triangle, "bilinear": _triangle}


@lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) float32 resampling weights; without
    ``antialias`` the kernel is not stretched when downsampling. Cached:
    callers copy it (``torch.tensor``) and never write to it."""
    kernel = _KERNELS[method]
    # float32 throughout, as jax computes them: float64 weights differ from
    # jax's by up to 2e-5 at 1024 -> 640
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
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


def resize(img: torch.Tensor, shape: Tuple[int, int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """Resize the trailing (H, W) axes of ``img`` to ``shape`` (rows, cols);
    ``antialias`` low-pass filters when downsampling (``nearest`` ignores it)."""
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
        wh = torch.tensor(weight_matrix(h, oh, method, antialias), device=img.device)
        out = wh @ out
    if ow != w:
        ww = torch.tensor(weight_matrix(w, ow, method, antialias), device=img.device)
        out = out @ ww.t()
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        out = torch.clamp(torch.round(out), info.min, info.max)
    return out.to(dtype)


def lanczos4_weight_matrix(in_size: int, out_size: int, a: int = 4) -> np.ndarray:
    """(out_size, in_size) float32 weights of the antialiased Lanczos-a
    kernel (a=4: cv2's INTER_LANCZOS4): pixel centres aligned, the kernel
    stretched by 1/scale when downsampling, each row normalised to 1; in
    float64 until the last cast, as the JAX package builds them."""
    scale = out_size / in_size
    stretch = max(1.0 / scale, 1.0)
    coord = (np.arange(out_size) + 0.5) / scale - 0.5
    x = (np.arange(in_size)[None, :] - coord[:, None]) / stretch
    with np.errstate(invalid="ignore"):
        w = np.where(np.abs(x) < a, np.sinc(x) * np.sinc(x / a), 0.0)
    w /= np.sum(w, axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_lanczos4_host(stack, shape: Tuple[int, int]) -> np.ndarray:
    """Lanczos-4 resize of the trailing (H, W) axes of ``stack`` on the
    host, as float32: two GEMMs, each with the batch folded into its free
    dimension (the order of the JAX package's, so the results are equal)."""
    stack = np.asarray(stack, np.float32)
    lead = stack.shape[:-2]
    H, W = stack.shape[-2:]
    h, w = shape
    wh = lanczos4_weight_matrix(H, h)
    ww = lanczos4_weight_matrix(W, w)
    flat = stack.reshape(-1, H, W)
    t1 = (wh @ flat.transpose(1, 0, 2).reshape(H, -1)).reshape(h, -1, W)
    t2 = np.ascontiguousarray(t1.transpose(1, 0, 2)).reshape(-1, W) @ ww.T
    return t2.reshape(*lead, h, w)


def target_shape_for_ratio(shape: Tuple[int, int], ratio: float) -> Tuple[int, int]:
    """round(shape * ratio), the reference's target-size rule."""
    return tuple(int(x) for x in np.round(np.multiply(shape[:2], ratio)).astype(int))


def downsample_max_dim_shape(shape: Tuple[int, int], max_dim: int) -> Tuple[int, int]:
    """Target shape so that max(shape) == max_dim."""
    ratio = max_dim / max(shape[:2])
    return tuple(int(x) for x in np.round(np.multiply(shape[:2], ratio)).astype(int))
