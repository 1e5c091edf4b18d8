"""Separable convolution filters: OpenCV's Gaussian and Laplacian kernels
and skimage's Gaussian, over the trailing (H, W) axes.

Counterpart of ``tmat_tpu/ops/filters.py``: ``cv2_gaussian_kernel``,
``cv2_deriv_kernel``, ``gaussian_kernel_1d``, ``sepconv2d``,
``gaussian_blur_cv2``, ``laplacian_cv2``, ``gaussian``, the skimage Sobel
pair, ``unsharp_mask``, ``conv1d_axis``, the N-D ``gaussian_nd`` and
``unsharp_mask_nd`` (over every axis, Z included) and ``median3x3``.
Leading axes of the 2-D filters are batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV's fixed "small gaussian" kernels for ksize in {1,3,5,7} with sigma<=0
_CV2_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def cv2_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics (fixed kernels when sigma<=0, k<=7)."""
    if sigma <= 0 and ksize in _CV2_SMALL_GAUSSIAN:
        return _CV2_SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def cv2_deriv_kernel(order: int, ksize: int) -> np.ndarray:
    """OpenCV getDerivKernels: binomial smoothing convolved with differences."""
    k = np.array([1.0])
    for i in range(ksize - 1):
        if i < ksize - order - 1:
            k = np.convolve(k, [1.0, 1.0])
        else:
            k = np.convolve(k, [1.0, -1.0])
    return k.astype(np.float32)


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy/skimage-style Gaussian kernel (radius = int(truncate*sigma+0.5))."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def reflect_index(start: int, stop: int, n: int) -> np.ndarray:
    """Source index of positions ``start..stop-1`` on an axis of length ``n``
    under REFLECT_101, reflecting as often as needed (``np.pad``'s
    "reflect": period 2(n-1); an axis of length 1 repeats its pixel)."""
    i = np.arange(start, stop)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    return np.where(m < n, m, period - m)


def _symmetric_index(start: int, stop: int, n: int) -> np.ndarray:
    """As ``reflect_index`` for ``np.pad``'s "symmetric" (the edge pixel
    repeats: period 2n)."""
    m = np.mod(np.arange(start, stop), 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


def _pad_index(before: int, after: int, n: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis of length ``n`` padded by
    ``before`` and ``after`` under ``mode`` (not "constant")."""
    if mode in ("reflect", "mirror"):
        return reflect_index(-before, n + after, n)
    if mode == "symmetric":
        return _symmetric_index(-before, n + after, n)
    if mode == "nearest":
        return np.clip(np.arange(-before, n + after), 0, n - 1)
    raise ValueError(f"unknown border mode {mode!r}")


def pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int, mode: str) -> torch.Tensor:
    """``np.pad`` of the trailing (H, W) axes. ``mode``: "reflect" (cv2
    BORDER_REFLECT_101) or "mirror", "nearest" (edge), "symmetric" (cv2
    BORDER_REFLECT), "constant" (zeros)."""
    if mode == "constant":
        return F.pad(x, (left, right, top, bottom))
    h, w = x.shape[-2:]
    rows = torch.as_tensor(_pad_index(top, bottom, h, mode), device=x.device)
    cols = torch.as_tensor(_pad_index(left, right, w, mode), device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def sepconv2d(img: torch.Tensor, kernel_y: Sequence[float], kernel_x: Sequence[float],
              mode: str = "reflect") -> torch.Tensor:
    """Separable 2-D correlation over the trailing (H, W) axes: the border
    is padded by ``mode``, then two 1-D ``conv2d`` passes, rows first."""
    ky = torch.as_tensor(np.asarray(kernel_y), dtype=img.dtype, device=img.device)
    kx = torch.as_tensor(np.asarray(kernel_x), dtype=img.dtype, device=img.device)
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2:]
    ry, rx = (len(ky) - 1) // 2, (len(kx) - 1) // 2
    x = pad_hw(img.reshape(-1, 1, h, w), ry, len(ky) - 1 - ry, rx, len(kx) - 1 - rx, mode)
    x = F.conv2d(x, ky.reshape(1, 1, -1, 1))
    x = F.conv2d(x, kx.reshape(1, 1, 1, -1))
    return x.reshape(*batch_shape, h, w)


def gaussian_blur_cv2(img: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur with BORDER_REFLECT_101."""
    k = cv2_gaussian_kernel(ksize, sigma)
    return sepconv2d(img, k, k, mode="reflect")


def laplacian_cv2(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """cv2.Laplacian(ksize) = Sobel(2,0,k) + Sobel(0,2,k)."""
    deriv = cv2_deriv_kernel(2, ksize)
    smooth = cv2_deriv_kernel(0, ksize)
    dyy = sepconv2d(img, deriv, smooth, mode="reflect")
    dxx = sepconv2d(img, smooth, deriv, mode="reflect")
    return dyy + dxx


def gaussian(img: torch.Tensor, sigma: float, mode: str = "nearest", truncate: float = 4.0
             ) -> torch.Tensor:
    """skimage.filters.gaussian (preserve_range semantics, no rescale)."""
    if sigma <= 0:
        return img
    k = gaussian_kernel_1d(sigma, truncate)
    return sepconv2d(img, k, k, mode=mode)


# skimage Sobel kernels (smoothing [1,2,1]/4, derivative [1,0,-1]/2)
_SOBEL_SMOOTH = np.array([0.25, 0.5, 0.25], np.float32)
_SOBEL_DERIV = np.array([0.5, 0.0, -0.5], np.float32)


def sobel_h(img: torch.Tensor) -> torch.Tensor:
    """Horizontal-edge Sobel (derivative along rows), skimage convention."""
    return sepconv2d(img, _SOBEL_DERIV, _SOBEL_SMOOTH, mode="reflect")


def sobel_v(img: torch.Tensor) -> torch.Tensor:
    """Vertical-edge Sobel (derivative along columns), skimage convention."""
    return sepconv2d(img, _SOBEL_SMOOTH, _SOBEL_DERIV, mode="reflect")


def unsharp_mask(img: torch.Tensor, radius: float = 1.0, amount: float = 1.0) -> torch.Tensor:
    """skimage.filters.unsharp_mask of a [0, 1] float image over (H, W):
    img + amount * (img - gaussian(img, radius)), clipped to [0, 1]."""
    blurred = gaussian(img, radius, mode="nearest")
    return torch.clamp(img + amount * (img - blurred), 0.0, 1.0)


def conv1d_axis(img: torch.Tensor, kernel: Sequence[float], axis: int, mode: str = "nearest"
                ) -> torch.Tensor:
    """1-D correlation along ``axis``, the border padded by ``mode``."""
    k = torch.as_tensor(np.asarray(kernel), dtype=img.dtype, device=img.device)
    x = img.movedim(axis, -1)
    shape = x.shape
    r = (len(k) - 1) // 2
    flat = x.reshape(-1, 1, shape[-1])
    if mode == "constant":
        flat = F.pad(flat, (r, len(k) - 1 - r))
    else:
        idx = torch.as_tensor(_pad_index(r, len(k) - 1 - r, shape[-1], mode), device=img.device)
        flat = flat.index_select(-1, idx)
    out = F.conv1d(flat, k.reshape(1, 1, -1))
    return out.reshape(shape).movedim(-1, axis)


def gaussian_nd(img: torch.Tensor, sigma: float, mode: str = "nearest", truncate: float = 4.0
                ) -> torch.Tensor:
    """N-D Gaussian blur over all axes (skimage.filters.gaussian of an N-D
    array: a (Z, H, W) stack is blurred along Z too)."""
    if sigma <= 0:
        return img
    k = gaussian_kernel_1d(sigma, truncate)
    out = img
    for axis in range(img.dim()):
        out = conv1d_axis(out, k, axis, mode)
    return out


def unsharp_mask_nd(img: torch.Tensor, radius: float, amount: float) -> torch.Tensor:
    """skimage.filters.unsharp_mask over all axes of a [0, 1] float array."""
    blurred = gaussian_nd(img, radius, mode="nearest")
    return torch.clamp(img + amount * (img - blurred), 0.0, 1.0)


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median over the trailing (H, W) axes, edge padding."""
    h, w = img.shape[-2:]
    padded = pad_hw(img, 1, 1, 1, 1, "nearest")
    taps = [padded[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    return torch.stack(taps).median(dim=0).values
