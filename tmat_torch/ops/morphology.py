"""Binary morphology (``tmat_tpu/ops/morphology.py``): footprint erosion,
dilation, closing and opening over the trailing (H, W) axes, Zhang-Suen
thinning, the medial axis with its distance, the exact EDT and the
filled-circle mask. Outside the image erosion sees True and dilation
False, as skimage does."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch.core.profiling import count


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: x^2 + y^2 <= r^2."""
    y, x = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return (x**2 + y**2 <= radius**2).astype(np.float32)


def square(width: int) -> np.ndarray:
    """skimage.morphology.square."""
    return np.ones((width, width), np.float32)


def _conv_binary(x: torch.Tensor, footprint: np.ndarray, pad_value: float) -> torch.Tensor:
    """Count of footprint pixels set under each pixel (exact in float32:
    the terms are 0 or 1)."""
    fp = torch.as_tensor(np.asarray(footprint, np.float32), device=x.device)
    kh, kw = fp.shape
    h, w = x.shape[-2:]
    img = x.reshape(-1, 1, h, w).float()
    img = F.pad(img, ((kw - 1) // 2, kw - 1 - (kw - 1) // 2, (kh - 1) // 2, kh - 1 - (kh - 1) // 2),
                value=pad_value)
    return F.conv2d(img, fp.reshape(1, 1, kh, kw)).reshape(*x.shape[:-2], h, w)


def binary_erosion(x: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """skimage binary_erosion (out-of-image treated as True)."""
    return _conv_binary(x > 0, footprint, 1.0) >= float(footprint.sum()) - 0.5


def binary_dilation(x: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """skimage binary_dilation (footprint mirrored; all ours are symmetric)."""
    return _conv_binary(x > 0, footprint, 0.0) > 0.5


def binary_closing(x: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Dilation then erosion."""
    return binary_erosion(binary_dilation(x, footprint), footprint)


def binary_opening(x: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Erosion then dilation."""
    return binary_dilation(binary_erosion(x, footprint), footprint)


dilation = binary_dilation  # the reference's grey-level call sites take binary masks
closing = binary_closing


def _zhang_suen_subiter(x: torch.Tensor, first: bool) -> torch.Tensor:
    """One sub-iteration on a (B, H, W) uint8 {0, 1} batch."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    n = p[:, 0:h, 1 : w + 1]
    ne = p[:, 0:h, 2 : w + 2]
    e = p[:, 1 : h + 1, 2 : w + 2]
    se = p[:, 2 : h + 2, 2 : w + 2]
    s = p[:, 2 : h + 2, 1 : w + 1]
    sw = p[:, 2 : h + 2, 0:w]
    wn = p[:, 1 : h + 1, 0:w]
    nw = p[:, 0:h, 0:w]
    ring = [n, ne, e, se, s, sw, wn, nw]
    b = sum(ring)  # nonzero neighbours
    a = sum((ring[i] == 0) & (ring[(i + 1) % 8] == 1) for i in range(8)).to(torch.uint8)
    if first:
        cond3 = (n * e * s) == 0
        cond4 = (e * s * wn) == 0
    else:
        cond3 = (n * e * wn) == 0
        cond4 = (n * s * wn) == 0
    delete = (x == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond3 & cond4
    return torch.where(delete, torch.zeros_like(x), x)


def skeletonize(mask: torch.Tensor) -> torch.Tensor:
    """Zhang-Suen skeleton (bool) of an (H, W) mask, or of each mask of a
    (B, H, W) batch.

    The batch iterates until no mask changes; a mask whose pass deleted
    nothing is a fixed point, so further passes leave it as it is and
    each result is the one its own loop would reach. One host sync per
    pass, counted as ``skeleton_passes`` (``core/profiling.py::count``)."""
    x = (mask > 0).to(torch.uint8)
    if mask.dim() == 2:
        return skeletonize(x[None])[0]
    while True:
        x2 = _zhang_suen_subiter(_zhang_suen_subiter(x, True), False)
        count("skeleton_passes")
        changed = bool((x2 != x).any())
        x = x2
        if not changed:
            return x > 0


def medial_axis(mask: torch.Tensor, return_distance: bool = False):
    """Centreline skeleton of a (..., H, W) mask: Zhang-Suen thinning, and
    with ``return_distance`` the exact EDT of the mask (``ops/distance.py``)."""
    from tmat_torch.ops.distance import edt_batch

    h, w = mask.shape[-2:]
    flat = mask.reshape(-1, h, w)
    skel = skeletonize(flat).reshape(mask.shape)
    if not return_distance:
        return skel
    return skel, edt_batch(flat).reshape(mask.shape)


def euclidean_distance_transform(mask: np.ndarray) -> np.ndarray:
    """Exact EDT of the foreground of a 2-D mask, float32 (numpy in and
    out; scipy's ``distance_transform_edt`` in the JAX package)."""
    from tmat_torch.ops.distance import edt_batch

    m = torch.from_numpy(np.ascontiguousarray(np.asarray(mask) > 0))
    return edt_batch(m[None])[0].numpy()


def gen_circ_mask(center: Tuple[int, int], radius: float, shape: Tuple[int, int],
                  mask_val: int = 1) -> np.ndarray:
    """Filled-circle uint8 mask; ``center`` is (col, row) as in cv2.circle."""
    rows, cols = np.mgrid[0 : shape[0], 0 : shape[1]]
    cx, cy = center
    inside = (cols - cx) ** 2 + (rows - cy) ** 2 <= radius**2
    return (inside * mask_val).astype(np.uint8)
