"""Iterative blur and distance-transform blur helpers.

Counterpart of ``tmat_tpu/ops/blur.py``: iterative 3x3 cv2 Gaussian blurs
(``blur``) applied to the Euclidean distance transform (``dt_blur``) or
the signed one (``sdt_blur``) of an image thresholded at 0.
"""

from __future__ import annotations

import numpy as np
import torch

from tmat_torch.ops.filters import cv2_gaussian_kernel, sepconv2d
from tmat_torch.ops.morphology import euclidean_distance_transform


def blur(img: torch.Tensor, blur_itr: int, k_size: int = 3, gs: bool = True) -> torch.Tensor:
    """``blur_itr`` passes of cv2.GaussianBlur(k_size, sigma=0), rounded;
    uint8 when ``gs``, else float32."""
    k = cv2_gaussian_kernel(k_size)
    out = torch.as_tensor(img).float()
    for _ in range(blur_itr):
        out = sepconv2d(out, k, k, mode="reflect")
    out = torch.round(out)
    return out.to(torch.uint8) if gs else out


def _foreground(img: np.ndarray) -> np.ndarray:
    """The pixels above 0, as uint8 {0, 255} (``bin_thresh`` at 255)."""
    return np.where(np.asarray(img, np.float32) > 0, 255, 0).astype(np.uint8)


def dt_blur(img: np.ndarray, blur_itr: int, k_size: int = 3) -> np.ndarray:
    """Distance transform of the foreground, then ``blur`` (uint8)."""
    dt = euclidean_distance_transform(_foreground(img))
    return blur(torch.from_numpy(dt), blur_itr, k_size).numpy()


def sdt_blur(img: np.ndarray, blur_itr: int, k_size: int = 3) -> np.ndarray:
    """Signed distance transform (inside minus outside), then ``blur``
    (float32)."""
    mask = _foreground(img)
    sdt = euclidean_distance_transform(mask) - euclidean_distance_transform(np.logical_not(mask))
    return blur(torch.from_numpy(sdt), blur_itr, k_size, gs=False).numpy()
