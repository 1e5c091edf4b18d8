"""Canny edge detection (skimage.feature.canny semantics).

Counterpart of ``tmat_tpu/ops/canny.py``: Gaussian smooth -> Sobel
gradients -> interpolated non-maximum suppression -> double threshold ->
hysteresis. The hysteresis grows the strong edges through the weak ones by
masked dilations until nothing changes, with one host sync per round; the
well mask's rasters are at most 200 pixels wide, so the rounds are few.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch.ops.filters import gaussian, sepconv2d

_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL_DERIV = np.array([1.0, 0.0, -1.0], np.float32)


def _shift(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Shift with zero fill: out[r, c] = x[r + dr, c + dc]."""
    h, w = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    return p[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]


def canny(image: torch.Tensor, sigma: float = 1.0, low_threshold: float = 0.1,
          high_threshold: float = 0.2) -> torch.Tensor:
    """Boolean edge map of a 2-D image."""
    img = image.float()
    smoothed = gaussian(img, sigma, mode="constant") if sigma > 0 else img

    # scipy.ndimage.sobel kernels (reflect border), as in skimage.canny
    gr = sepconv2d(smoothed, _SOBEL_DERIV, _SOBEL_SMOOTH, mode="reflect")  # d/drow
    gc = sepconv2d(smoothed, _SOBEL_SMOOTH, _SOBEL_DERIV, mode="reflect")  # d/dcol
    mag = torch.hypot(gr, gc)

    # Interpolated non-maximum suppression: compare against the magnitudes
    # interpolated at +/- the unit gradient, in the two regimes
    # |gc| >= |gr| and the converse.
    abs_r, abs_c = gr.abs(), gc.abs()
    eps = 1e-12
    w_c = torch.where(abs_c >= abs_r, abs_r / (abs_c + eps), abs_c / (abs_r + eps))
    sr = torch.where(gr >= 0, 1, -1)
    sc = torch.where(gc >= 0, 1, -1)

    def interp_signed(direction: int) -> torch.Tensor:
        result = torch.zeros_like(mag)
        for srv in (1, -1):
            for scv in (1, -1):
                n_c = _shift(mag, 0, direction * scv)
                n_r = _shift(mag, direction * srv, 0)
                n_d = _shift(mag, direction * srv, direction * scv)
                horiz = n_c * (1 - w_c) + n_d * w_c
                vert = n_r * (1 - w_c) + n_d * w_c
                val = torch.where(abs_c >= abs_r, horiz, vert)
                result = torch.where((sr == srv) & (sc == scv), val, result)
        return result

    is_max = (mag >= interp_signed(1)) & (mag >= interp_signed(-1)) & (mag > 0)

    # exclude the 1-px border (skimage erodes the mask)
    h, w = img.shape
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[1 : h - 1, 1 : w - 1] = True
    local_max = is_max & interior

    edges = local_max & (mag > high_threshold)
    weak = local_max & (mag > low_threshold)
    while True:
        grown = F.max_pool2d(edges[None, None].float(), 3, stride=1, padding=1)[0, 0] > 0
        new_edges = weak & grown
        if not bool((new_edges != edges).any()):
            return new_edges
        edges = new_edges
