"""Multi-scale Sato tubeness (vesselness) over the trailing (H, W) axes.

Counterpart of ``tmat_tpu/ops/sato.py``: for each scale the response is
sigma^2 * max(-lambda_min, 0), lambda_min the smaller eigenvalue of the
Gaussian Hessian (exact sampled Hermite-polynomial kernels, scipy's
``_gaussian_kernel1d``; 'symmetric' border, scipy's 'reflect'), and the
output is the maximum over the scales. A (Z, H, W) stack is one batch:
each scale is three separable convolutions of the whole stack, up to 121
taps wide at sigma 15. Plain PyTorch: the JAX function is XLA, with no
Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tmat_torch.ops.filters import sepconv2d

DEFAULT_SIGMAS = (1, 2, 3, 4, 5, 7, 9, 11, 13, 15)


def gaussian_deriv_kernel(sigma: float, order: int, truncate: float = 4.0) -> np.ndarray:
    """Sampled Gaussian-derivative kernel (scipy ``_gaussian_kernel1d``)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    if order == 0:
        return g.astype(np.float32)
    # exponent-weighted polynomial q(x) with the q' recursion
    exponent_range = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    d = np.diag(exponent_range[1:], 1)  # d/dx
    p = np.diag(np.ones(order) / -(sigma**2), -1)  # * -x/sigma^2
    q_deriv = d + p
    for _ in range(order):
        q = q_deriv.dot(q)
    q_of_x = (x[:, None] ** exponent_range).dot(q)
    return (q_of_x * g).astype(np.float32)


def _hessian_eig_min(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smaller eigenvalue of the Gaussian Hessian at scale ``sigma``."""
    g0 = gaussian_deriv_kernel(sigma, 0)
    g1 = gaussian_deriv_kernel(sigma, 1)
    g2 = gaussian_deriv_kernel(sigma, 2)
    # correlation with the flipped derivative kernels is scipy's convolve1d
    hrr = sepconv2d(img, g2[::-1].copy(), g0, mode="symmetric")
    hcc = sepconv2d(img, g0, g2[::-1].copy(), mode="symmetric")
    hrc = sepconv2d(img, g1[::-1].copy(), g1[::-1].copy(), mode="symmetric")
    half_trace = (hrr + hcc) / 2
    disc = torch.sqrt(((hrr - hcc) / 2) ** 2 + hrc**2)
    return half_trace - disc


def sato(img: torch.Tensor, sigmas: Tuple[float, ...] = DEFAULT_SIGMAS,
         black_ridges: bool = False) -> torch.Tensor:
    """Multi-scale tubeness of (..., H, W) images (max over scales), float32."""
    work = img.float()
    if black_ridges:
        work = -work
    out = torch.zeros_like(work)
    for sigma in sigmas:
        lam_min = _hessian_eig_min(work, float(sigma))
        response = (sigma**2) * torch.clamp(-lam_min, min=0.0)
        out = torch.maximum(out, response)
    return out
