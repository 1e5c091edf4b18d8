"""Foreground thresholds: a 2-component GMM, batched over images, and Otsu.

Counterpart of ``tmat_tpu/ops/threshold.py`` (``gmm2_fit``,
``exec_threshold``): a k-means init by 20 Lloyd steps, then weighted EM
that stops when the mean per-sample log-likelihood changes by less than
1e-3 or after 100 iterations (sklearn's rule), and the threshold
min(255, mu_fg + sd_coef * sigma_fg) of the higher-mean component.

The JAX package vmaps a ``while_loop``; here every image of the batch
steps together and a per-image "still running" mask freezes the finished
ones, which leaves each image's result what it would be alone. The loop
syncs with the host once per EM iteration for the whole batch, and counts
each sync as ``gmm_iters`` (``core/profiling.py::count``).
``exec_threshold`` is batched already, so ``exec_threshold_batch`` is its
other name. ``otsu_threshold`` is skimage's ``threshold_otsu`` over the
image's value range.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from tmat_torch.core.defs import MAX_UINT8
from tmat_torch.core.profiling import count

_REG_COVAR = 1e-6
_EM_TOL = 1e-3
_EM_MAX_ITER = 100


def _sum(a: torch.Tensor) -> torch.Tensor:
    return a.sum(dim=-1)


def gmm2_fit(
    pixels: torch.Tensor, weights: Optional[torch.Tensor] = None, n_iter: int = _EM_MAX_ITER
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit a 1-D 2-component GMM to each row of (B, N) ``pixels`` with
    per-pixel ``weights`` (0 = excluded). Returns (mu, sd, pi), each (B, 2)."""
    x = pixels.float()
    w = torch.ones_like(x) if weights is None else weights.float()
    w_sum = torch.clamp(_sum(w), min=1e-12)

    thresh = _sum(w * x) / w_sum
    for _ in range(20):
        below = w * (x <= thresh[:, None])
        above = w * (x > thresh[:, None])
        n0 = torch.clamp(_sum(below), min=1e-12)
        n1 = torch.clamp(_sum(above), min=1e-12)
        thresh = (_sum(below * x) / n0 + _sum(above * x) / n1) / 2
    below = w * (x <= thresh[:, None])
    above = w * (x > thresh[:, None])
    n0 = torch.clamp(_sum(below), min=1e-12)
    n1 = torch.clamp(_sum(above), min=1e-12)
    mu = torch.stack([_sum(below * x) / n0, _sum(above * x) / n1], dim=1)
    var = torch.stack([
        _sum(below * (x - mu[:, :1]) ** 2) / n0,
        _sum(above * (x - mu[:, 1:]) ** 2) / n1,
    ], dim=1)
    var = torch.clamp(var, min=_REG_COVAR)
    pi = torch.stack([n0, n1], dim=1) / (n0 + n1)[:, None]

    b = x.shape[0]
    ll_prev = torch.full((b,), -math.inf, device=x.device)
    ll_curr = torch.full((b,), math.inf, device=x.device)
    it = 0
    while it < n_iter:
        running = torch.abs(ll_curr - ll_prev) >= _EM_TOL
        count("gmm_iters")  # the host sync below
        if not bool(running.any()):
            break
        diff = x[:, None, :] - mu[:, :, None]  # (B, 2, N)
        log_prob = (
            -0.5 * diff**2 / var[:, :, None]
            - 0.5 * torch.log(2 * math.pi * var)[:, :, None]
            + torch.log(pi)[:, :, None]
        )
        log_norm = torch.logsumexp(log_prob, dim=1, keepdim=True)  # (B, 1, N)
        ll = _sum(w * log_norm[:, 0]) / w_sum
        resp = torch.exp(log_prob - log_norm) * w[:, None, :]
        nk = torch.clamp(_sum(resp), min=1e-12)
        mu_new = _sum(resp * x[:, None, :]) / nk
        var_new = _sum(resp * (x[:, None, :] - mu_new[:, :, None]) ** 2) / nk + _REG_COVAR
        pi_new = nk / nk.sum(dim=1, keepdim=True)
        r2 = running[:, None]
        mu = torch.where(r2, mu_new, mu)
        var = torch.where(r2, var_new, var)
        pi = torch.where(r2, pi_new, pi)
        ll_prev = torch.where(running, ll_curr, ll_prev)
        ll_curr = torch.where(running, ll, ll_curr)
        it += 1
    return mu, torch.sqrt(var), pi


def gmm_foreground_threshold(
    pixels: torch.Tensor, sd_coef: float, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B,) thresholds min(255, mu_fg + sd_coef * sigma_fg)."""
    mu, sd, _ = gmm2_fit(pixels, weights)
    fg = torch.argmax(mu, dim=1, keepdim=True)
    t = mu.gather(1, fg)[:, 0] + sd.gather(1, fg)[:, 0] * sd_coef
    return torch.clamp(t, max=float(MAX_UINT8))


def exec_threshold(
    masked: torch.Tensor, mask: Optional[torch.Tensor], sd_coef: float
) -> torch.Tensor:
    """Zero the background of each (H, W) image of a (B, H, W) batch by its
    GMM threshold; pixels where ``mask`` == 0 are left out of the fit."""
    flat = masked.reshape(masked.shape[0], -1)
    weights = None if mask is None else (mask > 0).reshape(flat.shape)
    thresh = gmm_foreground_threshold(flat, sd_coef, weights)
    return torch.where(masked <= thresh[:, None, None], torch.zeros_like(masked), masked)


exec_threshold_batch = exec_threshold


def otsu_threshold(img: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu's threshold of one image: the centre of the bin that maximises
    the inter-class variance; foreground is ``img >= thresh`` at the call
    site."""
    x = img.float().ravel()
    lo, hi = x.min(), x.max()
    span = torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp(((x - lo) / span * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.bincount(idx, minlength=nbins).float()
    centers = lo + (torch.arange(nbins, dtype=torch.float32, device=x.device) + 0.5) * span / nbins
    w0 = torch.cumsum(hist, 0)
    w1 = w0[-1] - w0
    sum0 = torch.cumsum(hist * centers, 0)
    mu0 = sum0 / torch.clamp(w0, min=1e-12)
    mu1 = (sum0[-1] - sum0) / torch.clamp(w1, min=1e-12)
    between = w0 * w1 * (mu0 - mu1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between, -1.0)
    return centers[torch.argmax(between)]
