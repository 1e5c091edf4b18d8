"""Zhang-Suen thinning (``tmat_tpu/ops/morphology.py::skeletonize``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def skeletonize(masks: torch.Tensor) -> torch.Tensor:
    """Zhang-Suen skeletons of a (B, H, W) batch of masks (bool).

    The batch iterates until no mask changes; a mask whose pass deleted
    nothing is a fixed point, so further passes leave it as it is and
    each result is the one its own loop would reach. One host sync per
    pass."""
    x = (masks > 0).to(torch.uint8)
    while True:
        x2 = _zhang_suen_subiter(_zhang_suen_subiter(x, True), False)
        changed = bool((x2 != x).any())
        x = x2
        if not changed:
            return x > 0
