"""Exact Euclidean distance transform (``tmat_tpu/ops/distance.py``).

Column pass: each pixel's distance to the last background row above and
the next one below, from running maxima/minima of row indices, no loop
over rows. Row pass: out[r, c] = min over c' of G[r, c']^2 + (c - c')^2,
in row chunks so the (chunk, W, W) buffer stays bounded. Both passes are
exact in float32, and a column without background carries 1e9, as in
the JAX package, so the squared results agree bit for bit.
"""

from __future__ import annotations

import torch

_BIG = 1e9


def _column_pass(bg: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool background -> per-column distance to it (float32)."""
    h = bg.shape[-2]
    rows = torch.arange(h, device=bg.device, dtype=torch.int64)[None, :, None]
    above = torch.where(bg, rows, torch.full_like(rows, -1)).cummax(dim=-2).values
    below = torch.where(bg, rows, torch.full_like(rows, h)).flip(-2).cummin(dim=-2).values.flip(-2)
    d_above = torch.where(above >= 0, (rows - above).float(), _BIG)
    d_below = torch.where(below < h, (below - rows).float(), _BIG)
    return torch.minimum(d_above, d_below)


def edt_batch(masks: torch.Tensor, row_chunk: int = 32) -> torch.Tensor:
    """Exact EDT of the foreground of each (H, W) mask of a (B, H, W) batch."""
    masks = masks > 0
    w = masks.shape[-1]
    g = _column_pass(~masks)
    g2 = torch.clamp(g * g, max=_BIG)
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)
    dcol2 = (cols[:, None] - cols[None, :]) ** 2  # (W, W')
    out = torch.empty_like(g2)
    for r0 in range(0, g2.shape[-2], row_chunk):
        block = g2[:, r0 : r0 + row_chunk]  # (B, chunk, W')
        out[:, r0 : r0 + row_chunk] = (block[:, :, None, :] + dcol2).amin(dim=-1)
    return torch.sqrt(out)


def edt(mask: torch.Tensor, row_chunk: int = 32) -> torch.Tensor:
    """Exact EDT of the foreground of one 2-D mask."""
    return edt_batch(mask[None], row_chunk)[0]
