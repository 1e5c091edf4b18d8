"""Z projections (``tmat_tpu/ops/zproj.py``): max, min, avg and med.

``proj_host`` reduces an unpadded (Z, H, W) stack in numpy as each well is
decoded; ``proj_masked`` reduces a Z-padded stack on the device, masking
slices at or beyond ``z_count``. The two agree bit for bit on
integer-valued data. Focus stacking (``fs``) is not ported yet (ROADMAP.md,
Queue 1 item 11, with the focus kernel of Queue 2).
"""

from __future__ import annotations

import numpy as np
import torch

METHODS = ("max", "min", "avg", "med")


def proj_masked(stack: torch.Tensor, z_count: int, method: str) -> torch.Tensor:
    """float32 projection over the first ``z_count`` slices of a (Z, H, W)
    stack: max/min see -/+inf in the padding, avg divides by the true
    count, med is the mean of the two middle order statistics of the
    valid prefix (np.median)."""
    x = stack.float()
    valid = (torch.arange(x.shape[0], device=x.device) < z_count)[:, None, None]
    if method == "max":
        return torch.where(valid, x, float("-inf")).amax(dim=0)
    if method == "min":
        return torch.where(valid, x, float("inf")).amin(dim=0)
    if method == "avg":
        return torch.where(valid, x, 0.0).sum(dim=0) / z_count
    if method == "med":
        s = torch.sort(torch.where(valid, x, float("inf")), dim=0).values
        return (s[(z_count - 1) // 2] + s[z_count // 2]) / 2.0
    raise ValueError(f"Unknown projection method: {method}")


def proj_host(stack, method: str) -> np.ndarray:
    """Host projection of an unpadded (Z, H, W) stack. max/min keep the
    input dtype (exact); avg/med are float32."""
    x = np.asarray(stack)
    if method == "max":
        return x.max(axis=0)
    if method == "min":
        return x.min(axis=0)
    x = x.astype(np.float32, copy=False)
    if method == "avg":
        return x.sum(axis=0, dtype=np.float32) / np.float32(x.shape[0])
    if method == "med":
        s = np.sort(x, axis=0)
        z = x.shape[0]
        return (s[(z - 1) // 2] + s[z // 2]) / np.float32(2.0)
    raise ValueError(f"proj_host does not support method: {method}")
