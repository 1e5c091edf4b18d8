"""Z projections (``tmat_tpu/ops/zproj.py``): max, min, avg, med and focus
stacking.

``proj_avg/med/max/min`` and ``proj_focus_stacking`` (``PROJ_METHODS``)
reduce a whole stack, as the zproj tool does (``proj_focus_stacking_batch``
a (B, Z, H, W) plate of them). ``proj_host`` reduces an
unpadded (Z, H, W) stack in numpy as each well is decoded;
``proj_masked`` and ``proj_masked_batch`` reduce Z-padded stacks on the
device, masking slices at or beyond ``z_count``. Host and masked
projections agree bit for bit on integer-valued data.

Focus stacking with the default ``kernel_size`` 5 is
``ops/focus_stack.py``: the CUDA kernel for a CUDA tensor, its plain
version on the CPU. Other kernel sizes go through the ``conv2d``
composition of ``ops/filters.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tmat_torch.ops.filters import gaussian_blur_cv2, laplacian_cv2
from tmat_torch.ops.focus_stack import DTYPES as _FOCUS_DTYPES, focus_stack


def proj_avg(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Mean over ``axis`` in float32: the sum times the float32 reciprocal
    of the count, as XLA lowers ``jnp.mean``."""
    return stack.float().sum(dim=axis) * (1.0 / stack.shape[axis])


def proj_med(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Median over ``axis``: the mean of the two middle order statistics
    (float32), as ``jnp.median``."""
    s = torch.sort(stack.float(), dim=axis).values
    z = s.shape[axis]
    return (s.select(axis, (z - 1) // 2) + s.select(axis, z // 2)) / 2.0


def _as_sortable(stack: torch.Tensor) -> torch.Tensor:
    # uint16 tensors convert but do not reduce: widen, reduce, narrow back
    return stack.to(torch.int32) if stack.dtype == torch.uint16 else stack


def proj_max(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return _as_sortable(stack).amax(dim=axis).to(stack.dtype)


def proj_min(stack: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return _as_sortable(stack).amin(dim=axis).to(stack.dtype)


def focus_stack_conv(stacks: torch.Tensor, z_counts: Optional[Sequence[int]], kernel_size: int = 5
                     ) -> torch.Tensor:
    """Focus stacking of a (B, Z, H, W) batch through the ``conv2d``
    filters, for any odd ``kernel_size``; float32 scores, the source pixel
    of the first slice of the largest score, in the stacks' dtype."""
    x = stacks.float()
    scores = torch.abs(laplacian_cv2(gaussian_blur_cv2(x, kernel_size), kernel_size))
    if z_counts is None:
        z_counts = [x.shape[1]] * x.shape[0]
    zc = torch.as_tensor(np.asarray(z_counts, np.int64), device=x.device)
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < zc[:, None]
    scores = torch.where(valid[:, :, None, None], scores, float("-inf"))
    best_z = torch.argmax(scores, dim=1, keepdim=True)
    return torch.gather(x, 1, best_z)[:, 0].to(stacks.dtype)


def _fs_batch(stacks: torch.Tensor, z_counts: Optional[Sequence[int]], kernel_size: int
              ) -> torch.Tensor:
    if stacks.dtype not in _FOCUS_DTYPES:
        # the kernel takes uint8, uint16 and float32: other types go through
        # float32 and come back (exact below 2**24)
        return _fs_batch(stacks.float(), z_counts, kernel_size).to(stacks.dtype)
    if kernel_size == 5:
        return focus_stack(stacks.contiguous(), z_counts)
    return focus_stack_conv(stacks, z_counts, kernel_size)


def proj_focus_stacking(stack: torch.Tensor, axis: int = 0, kernel_size: int = 5) -> torch.Tensor:
    """Focus-stacking projection of a 3-D stack along ``axis``: per pixel
    the value of the slice whose |Laplacian(GaussianBlur(slice))| is
    largest (the first such slice). Keeps the stack's dtype."""
    if stack.dim() != 3:
        raise ValueError(f"focus stacking needs a 3-D stack, got {tuple(stack.shape)}")
    if axis != 0:
        stack = stack.movedim(axis, 0)
    return _fs_batch(stack[None], None, kernel_size)[0]  # None: the full depth


def proj_focus_stacking_batch(stacks: torch.Tensor) -> torch.Tensor:
    """``proj_focus_stacking`` of each stack of a (B, Z, H, W) plate at full
    depth, in the stacks' dtype: one launch of the focus-stacking kernel on
    a CUDA tensor, its plain version on the CPU."""
    if stacks.dim() != 4:
        raise ValueError(f"a plate of stacks is (B, Z, H, W), got {tuple(stacks.shape)}")
    return _fs_batch(stacks, None, 5)


PROJ_METHODS = {
    "min": proj_min,
    "max": proj_max,
    "med": proj_med,
    "avg": proj_avg,
    "fs": proj_focus_stacking,
}


def proj_masked_batch(stacks: torch.Tensor, z_counts: Optional[Sequence[int]], method: str,
                      kernel_size: int = 5) -> torch.Tensor:
    """float32 projections of a Z-padded (B, Z, H, W) batch over each
    stack's first ``z_counts[b]`` slices: max/min see -/+inf in the
    padding, avg divides by the true count, med is the mean of the two
    middle order statistics of the valid prefix (np.median), fs leaves
    padded slices out of the sharpness argmax (one kernel launch for the
    whole batch on a CUDA device). ``None`` is the full depth of every
    stack; a batch at full depth hands ``fs`` no depths, so none is
    uploaded."""
    b, z = stacks.shape[:2]
    if z_counts is None:
        z_counts = [z] * b
    if method == "fs":
        full = len(z_counts) == b and all(int(c) == z for c in z_counts)
        return _fs_batch(stacks, None if full else z_counts, kernel_size).float()
    x = stacks.float()
    zc = torch.as_tensor(np.asarray(z_counts, np.int64), device=x.device)
    valid = (torch.arange(x.shape[1], device=x.device)[None, :] < zc[:, None])[:, :, None, None]
    if method == "max":
        return torch.where(valid, x, float("-inf")).amax(dim=1)
    if method == "min":
        return torch.where(valid, x, float("inf")).amin(dim=1)
    if method == "avg":
        return torch.where(valid, x, 0.0).sum(dim=1) / zc[:, None, None]
    if method == "med":
        s = torch.sort(torch.where(valid, x, float("inf")), dim=1).values
        lo = ((zc - 1) // 2)[:, None, None, None].expand(-1, 1, *x.shape[2:])
        hi = (zc // 2)[:, None, None, None].expand(-1, 1, *x.shape[2:])
        return (torch.gather(s, 1, lo)[:, 0] + torch.gather(s, 1, hi)[:, 0]) / 2.0
    raise ValueError(f"Unknown projection method: {method}")


def proj_masked(stack: torch.Tensor, z_count: int, method: str, kernel_size: int = 5
                ) -> torch.Tensor:
    """``proj_masked_batch`` of one (Z, H, W) stack."""
    return proj_masked_batch(stack[None], [int(z_count)], method, kernel_size)[0]


def proj_host(stack, method: str) -> np.ndarray:
    """Host projection of an unpadded (Z, H, W) stack. max/min keep the
    input dtype (exact); avg/med are float32. ``fs`` needs the device."""
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
