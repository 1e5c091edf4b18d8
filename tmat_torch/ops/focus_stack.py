"""Focus-stacking Z projection: CUDA kernel wrapper and plain version.

Counterpart of ``tmat_tpu/ops/pallas_zproj.py::proj_focus_stacking_pallas``
(the Pallas TPU kernel ``_focus_kernel``). Per pixel, over the first
``z_count`` slices of each (Z, H, W) stack of a (B, Z, H, W) batch:

    blur (1,4,6,4,1)/16 along rows then columns -> ksize-5 Laplacian
    (deriv (1,0,-2,0,1) x smooth (1,4,6,4,1) along each axis, summed) ->
    score = abs -> the source pixel of the first slice of the largest score

with a 4-pixel REFLECT_101 border that keeps reflecting on images smaller
than the support. The result has the stacks' dtype (uint8, uint16 or
float32); the arithmetic is float32.

The kernel (``csrc/focus_stack.cu``) is built with ``nvcc`` into the
build cache (``build.py``) at first use and called through ctypes on PyTorch's
current stream. A CUDA tensor always goes to the kernel (a failed build or
launch raises); a CPU tensor goes to ``focus_stack_plain``, which sums the
same taps in the same order: the kernel is compiled without FMA contraction,
so the two agree bit for bit, near-ties included. Scores that are NaN never
win; results are defined for finite inputs only.

``launches`` counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from tmat_torch import build
from tmat_torch.ops.filters import reflect_index

HALO = 4  # support of the 5-tap blur plus the 5-tap derivative
_BLUR = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
_DERIV = (1.0, 0.0, -2.0, 0.0, 1.0)
_SMOOTH = (1.0, 4.0, 6.0, 4.0, 1.0)
_DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
DTYPES = tuple(_DTYPE_CODES)

launches = 0
_launches_lock = threading.Lock()  # the plate issues device work from pool threads


def library_path():
    """Build ``csrc/focus_stack.cu`` if needed. No FMA contraction, so the
    kernel rounds every intermediate as the plain version does."""
    return build.cuda_library("focus_stack", flags=("-fmad=false",))


def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tmat_focus_stack.restype = i
    lib.tmat_focus_stack.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    return lib


_lib = build.LazyLibrary(_load_library)


def _conv5_rows(x: torch.Tensor, taps) -> torch.Tensor:
    """5-tap correlation along H, taps summed left to right, zero taps
    skipped; (..., m, n) -> (..., m - 4, n)."""
    m = x.shape[-2] - 4
    out = taps[0] * x[..., 0:m, :]
    for u in range(1, 5):
        if taps[u] != 0.0:
            out = out + taps[u] * x[..., u : u + m, :]
    return out


def _conv5_cols(x: torch.Tensor, taps) -> torch.Tensor:
    n = x.shape[-1] - 4
    out = taps[0] * x[..., 0:n]
    for u in range(1, 5):
        if taps[u] != 0.0:
            out = out + taps[u] * x[..., u : u + n]
    return out


def focus_scores(stacks: torch.Tensor) -> torch.Tensor:
    """float32 sharpness |Laplacian(blur(slice))| of every slice of
    (..., H, W) ``stacks``, with the kernel's taps, order and border."""
    x = stacks.float()
    h, w = x.shape[-2:]
    rows = torch.as_tensor(reflect_index(-HALO, h + HALO, h), device=x.device)
    cols = torch.as_tensor(reflect_index(-HALO, w + HALO, w), device=x.device)
    padded = x.index_select(-2, rows).index_select(-1, cols)
    blurred = _conv5_cols(_conv5_rows(padded, _BLUR), _BLUR)
    dyy = _conv5_cols(_conv5_rows(blurred, _DERIV), _SMOOTH)
    dxx = _conv5_cols(_conv5_rows(blurred, _SMOOTH), _DERIV)
    return torch.abs(dyy + dxx)


def _check(stacks: torch.Tensor, z_counts) -> Optional[torch.Tensor]:
    """The depths as an int32 tensor on the stacks' device, or None for
    the full depth of every stack. Host values are range-checked; a
    tensor must be int32, of length B and on the stacks' device; on a CUDA
    device it is taken as it is, since only the kernel reads its values,
    and the kernel holds each to 1..Z."""
    if stacks.dim() != 4 or 0 in stacks.shape:
        raise ValueError(f"focus stacking needs a non-empty (B, Z, H, W) batch, got {tuple(stacks.shape)}")
    if stacks.dtype not in _DTYPE_CODES:
        raise TypeError(f"focus stacking takes uint8, uint16 or float32, got {stacks.dtype}")
    b, z = stacks.shape[:2]
    if z_counts is None:
        return None
    if isinstance(z_counts, torch.Tensor):
        if z_counts.dtype != torch.int32:
            raise TypeError(f"a z_counts tensor must be int32, got {z_counts.dtype}")
        if tuple(z_counts.shape) != (b,) or z_counts.device != stacks.device:
            raise ValueError(
                f"a z_counts tensor must hold {b} values on {stacks.device}, "
                f"got {tuple(z_counts.shape)} on {z_counts.device}")
        if z_counts.device.type == "cuda":
            return z_counts.contiguous()
        z_counts = z_counts.numpy()
    zc = np.asarray(z_counts).astype(np.int64).reshape(-1)
    if zc.shape != (b,) or zc.min() < 1 or zc.max() > z:
        raise ValueError(f"z_counts must be {b} values in 1..{z}, got {zc.tolist()}")
    return torch.as_tensor(zc.astype(np.int32), device=stacks.device)


def _valid(stacks: torch.Tensor, zc: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, Z) mask of the slices that count."""
    b, z = stacks.shape[:2]
    if zc is None:
        return torch.ones((b, z), dtype=torch.bool, device=stacks.device)
    return torch.arange(z, device=stacks.device)[None, :] < zc[:, None]


def _select(stacks: torch.Tensor, scores: torch.Tensor, zc: Optional[torch.Tensor]) -> torch.Tensor:
    valid = _valid(stacks, zc)
    scores = torch.where(valid[:, :, None, None], scores, float("-inf"))
    best_z = torch.argmax(scores, dim=1, keepdim=True)  # the first of equal maxima
    # gathered on the float32 copy: uint16 tensors convert but do not index
    return torch.gather(stacks.float(), 1, best_z)[:, 0].to(stacks.dtype)


def focus_stack_plain(stacks: torch.Tensor,
                      z_counts: Union[None, Sequence[int], np.ndarray, torch.Tensor] = None
                      ) -> torch.Tensor:
    """The kernel's function in PyTorch: (B, Z, H, W) -> (B, H, W) in the
    stacks' dtype, slices at or beyond each stack's ``z_count`` left out."""
    zc = _check(stacks, z_counts)
    return _select(stacks, focus_scores(stacks), zc)


def compare_with_plain(out: torch.Tensor, stacks: torch.Tensor, z_counts=None):
    """Hold a projection ``out`` of ``stacks`` against the plain version:
    (pixels that differ, those of them that are no near-tie, largest
    absolute difference). A differing pixel is a near-tie when the scores
    of the two chosen slices are within 1e-5 relative of each other."""
    ref = focus_stack_plain(stacks, z_counts)
    out_f, ref_f = out.float(), ref.float()
    diff = out_f != ref_f
    n_diff = int(diff.sum())
    if n_diff == 0:
        return 0, 0, 0.0
    valid = _valid(stacks, _check(stacks, z_counts))
    scores = torch.where(valid[:, :, None, None], focus_scores(stacks), float("-inf"))
    x = stacks.float()

    def chosen_score(values: torch.Tensor) -> torch.Tensor:
        return torch.where(x == values[:, None], scores, float("-inf")).amax(dim=1)

    s_out, s_ref = chosen_score(out_f), chosen_score(ref_f)
    far = diff & ~((s_out - s_ref).abs() <= 1e-5 * torch.maximum(s_out, s_ref))
    return n_diff, int(far.sum()), float((out_f - ref_f).abs().max())


def focus_stack(stacks: torch.Tensor,
                z_counts: Union[None, Sequence[int], np.ndarray, torch.Tensor] = None
                ) -> torch.Tensor:
    """Focus-stacking projection of a contiguous (B, Z, H, W) batch: the
    CUDA kernel for a CUDA tensor, else the plain version. ``z_counts``
    (1..Z per stack) masks Z padding: host values, which are checked and
    uploaded, or an int32 tensor on the stacks' device, which is taken as
    it is (the kernel holds its values to 1..Z); None is the full depth and
    uploads nothing."""
    global launches
    if stacks.device.type != "cuda":
        return focus_stack_plain(stacks, z_counts)
    zc = _check(stacks, z_counts)
    if not stacks.is_contiguous():
        raise ValueError("focus stacking input is not contiguous")
    b, z, h, w = stacks.shape
    out = torch.empty((b, h, w), dtype=stacks.dtype, device=stacks.device)
    err = _lib.get().tmat_focus_stack(
        stacks.data_ptr(), None if zc is None else zc.data_ptr(), out.data_ptr(), b, z, h, w,
        _DTYPE_CODES[stacks.dtype], torch.cuda.current_stream(stacks.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"focus stacking kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return out

