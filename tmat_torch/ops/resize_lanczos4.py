"""Lanczos-4 resize of a stack: CUDA kernel wrapper and plain version.

The inv_depth tool's ingest (``tools/compute_inv_depth.py::dispatch_stack``).
Computes ``ops/resize.py::resize_lanczos4_host`` (the true a=4 kernel of
cv2's INTER_LANCZOS4, with ``lanczos4_weight_matrix``'s float32 weights)
on a (Z, H, W) stack of uint8, uint16 or float32, to (Z, h, w) in the
stack's dtype: the vertical pass, then the horizontal one, float32
throughout; integers rounded half to even and clipped to their dtype's
range, as ``models/preprocess.py::host_resize`` returns them. A 2-D image
is a stack of one, and comes back as (1, h, w), as from ``host_resize``.

No TPU kernel is behind the CUDA kernel (``csrc/resize_lanczos4.cu``): the
JAX package resizes on the host. A CUDA tensor always goes to the kernel (a
failed build or launch raises); a CPU tensor goes to
``resize_lanczos4_plain``, the host's two products with ``torch.matmul`` in
the host's order. The kernel sums each output's taps in ascending index, so
an integer output may differ from the plain version's by one level where
the float32 sum lies within a rounding error of a half-integer.

The kernel takes the weights in banded form (``band``): for each output,
the first nonzero input index, the taps up to the last nonzero weight, and
their weights, taken from the dense matrix, so it leaves out only products
by zero. They are uploaded once per (in size, out size, device). ``plan``
picks the kernel's tile for a size. ``launches`` counts kernel launches
(not plain-version calls); each also adds one to the calling thread's
counter ``resize_launches`` (``core/profiling.py::count``).
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from tmat_torch import build
from tmat_torch.core.profiling import count
from tmat_torch.ops.resize import lanczos4_weight_matrix

_DTYPE_CODES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_TOP = {torch.uint8: 255.0, torch.uint16: 65535.0}
TILE = (16, 32)  # output rows x columns of a CTA, before ``plan`` shrinks them
SMEM_BYTES = 72 * 1024  # shared memory of a CTA at most: three CTAs an SM
MAX_GRID_YZ = 65535

launches = 0
_launches_lock = threading.Lock()
_device_bands: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
_bands_lock = threading.Lock()


def library_path():
    """Build ``csrc/resize_lanczos4.cu`` if needed."""
    return build.cuda_library("resize_lanczos4")


def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tmat_resize_lanczos4.restype = i
    lib.tmat_resize_lanczos4.argtypes = [vp, vp, i, i, i, i, i, vp, vp, vp, i, vp, vp, vp, i,
                                         i, i, i, i, i, vp]
    return lib


_lib = build.LazyLibrary(_load_library)


class Band(NamedTuple):
    first: np.ndarray    # int32 (out,): first input index of each output's taps
    count: np.ndarray    # int32 (out,): its taps, up to its last nonzero weight
    weights: np.ndarray  # float32 (out, k): their weights, zero beyond ``count``


@lru_cache(maxsize=64)
def band(n_in: int, n_out: int) -> Band:
    """``lanczos4_weight_matrix(n_in, n_out)`` in banded form. Each band's
    first and last input index never decrease from one output to the next
    (the kernel's tiles rely on it). Cached: callers never write to it."""
    m = lanczos4_weight_matrix(n_in, n_out)
    nz = m != 0
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    taps = last - first + 1
    k = np.arange(int(taps.max()))
    idx = np.minimum(first[:, None] + k, n_in - 1)
    weights = np.where(k < taps[:, None], np.take_along_axis(m, idx, axis=1), 0).astype(np.float32)
    if (np.diff(first) < 0).any() or (np.diff(last) < 0).any():
        raise ValueError(f"the Lanczos-4 bands of {n_in} -> {n_out} do not move monotonically")
    return Band(first.astype(np.int32), taps.astype(np.int32), weights)


def _span(b: Band, tile: int) -> int:
    """The most input indices that the bands of ``tile`` consecutive outputs
    cover together."""
    starts = b.first[::tile]
    last = np.minimum(np.arange(1, len(starts) + 1) * tile, len(b.first)) - 1
    return int((b.first[last] + b.count[last] - starts).max())


@lru_cache(maxsize=64)
def plan(H: int, W: int, h: int, w: int) -> Tuple[int, int, int, int]:
    """The kernel's (TH, TW, RC, CP) for (H, W) -> (h, w): the output tile,
    the input rows loaded at once and the widest tile's input columns.
    From ``TILE`` the tile halves (columns first) until its intermediate,
    its taps and at least one input row fit in ``SMEM_BYTES``; RC is then
    every row the tile needs, or as many as fit."""
    bv, bh = band(H, h), band(W, w)
    th, tw = TILE
    while True:
        cp = _span(bh, tw)
        fixed = smem_bytes(th, tw, 0, cp, bv, bh)
        rc = min(_span(bv, th), (SMEM_BYTES - fixed) // (4 * cp))
        if rc >= 1:
            return th, tw, rc, cp
        if tw > 1:
            tw //= 2
        elif th > 1:
            th //= 2
        else:
            raise ValueError(f"resizing {W} -> {w} columns needs a band of {cp} taps, wider than the "
                             "kernel's shared memory takes")


def smem_bytes(th: int, tw: int, rc: int, cp: int, bv: Band, bh: Band) -> int:
    """The kernel's shared memory for a plan: the intermediate, ``rc`` input
    rows and the tile's taps, float32."""
    return 4 * ((th + rc) * cp + bh.weights.shape[1] * tw + th * bv.weights.shape[1])


def _device_band(n_in: int, n_out: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``band(n_in, n_out)``'s arrays on ``device``, uploaded once."""
    key = (n_in, n_out, device)
    with _bands_lock:
        got = _device_bands.get(key)
    if got is None:
        got = tuple(torch.from_numpy(a).to(device) for a in band(n_in, n_out))
        with _bands_lock:
            got = _device_bands.setdefault(key, got)
    return got


def _check(stack: torch.Tensor, shape) -> Tuple[torch.Tensor, int, int]:
    """The stack as (Z, H, W) and the output size, or a TypeError or
    ValueError for what neither version takes."""
    if stack.dtype not in _DTYPE_CODES:
        raise TypeError(f"the Lanczos-4 resize takes uint8, uint16 or float32, got {stack.dtype}")
    if stack.dim() not in (2, 3) or 0 in stack.shape:
        raise ValueError(f"the Lanczos-4 resize needs a non-empty (Z, H, W) or (H, W) stack, "
                         f"got {tuple(stack.shape)}")
    if not stack.is_contiguous():
        raise ValueError("the Lanczos-4 resize input is not contiguous")
    if stack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the Lanczos-4 resize runs on the CPU or a CUDA device, not {stack.device}")
    h, w = (int(s) for s in shape)
    if h < 1 or w < 1:
        raise ValueError(f"the Lanczos-4 resize needs a positive output size, got {tuple(shape)}")
    return (stack if stack.dim() == 3 else stack[None]), h, w


def _round_clip(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return out
    return out.round().clamp_(0.0, _TOP[dtype]).to(dtype)


def resize_lanczos4_plain(stack: torch.Tensor, shape) -> torch.Tensor:
    """The kernel's function in PyTorch on the stack's device: the host's
    two products (each with the slices folded into its free dimension) with
    ``torch.matmul``, then the host's rounding and clipping."""
    x, h, w = _check(stack, shape)
    z, H, W = x.shape
    wv = torch.from_numpy(lanczos4_weight_matrix(H, h)).to(x.device)
    wh = torch.from_numpy(lanczos4_weight_matrix(W, w)).to(x.device)
    t1 = (wv @ x.float().permute(1, 0, 2).reshape(H, z * W)).reshape(h, z, W)
    t2 = t1.permute(1, 0, 2).reshape(z * h, W) @ wh.T
    return _round_clip(t2.reshape(z, h, w), x.dtype)


def resize_lanczos4(stack: torch.Tensor, shape) -> torch.Tensor:
    """Lanczos-4 resize of a contiguous (Z, H, W) or (H, W) stack to (Z, h,
    w) in its dtype: the CUDA kernel for a CUDA tensor, on the current
    stream, else the plain version."""
    global launches
    if stack.device.type != "cuda":
        return resize_lanczos4_plain(stack, shape)
    x, h, w = _check(stack, shape)
    z, H, W = x.shape
    th, tw, rc, cp = plan(H, W, h, w)
    if z > MAX_GRID_YZ or -(-h // th) > MAX_GRID_YZ:
        raise ValueError(f"the Lanczos-4 kernel takes at most {MAX_GRID_YZ} slices and row tiles, "
                         f"got {z} slices to {h} rows")
    vf, vc, vw = _device_band(H, h, x.device)
    hf, hc, hw = _device_band(W, w, x.device)
    out = torch.empty((z, h, w), dtype=x.dtype, device=x.device)
    err = _lib.get().tmat_resize_lanczos4(
        x.data_ptr(), out.data_ptr(), z, H, W, h, w,
        vf.data_ptr(), vc.data_ptr(), vw.data_ptr(), vw.shape[1],
        hf.data_ptr(), hc.data_ptr(), hw.data_ptr(), hw.shape[1],
        th, tw, rc, cp, _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"Lanczos-4 resize kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    count("resize_launches")
    return out
