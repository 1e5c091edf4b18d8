"""Int8 convolution (s8 x s8 -> s32) with a fused epilogue: CUDA kernel wrapper and plain version.

No Pallas kernel stands behind it. The JAX package computes this
convolution outside Pallas: ``lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`` in ``tmat_tpu/models/quant.py``
(``forward_quant``'s and ``forward_mixed``'s convs), with the input's
requantisation and the epilogue as separate XLA elementwise passes. PyTorch
has no int8 convolution on CUDA, so the port has this kernel
(``csrc/int8_conv.cu``). For an NHWC batch ``x`` (B, H, W, Cin), square
int8 weights (kh, kh, Cin, Cout), TF-SAME zero padding and stride 1 or 2:

    xq  = x                                (an int8 batch)
    xq  = clip(round(relu?(f32(x)) * inv_sx), -127, 127)
                                          (a float32 / bfloat16 batch; 0 in the padding)
    acc = sum xq * w                      (int32, exact)
    v   = f32(acc) * m + c                (two rounded f32 operations)
    v   = max(v, 0)                       (with ``relu``)
    int8 out:    clip(round_half_even(v), -127, 127)
    float out:   v [* sout], rounded once to float32 or bfloat16
    requantised: clip(round(f32(mid(v)) * inv_next), -127, 127), mid() the
                 rounding to ``mid_dtype``: the next conv's int8 input

``m``, ``c``, ``sout`` and ``inv_next`` are per output channel, ``inv_sx``
per input channel, all float32. The weights are packed once
(``pack_weights``) into a (Cout, Kp) matrix, row n holding output channel
n's taps in (dy, dx, ci) order, zero-padded to Kp, the depth K = kh*kh*Cin
rounded up to 32 (the k of one int8 ``mma``).

The kernel has two forms (``launch_form``): the warpgroup form
(``wgmma`` s8 products, TMA-fed weights) for int8 or bfloat16 batches
whose Cin and Cout are multiples of 128 on 16-byte aligned tensors, and
the ``mma.sync`` form for everything else (the entry conv's single
channel, float32 batches). ``last_launch`` says which form the calling
thread's last launch took.

A CUDA tensor always goes to the kernel: a refused argument raises, a
failed build or launch raises, nothing falls back. A CPU tensor goes to
``conv2d_s8_plain``, which convolves the int8 values as float64 (every sum
is below 9 * 512 * 127**2 < 2**53, so it is exact) and runs the
requantisations and the epilogue as separate rounded float32 operations
and ``torch.round``. The kernel is compiled without FMA contraction, so the
two agree bit for bit.

``launches`` counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch import build

K_ALIGN = 32  # the depth of one m16n8k32 int8 mma
KERNEL_SIZES = (1, 3)
STRIDES = (1, 2)
_OUT_CODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
OUT_DTYPES = tuple(_OUT_CODES)

launches = 0
_launches_lock = threading.Lock()


def library_path(defines: Sequence[str] = ()):
    """Build ``csrc/int8_conv.cu`` if needed. No FMA contraction, so the
    requantisations and the epilogue round as the plain version does."""
    return build.cuda_library("int8_conv", defines, flags=("-fmad=false",))


def _load_library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(defines)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tmat_int8_conv.restype = i
    lib.tmat_int8_conv.argtypes = [vp] * 8 + [i] * 16 + [vp]
    lib.tmat_int8_conv_form.restype = i
    lib.tmat_int8_conv_form.argtypes = [i] * 6
    lib.tmat_int8_conv_last_launch.restype = i
    lib.tmat_int8_conv_last_launch.argtypes = []
    return lib


_lib = build.LazyLibrary(_load_library)


@contextmanager
def built_with(*defines: str):
    """Within the block, launches go to the library built with these macros,
    to time one form against the other: ``TMAT_INT8_MMA_SYNC_ONLY`` keeps
    the mma.sync form only."""
    global _lib
    saved, _lib = _lib, build.LazyLibrary(lambda: _load_library(defines))
    try:
        yield
    finally:
        _lib = saved


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/Flax SAME padding (before, after) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def padded_depth(kh: int, cin: int) -> int:
    """Kp: the depth kh*kh*cin rounded up to a multiple of 32."""
    return -(-kh * kh * cin // K_ALIGN) * K_ALIGN


def pack_weights(w_hwio) -> torch.Tensor:
    """(kh, kh, Cin, Cout) int8 weights as the kernel's contiguous (Cout,
    Kp) int8 matrix, on the CPU (move it to the card once)."""
    w = torch.as_tensor(np.ascontiguousarray(w_hwio)) if not isinstance(w_hwio, torch.Tensor) else w_hwio
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.dtype != torch.int8:
        raise ValueError(f"pack_weights takes square (kh, kh, Cin, Cout) int8 weights, got "
                         f"{tuple(w.shape)} {w.dtype}")
    kh, _, cin, cout = w.shape
    k = kh * kh * cin
    packed = torch.zeros((cout, padded_depth(kh, cin)), dtype=torch.int8, device=w.device)
    packed[:, :k] = w.permute(3, 0, 1, 2).reshape(cout, k)
    return packed


def unpack_weights(packed: torch.Tensor, kh: int, cin: int) -> torch.Tensor:
    """The (Cout, Cin, kh, kh) int8 weights of a packed matrix."""
    cout = packed.shape[0]
    return packed[:, : kh * kh * cin].reshape(cout, kh, kh, cin).permute(0, 3, 1, 2)


IN_DTYPES = (torch.int8, torch.float32, torch.bfloat16)
_IN_CODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
MID_DTYPES = (torch.float32, torch.bfloat16)
# what tmat_int8_conv_last_launch / tmat_int8_conv_form return
FORMS = {3: "wgmma", 1: "mma_sync", 2: "mma_sync-gather"}


def _check(x, packed, kh, stride, m, c, out_dtype, sout, inv_sx, relu_in, inv_next, mid_dtype) -> None:
    if x.dim() != 4 or x.dtype not in IN_DTYPES:
        raise ValueError(f"the int8 conv takes an int8, float32 or bfloat16 (B, H, W, Cin) batch, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.dtype == torch.int8 and (inv_sx is not None or relu_in):
        raise ValueError("inv_sx and relu_in requantise a float batch; an int8 batch has neither")
    if x.dtype != torch.int8 and inv_sx is None:
        raise ValueError(f"the int8 conv takes a {x.dtype} batch only with inv_sx, its requantisation "
                         f"scale per input channel")
    if kh not in KERNEL_SIZES or stride not in STRIDES:
        raise ValueError(f"the int8 conv takes kernel sizes {KERNEL_SIZES} and strides {STRIDES}, "
                         f"got {kh} and {stride}")
    cin = x.shape[-1]
    if packed.dtype != torch.int8 or packed.dim() != 2 or packed.shape[1] != padded_depth(kh, cin):
        raise ValueError(f"packed weights must be int8 (Cout, {padded_depth(kh, cin)}) for a {kh}x{kh} "
                         f"conv of {cin} channels, got {tuple(packed.shape)} {packed.dtype}")
    cout = packed.shape[0]
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"the int8 conv writes {OUT_DTYPES}, not {out_dtype}")
    if sout is not None and out_dtype == torch.int8:
        raise ValueError("sout scales a float output; an int8 output has none")
    if inv_next is not None and out_dtype != torch.int8:
        raise ValueError("inv_next requantises the output to int8; a float output has none")
    if mid_dtype is not None and (inv_next is None or mid_dtype not in MID_DTYPES):
        raise ValueError(f"mid_dtype is one of {MID_DTYPES}, the rounding of a requantised output before "
                         f"inv_next, got {mid_dtype}")
    for name, t, n in (("m", m, cout), ("c", c, cout), ("sout", sout, cout), ("inv_next", inv_next, cout),
                       ("inv_sx", inv_sx, cin)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},), got {tuple(t.shape)} {t.dtype}")
    for name, t in (("packed weights", packed), ("m", m), ("c", c), ("sout", sout), ("inv_sx", inv_sx),
                    ("inv_next", inv_next)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, the batch on {x.device}")


def out_size(size: int, stride: int) -> int:
    return -(-size // stride)


def _mid(x: torch.Tensor, mid_dtype) -> torch.dtype:
    """The float type a requantised output rounds to: ``mid_dtype``, else
    the batch's float type, else float32."""
    if mid_dtype is not None:
        return mid_dtype
    return x.dtype if x.dtype != torch.int8 else torch.float32


def requantize(h: torch.Tensor, inv_s: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """clip(round(relu?(f32(h)) * inv_s), -127, 127) as int8: the
    requantisation of a float tensor at per-channel scales ``1 / inv_s``."""
    v = h.float()
    if relu:
        v = torch.clamp_min(v, 0.0)
    return torch.clamp(torch.round(v * inv_s), -127, 127).to(torch.int8)


def epilogue_plain(acc: torch.Tensor, m: torch.Tensor, c: torch.Tensor, relu: bool,
                   out_dtype: torch.dtype, sout: Optional[torch.Tensor],
                   inv_next: Optional[torch.Tensor] = None,
                   mid_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's epilogue on exact sums ``acc`` (any dtype holding them)."""
    v = acc.float() * m
    v = v + c
    if relu:
        v = torch.clamp_min(v, 0.0)
    if inv_next is not None:
        return requantize(v.to(mid_dtype), inv_next)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8)
    if sout is not None:
        v = v * sout
    return v.to(out_dtype)


def conv2d_s8_plain(x: torch.Tensor, packed: torch.Tensor, kh: int, stride: int, m: torch.Tensor,
                    c: torch.Tensor, relu: bool = False, out_dtype: torch.dtype = torch.int8,
                    sout: Optional[torch.Tensor] = None, *, inv_sx: Optional[torch.Tensor] = None,
                    relu_in: bool = False, inv_next: Optional[torch.Tensor] = None,
                    mid_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in PyTorch, on any device (float64 sums)."""
    _check(x, packed, kh, stride, m, c, out_dtype, sout, inv_sx, relu_in, inv_next, mid_dtype)
    xq = x if inv_sx is None else requantize(x, inv_sx, relu_in)
    (pt, pb), (pl, pr) = same_pads(x.shape[1], kh, stride), same_pads(x.shape[2], kh, stride)
    xc = F.pad(xq.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    acc = F.conv2d(xc, unpack_weights(packed, kh, x.shape[-1]).double(), stride=stride)
    return epilogue_plain(acc.permute(0, 2, 3, 1), m, c, relu, out_dtype, sout, inv_next,
                          _mid(x, mid_dtype)).contiguous()


def conv2d_s8(x: torch.Tensor, packed: torch.Tensor, kh: int, stride: int, m: torch.Tensor,
              c: torch.Tensor, relu: bool = False, out_dtype: torch.dtype = torch.int8,
              sout: Optional[torch.Tensor] = None, *, inv_sx: Optional[torch.Tensor] = None,
              relu_in: bool = False, inv_next: Optional[torch.Tensor] = None,
              mid_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 conv of a contiguous NHWC batch: the CUDA kernel for a CUDA
    tensor, else the plain version. ``x`` is int8, or float32 / bfloat16
    with ``inv_sx`` (requantised on load, after a relu with ``relu_in``).
    ``packed`` is ``pack_weights``' matrix (16-byte aligned on the card);
    ``m``, ``c``, ``sout`` and ``inv_next`` float32 per output channel;
    ``sout`` only with a float ``out_dtype``, ``inv_next`` only with int8,
    its float rounding ``mid_dtype`` (default: the batch's float type, else
    float32)."""
    global launches
    if x.device.type != "cuda":
        return conv2d_s8_plain(x, packed, kh, stride, m, c, relu, out_dtype, sout, inv_sx=inv_sx,
                               relu_in=relu_in, inv_next=inv_next, mid_dtype=mid_dtype)
    _check(x, packed, kh, stride, m, c, out_dtype, sout, inv_sx, relu_in, inv_next, mid_dtype)
    for name, t in (("batch", x), ("packed weights", packed), ("m", m), ("c", c), ("sout", sout),
                    ("inv_sx", inv_sx), ("inv_next", inv_next)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"int8 conv: the {name} is not contiguous")
    if packed.data_ptr() % 16:
        raise ValueError("int8 conv: the packed weights are not 16-byte aligned")
    b, h, w, cin = x.shape
    cout = packed.shape[0]
    ho, wo = out_size(h, stride), out_size(w, stride)
    out = torch.empty((b, ho, wo, cout), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    pad_t, pad_l = same_pads(h, kh, stride)[0], same_pads(w, kh, stride)[0]
    out_code = _OUT_CODES[out_dtype] if inv_next is None else 3 + MID_DTYPES.index(_mid(x, mid_dtype))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib.get().tmat_int8_conv(
        x.data_ptr(), packed.data_ptr(), m.data_ptr(), c.data_ptr(), ptr(sout), ptr(inv_sx), ptr(inv_next),
        out.data_ptr(), b, h, w, cin, cout, kh, stride, pad_t, pad_l, ho, wo, packed.shape[1], int(relu),
        int(relu_in), _IN_CODES[x.dtype], out_code, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return out


def launch_form(cin: int, cout: int, kh: int, stride: int, width: int, in_dtype: torch.dtype = torch.int8) -> str:
    """The form a call with 16-byte aligned tensors takes (a batch ``width``
    pixels wide): ``"wgmma"`` (the warpgroup form), ``"mma_sync"`` (cp.async
    loads of an int8 batch) or ``"mma_sync-gather"`` (element by element)."""
    return FORMS[_lib.get().tmat_int8_conv_form(_IN_CODES[in_dtype], int(cin), int(cout), int(kh), int(stride),
                                                 int(width))]


def last_launch() -> Optional[str]:
    """The form (as ``launch_form`` names it) of the kernel that the calling
    thread's last launch took, its tensors' alignment included; None if it
    launched nothing."""
    return FORMS.get(_lib.get().tmat_int8_conv_last_launch())
