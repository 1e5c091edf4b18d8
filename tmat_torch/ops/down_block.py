"""The fused UNet-Xception down block: CUDA kernel wrapper and plain version.

Counterpart of ``tmat_tpu/ops/pallas_unet.py::_down_block`` (the Pallas
TPU kernel ``_down_block_kernel``). One block computes, per image,

    [relu] -> dw3x3 -> pw1x1 (+BN folded) -> relu -> dw3x3 -> pw1x1 (+BN
    folded) -> maxpool 3x3/s2 TF-SAME  +  x[::2, ::2] @ wr + br

on an NHWC batch. The kernel (``csrc/down_block.cu``) is built with
``nvcc`` into the build cache (``build.py``) at first use and called through
ctypes on PyTorch's current stream. A CUDA tensor always goes to the
kernel (a failed build or launch raises); a CPU tensor goes to
``down_block_plain``, which rounds at the same points in PyTorch.

``launches`` counts kernel launches (not plain-version calls).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch import build

WEIGHT_KEYS = ("dw1", "w1", "b1", "dw2", "w2", "b2", "wr", "br")
BIAS_KEYS = ("b1", "b2", "br")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_launches_lock = threading.Lock()  # the plate issues device work from pool threads


def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.cuda_library("down_block")))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tmat_down_block.restype = i
    lib.tmat_down_block.argtypes = [vp] * 10 + [i] * 7 + [vp]
    lib.tmat_down_block_tile.restype = i
    lib.tmat_down_block_tile.argtypes = [i, i, i]
    lib.tmat_down_block_last_launch.restype = i
    lib.tmat_down_block_last_launch.argtypes = []
    return lib


_lib = build.LazyLibrary(_load_library)


def launch_config(channels: int, features: int, dtype: torch.dtype) -> Tuple[int, bool]:
    """(pooled-output tile side, whether the x tile is staged in shared
    memory) of the kernel's launch for a block of ``channels`` in and
    ``features`` out."""
    code = _launch_code(channels, features, dtype)
    return code % 100, code % 1000 < 100


def launch_form(channels: int, features: int, dtype: torch.dtype) -> str:
    """Which form of the kernel a block of 16-byte aligned tensors takes:
    ``"wgmma"`` (warpgroup products, weights by TMA through a ring; bf16
    with ``channels`` a multiple of 64 and ``features`` of 128) or
    ``"wmma"`` (the general form: any widths, float32, unaligned bases)."""
    return "wgmma" if _launch_code(channels, features, dtype) >= 1000 else "wmma"


def last_launch() -> Tuple[str, int, bool]:
    """(form, tile side, whether x was staged) of the kernel that the calling
    thread's last ``down_block`` launched: what the library took for those
    tensors, their alignment included, where ``launch_form`` and
    ``launch_config`` say what aligned tensors of a shape would take."""
    code = _lib.get().tmat_down_block_last_launch()
    if code == 0:
        raise RuntimeError("this thread's last down-block call launched no kernel")
    return "wgmma" if code >= 1000 else "wmma", code % 100, code % 1000 < 100


def _launch_code(channels: int, features: int, dtype: torch.dtype) -> int:
    code = _lib.get().tmat_down_block_tile(int(channels), int(features), _DTYPE_CODES[dtype])
    if code == 0:
        raise ValueError(f"no down-block launch fits {channels} -> {features} {dtype}")
    return code


def random_block(rng, b: int, h: int, c: int, f: int, dtype: torch.dtype, device
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """An NHWC input (b, h, h, c) and block weights of unit-scale outputs,
    drawn from the numpy ``rng``, for holding the kernel against its plain
    version."""
    x = torch.tensor(rng.randn(b, h, h, c).astype(np.float32), device=device).to(dtype)
    shapes = {"dw1": (9, c), "w1": (c, f), "b1": (f,), "dw2": (9, f), "w2": (f, f), "b2": (f,),
              "wr": (c, f), "br": (f,)}
    blk = {}
    for k, shape in shapes.items():
        scale = 0.3 if k.startswith("dw") else (0.1 if k in BIAS_KEYS else 1.0 / np.sqrt(shape[0]))
        a = torch.tensor((rng.randn(*shape) * scale).astype(np.float32), device=device)
        blk[k] = a if k in BIAS_KEYS else a.to(dtype)
    return x, blk


def _depthwise(x: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """3x3 SAME depthwise conv of an NHWC f32 tensor; ``dw`` is (9, C)."""
    c = x.shape[-1]
    weight = dw.float().t().reshape(c, 1, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=1, groups=c)
    return y.permute(0, 2, 3, 1)


def _maxpool3x3s2(u: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max pool, TF-SAME on even sizes: pad (0, 1) with -inf."""
    p = F.pad(u.permute(0, 3, 1, 2), (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(p, 3, stride=2).permute(0, 2, 3, 1)


def down_block_plain(
    x: torch.Tensor, blk: Dict[str, torch.Tensor], first: bool
) -> torch.Tensor:
    """The kernel's function in PyTorch, with its rounding points."""
    dt = x.dtype
    xf = x.float()
    h = xf if first else torch.relu(xf)
    t = _depthwise(h, blk["dw1"]).to(dt).float()
    t = torch.relu(t @ blk["w1"].float() + blk["b1"]).to(dt).float()
    u = _depthwise(t, blk["dw2"]).to(dt).float()
    u = u @ blk["w2"].float() + blk["b2"]
    r = xf[:, ::2, ::2] @ blk["wr"].float() + blk["br"]
    return (_maxpool3x3s2(u) + r).to(dt)


def _check(x: torch.Tensor, blk: Dict[str, torch.Tensor]) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"down block needs an NHWC batch of even size, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"down block takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    f = blk["w1"].shape[1]
    shapes = {
        "dw1": (9, c), "w1": (c, f), "b1": (f,), "dw2": (9, f),
        "w2": (f, f), "b2": (f,), "wr": (c, f), "br": (f,),
    }
    for k, shape in shapes.items():
        w = blk[k]
        want = torch.float32 if k in BIAS_KEYS else x.dtype
        if tuple(w.shape) != shape or w.dtype != want or w.device != x.device:
            raise ValueError(
                f"down block weight {k}: want {shape} {want} on {x.device}, "
                f"got {tuple(w.shape)} {w.dtype} on {w.device}"
            )
        if not w.is_contiguous():
            raise ValueError(f"down block weight {k} is not contiguous")
    if not x.is_contiguous():
        raise ValueError("down block input is not contiguous")


def down_block(
    x: torch.Tensor, blk: Dict[str, torch.Tensor], first: bool
) -> torch.Tensor:
    """One fused down block: the CUDA kernel for a CUDA tensor, else the
    plain version. ``blk`` holds the BN-folded weights (``WEIGHT_KEYS``)."""
    global launches
    _check(x, blk)
    if x.device.type != "cuda":
        return down_block_plain(x, blk, first)
    b, h, w, c = x.shape
    f = blk["w1"].shape[1]
    out = torch.empty((b, h // 2, w // 2, f), dtype=x.dtype, device=x.device)
    err = _lib.get().tmat_down_block(
        x.data_ptr(), *(blk[k].data_ptr() for k in WEIGHT_KEYS), out.data_ptr(),
        b, h, w, c, f, int(first), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"down block kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return out
