"""What the port's timing scripts share: the production shapes, the
CUDA-event timer, a pool of stacks larger than L2, the int8 up convs as
the quantized forward launches them, and the card's name.

Imports nothing of ``tmat_torch``, so a script can load this file by path
and then time another checkout's package (``kernel_times.py --tree``).
"""

from __future__ import annotations

import subprocess
from typing import Callable

import numpy as np
import torch

# (H, C, F) of the production down blocks: patch 320, filters 64-128-256-512
BLOCK_SHAPES = ((160, 64, 128), (80, 128, 256), (40, 256, 512))
# (tag, H, Cin, Cout) of the six 3x3 int8 up convs of the mixed segmentor
INT8_UP_SHAPES = (("u0.t1", 20, 512, 512), ("u0.t2", 20, 512, 512), ("u1.t1", 40, 512, 256),
                  ("u1.t2", 40, 256, 256), ("u2.t1", 80, 256, 128), ("u2.t2", 80, 128, 128))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, CUDA events, after a warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stack_pool(rng, b: int, device) -> Callable[[], torch.Tensor]:
    """Random uint8 (b, 8, 1024, 1024) batches, 64 MB together (more than the
    50 MB L2, so each call reads device memory); the returned function hands
    them out in turn."""
    pool = [torch.from_numpy(rng.randint(0, 256, (b, 8, 1024, 1024)).astype(np.uint8)).to(device)
            for _ in range(max(1, 8 // b))]
    turn = [0]

    def nxt() -> torch.Tensor:
        turn[0] += 1
        return pool[turn[0] % len(pool)]

    return nxt


def int8_up_inputs(ic, rng, b: int, h: int, cin: int, cout: int, device) -> dict:
    """Random inputs of one int8 up conv (``ic`` is an ``ops/int8_conv.py``):
    the bfloat16 batch a t1 conv takes and the int8 batch a t2 conv takes,
    packed weights, and per-channel m, c, inv_sx and inv_next (m keeps sums
    of up to 9 * 512 * 127**2 within a few hundred steps)."""
    xf = torch.from_numpy((rng.randn(b, h, h, cin) * 30).astype(np.float32)).to(device).to(torch.bfloat16)
    xq = torch.from_numpy(rng.randint(-127, 128, (b, h, h, cin)).astype(np.int8)).to(device)
    packed = ic.pack_weights(rng.randint(-127, 128, (3, 3, cin, cout)).astype(np.int8)).to(device)
    m, c, inv_next = (torch.tensor(v.astype(np.float32), device=device)
                      for v in (rng.rand(cout) * 2e-4, rng.randn(cout), rng.rand(cout) + 0.5))
    inv_sx = torch.tensor((rng.rand(cin) + 0.5).astype(np.float32), device=device)
    return {"xf": xf, "xq": xq, "packed": packed, "m": m, "c": c, "inv_sx": inv_sx, "inv_next": inv_next}


def fuses_requant(ic) -> bool:
    """Whether ``ic``'s kernel requantises a float input itself (a tree from
    before the fused forms takes int8 inputs only)."""
    return hasattr(ic, "requantize")


def int8_up_call(ic, tag: str, a: dict, fused: bool = True) -> Callable[[], object]:
    """One up conv as the mixed forward launches it. Fused: t1 requantises
    its bfloat16 input (after a relu) and writes t2's int8 input, t2 writes
    bfloat16. Unfused (the forward before the fused forms): the input
    requantised by PyTorch passes, then int8 in, bfloat16 out."""
    if not fused:
        def unfused():
            hq = torch.clamp(torch.round(a["xf"].float() * a["inv_sx"]), -127, 127).to(torch.int8)
            return ic.conv2d_s8(hq, a["packed"], 3, 1, a["m"], a["c"], out_dtype=torch.bfloat16)
        return unfused
    if tag.endswith("t1"):
        return lambda: ic.conv2d_s8(a["xf"], a["packed"], 3, 1, a["m"], a["c"], True, inv_sx=a["inv_sx"],
                                    relu_in=True, inv_next=a["inv_next"], mid_dtype=torch.bfloat16)
    return lambda: ic.conv2d_s8(a["xq"], a["packed"], 3, 1, a["m"], a["c"], out_dtype=torch.bfloat16)
