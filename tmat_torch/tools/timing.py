"""What the port's timing scripts share: the production shapes, the
CUDA-event timer, a pool of stacks larger than L2, and the card's name.

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
