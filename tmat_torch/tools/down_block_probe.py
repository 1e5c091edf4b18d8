"""Where the down-block kernel's cycles go, per phase, on the card.

    python -m tmat_torch.tools.down_block_probe [--batch 200] [--seed 0] [--steps]

Builds ``csrc/down_block.cu`` with ``-DTMAT_DOWN_BLOCK_PROBE`` (thread 0 of
each CTA adds the clock64 cycles between its marks to one counter per
stage) into a library of its own in the build cache, runs each production block
(patch 320, filters 64-512) once in bf16, and prints one JSON line per
block: the cycles per CTA and each phase's share, with the probe build's
CUDA-event time. With ``--steps`` the build also defines
``TMAT_DOWN_BLOCK_STEP_PROBE`` and the counters hold the parts of one
weight-tile step of the warpgroup form (``STEP_PARTS``), printed as cycles
per step. The probe builds are only read here; the port never loads them.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from tmat_torch import build
from tmat_torch.ops import down_block as db
from tmat_torch.tools.timing import BLOCK_SHAPES

# the warpgroup form's stages (pw1 and pw2_residual include the wait for
# their weight tiles), and the general form's
PHASES = ("stage_x", "dw1", "pw1", "pw1_epilogue", "dw2", "pw2_residual", "pw2_epilogue", "pool")
# the parts of a weight-tile step of the warpgroup form, on thread 0 (--steps)
STEP_PARTS = ("wait_for_tile", "launch_products", "wait_for_products_before", "barrier", "request_next_tile",
              "between_steps")
PHASES_WMMA = ("stage_x", "dw1", "stage_w1", "pw1", "dw2", "stage_w2", "pw2_residual", "pool")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", action="store_true", help="the parts of a weight-tile step instead of the stages")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("down_block_probe: needs a CUDA device")
    defines = ["TMAT_DOWN_BLOCK_PROBE"] + (["TMAT_DOWN_BLOCK_STEP_PROBE"] if args.steps else [])
    lib = ctypes.CDLL(str(build.cuda_library("down_block", defines)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tmat_down_block.restype = i
    lib.tmat_down_block.argtypes = [vp] * 10 + [i] * 7 + [vp]
    lib.tmat_down_block_tile.restype = i
    lib.tmat_down_block_tile.argtypes = [i, i, i]
    lib.tmat_down_block_last_launch.restype = i
    lib.tmat_down_block_last_launch.argtypes = []
    lib.tmat_down_block_probe_read.restype = i
    lib.tmat_down_block_probe_read.argtypes = [vp]
    counters = (ctypes.c_ulonglong * 8)()

    library = db._lib._lib
    db._lib._lib = lib
    try:
        rng = np.random.RandomState(args.seed)
        for h, c, f in BLOCK_SHAPES:
            x, blk = db.random_block(rng, args.batch, h, c, f, torch.bfloat16, "cuda")
            first = h == BLOCK_SHAPES[0][0]
            db.down_block(x, blk, first)  # warm
            torch.cuda.synchronize()
            if lib.tmat_down_block_probe_read(ctypes.addressof(counters)) != 0:
                raise RuntimeError("reading the probe counters failed")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            db.down_block(x, blk, first)
            end.record()
            torch.cuda.synchronize()
            if lib.tmat_down_block_probe_read(ctypes.addressof(counters)) != 0:
                raise RuntimeError("reading the probe counters failed")
            form, tile, staged = db.last_launch()
            names = PHASES if form == "wgmma" else PHASES_WMMA
            ctas = args.batch * (-(-(h // 2) // tile)) ** 2
            per_cta = [v / ctas for v in counters]
            total = sum(per_cta)
            if args.steps:
                if form != "wgmma":
                    raise RuntimeError("--steps reads the warpgroup form only")
                steps = counters[6] / ctas  # counted by the kernel: one a weight tile
                print(json.dumps({
                    "shape": [args.batch, h, h, c, f], "form": form, "tile": tile, "steps_per_cta": steps,
                    "probe_ms": start.elapsed_time(end),
                    "cycles_per_step": {n: v / steps for n, v in zip(STEP_PARTS, per_cta)},
                    "device": torch.cuda.get_device_name(0),
                }), flush=True)
                continue
            print(json.dumps({
                "shape": [args.batch, h, h, c, f], "form": form, "tile": tile, "x_staged": staged,
                "probe_ms": start.elapsed_time(end), "cycles_per_cta": total,
                "share": {n: v / total for n, v in zip(names, per_cta)},
                "device": torch.cuda.get_device_name(0),
            }), flush=True)
    finally:
        db._lib._lib = library
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
