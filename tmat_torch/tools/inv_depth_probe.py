"""Where one inv_depth stack's time goes on the card, stage by stage.

    python -m tmat_torch.tools.inv_depth_probe [--reps 20]

Loads the shipped ensemble (3 members ranked by history, bf16) and one
random uint8 (8, 1024, 1024) stack, then prints one JSON line each for:
the host Lanczos-4 resize; the upload (pinned and pageable) and the prep
tail, apart; the ensemble's forward as the tool runs it (each member's
features replayed from its CUDA graph, the head eager), then its base
forward eagerly in channels-last and in NCHW layout, each with cuDNN's
autotuner off and on, by CUDA events; and the CUDA kernels of one eager
channels-last forward by ``torch.profiler``, largest first.
The last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from tmat_torch.models.preprocess import host_resize, prep_tail
from tmat_torch.models.resnet import ensemble_forward
from tmat_torch.tools import compute_inv_depth as inv
from tmat_torch.tools.timing import card_line, cuda_ms

ROOT = Path(__file__).resolve().parents[2]


def host_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` on the host clock, the card synchronised after
    each call, after a warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("inv_depth_probe: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    ens_dir = ROOT / "model_training" / "best_ensemble"
    ckpts = [ens_dir / f"best_finetune_weights_{i}.msgpack"
             for i in inv._rank_models_by_history(ens_dir, 5)[:3]]
    ens = inv.load_ensemble(ckpts, (256, 256, 3), "conv4_block6_out", device=dev)
    stack = np.random.RandomState(0).randint(0, 256, (8, 1024, 1024)).astype(np.uint8)

    resized = host_resize(stack, (256, 256))
    host = torch.from_numpy(resized)
    pinned = host.pin_memory()
    print(json.dumps({
        "stage": "ingest",
        "host_resize_ms": host_ms(lambda: host_resize(stack, (256, 256)), 5),
        "upload_pin_each_call_ms": host_ms(lambda: host.pin_memory().to(dev, non_blocking=True), args.reps),
        "upload_pinned_ms": host_ms(lambda: pinned.to(dev, non_blocking=True), args.reps),
        "upload_pageable_ms": host_ms(lambda: host.to(dev), args.reps),
        "prep_tail_ms": host_ms(lambda: prep_tail(pinned.to(dev)), args.reps),
    }), flush=True)

    x_in = prep_tail(host.to(dev))
    replayed_ms = cuda_ms(lambda: ensemble_forward(ens, x_in), args.reps)
    # the layouts below give the bases new weight tensors: no graph replays after them
    x = x_in.permute(0, 3, 1, 2).to(torch.bfloat16)
    layouts = {"channels_last": x.contiguous(memory_format=torch.channels_last),
               "nchw": x.contiguous()}
    forwards = {}
    with torch.no_grad():
        for layout, xl in layouts.items():
            fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
            for m in ens:
                m.base.to(memory_format=fmt)
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                forwards[f"{layout}_autotune_{'on' if bench else 'off'}_ms"] = cuda_ms(
                    lambda: [m.base(xl) for m in ens], args.reps)
        torch.backends.cudnn.benchmark = False
        for m in ens:
            m.base.to(memory_format=torch.channels_last)
        print(json.dumps({"stage": "forward", "members": len(ens), "batch": list(x.shape),
                          "replayed_ms": replayed_ms, **forwards}),
              flush=True)

        from torch.profiler import ProfilerActivity, profile

        xl = layouts["channels_last"]
        [m.base(xl) for m in ens]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            [m.base(xl) for m in ens]
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and e.device_time_total > 0]
    kernels.sort(key=lambda e: -e.device_time_total)
    print(json.dumps({"stage": "profile", "kernels": len(kernels),
                      "launches": sum(e.count for e in kernels),
                      "device_us": sum(e.device_time_total for e in kernels),
                      "top": [{"name": e.key[:100], "calls": e.count, "device_us": e.device_time_total}
                              for e in kernels[:14]]}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
