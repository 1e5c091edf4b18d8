"""CUDA-event times of the port's three kernels at the shapes its main paths give them.

    python tmat_torch/tools/kernel_times.py [--tree DIR] [--seed 0]

Prints one JSON line: the three production down blocks (200 patches, bf16)
and their sum, the focus kernel on uint8 (1, 8, 1024, 1024) and (8, 8, 1024,
1024) stacks (each call on another 64 MB of stacks, so that L2 is cold) with
host ``z_counts`` and at full depth, an empty-sized focus launch, the six
int8 up convs of the mixed segmentor at B=200 as its forward launches them
(a tree whose kernel requantises its input: t1 bfloat16 in, int8 out, t2
int8 in; an older tree: each input requantised by PyTorch, then int8 in,
bfloat16 out; ``int8_up_fused`` says which) and their sum, and the card's
name and power limit.

``--tree DIR`` imports ``tmat_torch`` from another checkout (say the parent
commit, unpacked with ``git archive`` into a git-ignored directory) instead
of this one, so two commits can be timed in turns on one card:

    for t in PARENT . . PARENT; do python tmat_torch/tools/kernel_times.py --tree $t; done

The shapes and the timer are ``timing.py``'s, beside this file; it is
loaded by path because ``--tree`` puts another checkout's package first.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def load_timing():
    spec = importlib.util.spec_from_file_location("kernel_times_timing", Path(__file__).with_name("timing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                   help="the checkout whose tmat_torch is timed (default: this one)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    from tmat_torch.ops import down_block as db, focus_stack as fs, int8_conv as ic

    device = torch.device("cuda")
    rng = np.random.RandomState(args.seed)

    timing = load_timing()
    ms, BLOCK_SHAPES = timing.cuda_ms, timing.BLOCK_SHAPES
    res = {"tree": str(Path(db.__file__).resolve().parents[2]), "card": timing.card_line()}
    for h, c, f in BLOCK_SHAPES:
        x, blk = db.random_block(rng, 200, h, c, f, torch.bfloat16, device)
        res[f"block_{h}_ms"] = ms(lambda: db.down_block(x, blk, h == BLOCK_SHAPES[0][0]), 10)
    res["down_path_ms"] = sum(res[f"block_{h}_ms"] for h, _, _ in BLOCK_SHAPES)
    for b in (1, 8):
        nxt = timing.stack_pool(rng, b, device)
        zc = [8] * b
        res[f"focus_b{b}_host_counts_ms"] = ms(lambda: fs.focus_stack(nxt(), zc), 20)
        res[f"focus_b{b}_full_depth_ms"] = ms(lambda: fs.focus_stack(nxt()), 20)
    tiny = torch.zeros((1, 1, 1, 1), dtype=torch.uint8, device=device)
    res["focus_empty_launch_ms"] = ms(lambda: fs.focus_stack(tiny), 200)
    res["int8_up_fused"] = timing.fuses_requant(ic)
    for tag, h, cin, cout in timing.INT8_UP_SHAPES:
        a = timing.int8_up_inputs(ic, rng, 200, h, cin, cout, device)
        res[f"int8_{tag}_ms"] = ms(timing.int8_up_call(ic, tag, a, res["int8_up_fused"]), 10)
        del a
    res["int8_up_ms"] = sum(res[f"int8_{t[0]}_ms"] for t in timing.INT8_UP_SHAPES)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
