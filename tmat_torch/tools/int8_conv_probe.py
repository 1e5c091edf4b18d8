"""What each part of the int8 conv's warpgroup form costs, on the card.

    python -m tmat_torch.tools.int8_conv_probe [--batch 200] [--seed 0]

Builds ``csrc/int8_conv.cu`` once as the library and once for each part in
``PARTS`` with ``-DTMAT_INT8_PROBE=<bit>``, which leaves that part out (the
outputs are then wrong), each into a library of its own in the build cache,
and times the mixed segmentor's six up convs at B=200 as its fused forward
launches them (``timing.int8_up_call``) with each library, in turns. Prints
one JSON line: the card, and per library the ms of each conv and their sum;
what a part costs is the full library's time less the time without it. The
probe builds are only read here; the port never loads them. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tmat_torch.ops import int8_conv as ic
from tmat_torch.tools import timing

# the TMAT_INT8_PROBE bit of each part (csrc/int8_conv.cu, namespace wg)
PARTS = {"epilogue_stores": 1, "first_halo": 2, "products": 4, "later_halos": 8, "requantisation": 16}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_probe: needs a CUDA device")
    variants = {"full": (), **{f"without_{name}": (f"TMAT_INT8_PROBE={bit}",) for name, bit in PARTS.items()}}
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each, side by side
        list(pool.map(ic.library_path, variants.values()))
    device = torch.device("cuda")
    rng = np.random.RandomState(args.seed)
    inputs = {tag: timing.int8_up_inputs(ic, rng, args.batch, h, cin, cout, device)
              for tag, h, cin, cout in timing.INT8_UP_SHAPES}
    res = {"card": timing.card_line(), "batch": args.batch}
    for name, defines in variants.items():
        with ic.built_with(*defines):
            row = {tag: timing.cuda_ms(timing.int8_up_call(ic, tag, a), 10) for tag, a in inputs.items()}
            if ic.last_launch() != "wgmma":
                raise SystemExit(f"int8_conv_probe: the up convs took {ic.last_launch()}, not the warpgroup form")
        row["sum"] = sum(row.values())
        res[name] = row
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
