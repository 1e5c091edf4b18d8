"""Readings that the check's limits are set from, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        --seconds <s> [--first-seed N] [--out FILE] \
        [--fault NAME='{"z_counts": null}' ... --fault-seeds 3]

For each of ``--seeds`` seeds, a run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds`` at the cell's own load, the check), and
for each of ``--control-seeds`` further seeds the same with the control in
the program's place: one precision below the configuration's (the drivers'
``check`` says what the control is for each cell). Prints one JSON line per
run with the numbers the check compares, and a summary of the largest
reading of the program and the smallest of the control for each number.
Each ``--fault`` adds ``--fault-seeds`` runs with a fault planted in the
timed path: a plate cell's ``run_plate`` called with the given arguments
changed (null drops one), as the CPU tests plant it at a tiny size. The
benchmark's own runs never run the control or a fault. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from perfbench.run import environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", action="append", default=[], metavar="NAME=JSON")
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    environment()
    import torch
    from perfbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)
    dev = torch.device("cuda", 0)
    faults = dict(f.split("=", 1) for f in args.fault)
    readings = {"program": [], "control": [], **{name: [] for name in faults}}
    plan = [("program", args.first_seed + 7919 * i) for i in range(args.seeds)]
    plan += [("control", args.first_seed + 7919 * (args.seeds + i)) for i in range(args.control_seeds)]
    n = args.seeds + args.control_seeds
    for name in faults:
        plan += [(name, args.first_seed + 7919 * (n + i)) for i in range(args.fault_seeds)]
        n += args.fault_seeds
    out = open(args.out, "a") if args.out else None
    for kind, seed in plan:
        run = harness.Run(cell, seed, args.seconds, False, dev, control="control" if kind == "control" else "")
        t0 = time.perf_counter()
        try:
            d = run.driver
            d.setup()
            if kind in faults:
                changed_call(d, json.loads(faults[kind]))
            d.window(args.seconds)
            run.sync()
            d.release()
            torch.cuda.empty_cache()
            numbers = d.check()
        finally:
            run.close()
        line = {"kind": kind, "seed": seed, "numbers": numbers, "counts": d.counters,
                "seconds": time.perf_counter() - t0}
        readings[kind].append(numbers)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run, d
        torch.cuda.empty_cache()
    keys = sorted({k for runs in readings.values() for r in runs for k in r})
    summary = {k: {"program_max": max((r[k] for r in readings["program"] if k in r), default=None),
                   **{f"{kind}_min": min((r[k] for r in readings[kind] if k in r), default=None)
                      for kind in readings if kind != "program"}}
               for k in keys}
    print(json.dumps({"summary": summary, "limits_now": cell.limits}), flush=True)
    if out:
        out.write(json.dumps({"summary": summary}) + "\n")
        out.close()
    return 0


def changed_call(driver, changes) -> None:
    """A fault: the driver's ``run_plate`` called with ``changes`` made to
    its keyword arguments (a None drops the argument)."""
    call = driver.run_plate

    def changed(*a, **k):
        for key, value in changes.items():
            if value is None:
                k.pop(key, None)
            else:
                k[key] = value
        return call(*a, **k)

    driver.run_plate = changed


if __name__ == "__main__":
    sys.exit(main())
