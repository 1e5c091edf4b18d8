"""Benchmark of ``tmat_torch`` on CUDA cards: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (``harness.py`` finds its configuration, traffic, driver,
limits and metric readers by name), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last ``check``,
each number compared beside its limit (also the last lines on standard
error). It exits non-zero and prints no result without a CUDA card, with
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded.

Caches stay inside the checkout: the program's native builds under
``perfbench/.cache/build`` (``TMAT_TORCH_BUILD_DIR``; ``counts.
libraries_built`` says how many a run built); the program's base dir is an empty
``perfbench/.cache/base`` (``TMAT_TPU_BASE_DIR``), so no user
``package.cfg`` or model redirects it. Temporary files go under ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def environment() -> None:
    """Fixed cache and base directories inside the checkout, set before the
    program is imported (its defs read the base dir at import)."""
    cache = HERE / ".cache"
    os.environ["TMAT_TORCH_BUILD_DIR"] = str(cache / "build")
    os.environ["TMAT_TPU_BASE_DIR"] = str(cache / "base")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    (cache / "base").mkdir(parents=True, exist_ok=True)


def main(argv=None) -> int:
    t_process = process_start()
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    environment()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card: nothing is measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"perfbench: {cell.name} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    try:
        result = harness.measure(run, t_process)
    finally:
        run.close()
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
