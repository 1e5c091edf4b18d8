"""One run of one cell: find its files by name, set up, measure, check, report.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (the entry's ``file``);
- ``traffic/<traffic>.json``: the mix, whose ``driver`` names the loop in
  ``drivers/<driver>.py`` that drives the program with it, ``inputs`` the
  generator in ``inputs/<inputs>.py`` that makes its inputs from the seed
  (a ``traffic/<traffic>.py`` beside it takes that generator's place), and
  ``reference`` the plain reference in ``reference/<reference>.py`` that
  the check holds the program to;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``, of
  each end-to-end and per-layer metric; a reader that finds nothing to
  read returns None and the metric is left out of the line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tmat_tpu")


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark, imported by its path (metric file
    names hold dots)."""
    name = "perfbench_file_" + "".join(ch if ch.isalnum() else "_" for ch in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or the JAX package, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell's entries and files, found by name."""

    def __init__(self, bench: Dict, name: str, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry, self.base = name, cells[name], base
        self.root = base.parent
        cfg_entry = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = {"name": cfg_entry["name"], **json.loads((self.root / cfg_entry["file"]).read_text())}
        self.traffic = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((base / "limits" / f"{name}.json").read_text())
        self.driver = load_module(base / "drivers" / f"{self.traffic['driver']}.py")
        own = base / "traffic" / f"{self.entry['traffic']}.py"
        self.generator = load_module(own if own.exists() else base / "inputs" / f"{self.traffic['inputs']}.py")
        self.reference = load_module(base / "reference" / f"{self.traffic['reference']}.py")

        def mine(m):
            return name in m["workloads"] if "workloads" in m else True

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        e2e = {m["name"] for m in self.end_to_end}
        # a per-layer metric without a list goes with every cell reporting what it moves
        self.per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in e2e]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.base / "metrics" / f"{metric}.py")


class Run:
    """What a run hands its driver, and what the metric readers read."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, control: str = ""):
        self.cell, self.seed, self.seconds, self.trace, self.device = cell, seed, seconds, trace, device
        self.config, self.traffic, self.root = cell.config, cell.traffic, cell.root
        self.control = control
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench-")
        self.tmpdir = Path(self._tmp.name)
        from perfbench.trace import Tracer, span_timer_class

        self.timer_class = span_timer_class()
        self.timer = self.timer_class()
        self.tracer = Tracer(self.tmpdir)
        self.trace_summary = None
        self.window_s = None
        self.setup_s = None
        self.driver = cell.driver.Driver(self)
        self.t_created = time.perf_counter()

    def new_timer(self):
        return self.timer_class()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, line: str) -> None:
        print(f"[{time.perf_counter() - self.t_created:.1f} s] {line}", file=sys.stderr, flush=True)

    def close(self) -> None:
        self._tmp.cleanup()


def measure(run: Run, t_process: float) -> Dict:
    """Set up, measure the window, check, and give the result line's dict."""
    import torch

    d = run.driver
    before = built_libraries()
    d.setup()
    # a run that builds the program's native libraries pays for it in set-up
    d.counters["libraries_built"] = len(built_libraries() - before)
    run.log(f"set-up done at {time.time() - t_process:.1f} s")
    if run.trace:
        run.tracer.warm(run.device)
    run.sync()
    run.setup_s = time.time() - t_process
    d.window(run.seconds)
    run.sync()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    d.release()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = d.check()
    run.log(f"check took {time.perf_counter() - t0:.1f} s")
    return report(run, numbers, peak)


def built_libraries() -> set:
    """The program's native libraries in its build directory."""
    path = os.environ.get("TMAT_TORCH_BUILD_DIR")
    return set(Path(path).glob("*.so")) if path and Path(path).is_dir() else set()


def report(run: Run, numbers: Dict[str, float], peak: int) -> Dict:
    cell = run.cell
    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = {}
    correct = True
    for name, limit in cell.limits.items():
        value = numbers.get(name)
        ok = value is not None and bool(value <= limit)
        correct &= ok
        check[name] = {"value": value, "limit": limit}
    counters = run.driver.counters
    failed = int(counters.get("failed", 0))
    correct &= failed == 0
    out = {"correct": bool(correct), "attempted": int(counters.get("attempted", 0)), "failed": failed,
           "metrics": metrics, "device": device_info(run, peak)}
    if run.trace and run.trace_summary is not None:
        ts = run.trace_summary
        out["breakdown"] = {"device_ops": ts.device_ops(),
                            "idle_gaps": ts.idle_gaps(run.timer.intervals)}
    out["counts"] = {k: v for k, v in counters.items()}
    out["check"] = check  # last: each number compared beside its limit
    return out


def device_info(run: Run, peak: int) -> Dict:
    import torch

    info = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak), "power_limit": power_limit()}
    if run.trace and run.trace_summary is not None:
        info["busy_s"] = run.trace_summary.busy_s
        info["window_s"] = run.trace_summary.window_s
    return info


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
