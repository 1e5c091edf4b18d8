"""Per-stage wall-clock accounting (``tmat_tpu/core/profiling.py::StageTimer``)."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


class StageTimer:
    """Accumulates wall-clock per named pipeline stage.

    Thread-safe: the plate pipeline runs host tails in pool threads, so
    totals of overlapping stages can exceed the pipeline's wall-clock;
    they are per-stage work accounting, not a partition of elapsed time.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + elapsed
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name}: {total:.3f}s total / {n} calls "
                         f"({total / n * 1000:.1f} ms avg)")
        return "\n".join(lines)
