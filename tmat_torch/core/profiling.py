"""Per-stage wall-clock accounting and an opt-in device trace.

Counterpart of ``tmat_tpu/core/profiling.py``: ``StageTimer``, and
``maybe_profile``, a ``torch.profiler`` trace of the CPU and the card
written when ``TMAT_TORCH_PROFILE_DIR`` is set (where the JAX package
writes a ``jax.profiler`` trace under ``TMAT_TPU_PROFILE_DIR``).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict

PROFILE_DIR_ENV = "TMAT_TORCH_PROFILE_DIR"


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


@contextmanager
def maybe_profile(label: str = "tmat_torch"):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where there is
    a card) into ``$TMAT_TORCH_PROFILE_DIR/<label>/`` as a Chrome trace
    (``*.pt.trace.json``), and yield the profiler; without the variable,
    do nothing and yield None."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(os.path.join(profile_dir, label))) as prof:
        yield prof
