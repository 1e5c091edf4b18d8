"""Spans and the device trace of a traced run.

``SpanTimer`` is the program's ``StageTimer`` (handed to it as ``timer=``)
that also keeps each stage's start and end, and the harness's own
spans, so that idle gaps of the card can be labelled with what the host
was doing. ``Tracer`` runs ``torch.profiler`` (CPU and CUDA) over a part
of the window and reduces its Chrome trace to what the metric readers
need: the device's busy intervals (kernels, copies and sets, as
``chip_smoke.py::phase_profile`` counted them), kernel time by name, the
device time of the kernels launched inside each harness span, and the
idle gaps.

The program launches from pool threads, whose CPU ops the profiler does
not record (it records those of the thread that started it), so a span is
delimited in the trace by marker kernels: ``torch.cuda._sleep(0)`` (an
empty ``spin_kernel``) at its start and its end, on the stream the program
uses. The program issues all its device work from under one lock onto that
one in-order stream, so the device operations that run between a span's
two markers are exactly those launched inside it; they are found by their
place on the device's timeline, never by their names. A marker is
launched when the traced part starts, before any other work; the trace
at times lacks that first kernel's record (CUPTI), so the spans' markers
are counted from the end, and the trace's clock is tied to the host's at
the first kernel launch it records (that marker's, or the first after it).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from perfbench.work import union_s

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep


def marker(device) -> None:
    """An empty kernel launch that delimits spans in the trace."""
    import torch

    if device is not None and device.type == "cuda":
        torch.cuda._sleep(0)


def span_timer_class():
    """``SpanTimer``, built on the program's ``StageTimer`` when first asked for."""
    from tmat_torch.core.profiling import StageTimer

    class SpanTimer(StageTimer):
        """``StageTimer`` that also keeps (name, start, end) of each stage."""

        def __init__(self):
            super().__init__()
            self.intervals: List[Tuple[str, float, float]] = []

        @contextmanager
        def stage(self, name: str):
            start = time.perf_counter()
            try:
                with super().stage(name):
                    yield
            finally:
                with self._lock:
                    self.intervals.append((name, start, time.perf_counter()))

        def total(self, *names: str) -> float:
            return sum(self.totals.get(n, 0.0) for n in names)

    return SpanTimer


class Tracer:
    """``torch.profiler`` over the part of a window between ``start`` and ``stop``."""

    def __init__(self, tmpdir: Path):
        self.tmpdir = Path(tmpdir)
        self.active = False
        self.device = None
        self._prof = None
        self.t0 = self.t1 = None

    def mark(self) -> None:
        """Launch a marker kernel (see the module doc)."""
        marker(self.device)

    def warm(self, device) -> None:
        """Start the profiler once on a trivial op, so that its first start
        (CUPTI's initialisation) falls in set-up and not in the window."""
        import torch

        with self._profile() as prof:
            torch.ones(8, device=device).sum().item()
        del prof

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        return profile(activities=acts)

    def start(self, device) -> None:
        self._prof = self._profile()
        self._prof.start()
        self.device = device
        self.t0 = time.perf_counter()
        self.mark()
        self.active = True

    def stop(self) -> "TraceSummary":
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.active = False
        self._prof.stop()
        path = self.tmpdir / f"trace-{os.getpid()}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            path.unlink(missing_ok=True)
        return TraceSummary(events, self.t0, self.t1)


class TraceSummary:
    """What the metric readers take from one traced part of a window."""

    def __init__(self, events: List[dict], t0: float, t1: float):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
        self.window_s = t1 - t0

        def iv(e):
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])

        def corr(e):
            return (e.get("args") or {}).get("correlation")

        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        markers = {corr(e) for e in dev if MARKER in e.get("name", "")}
        # (start, end) of each marker kernel, and (start, end, name,
        # correlation) of each other device operation, in device order
        self.markers = sorted(iv(e) for e in dev if corr(e) in markers)
        self.device = sorted((*iv(e), e.get("name", ""), corr(e)) for e in dev if corr(e) not in markers)
        self.busy_s = union_s((a, b) for a, b, _, _ in self.device) / 1e6
        launches = [iv(e)[0] for e in xs if e.get("cat") in LAUNCH_CATS and "LaunchKernel" in e.get("name", "")]
        # the trace's clock at the window's start (the first kernel launch:
        # its marker's), against perf_counter; untied without one (no card)
        self.tied = bool(launches)
        self.ts0 = min(launches, default=min((iv(e)[0] for e in xs), default=0.0))
        self.perf0 = t0

    def span_device_s(self, kinds: List[str], kind: str) -> Optional[float]:
        """Device seconds of the operations run inside the spans of
        ``kind``, where ``kinds`` lists every span of the traced part in the
        order they were opened (a span's markers are the (2i+1)-th and
        (2i+2)-th of the last 2 x len(kinds), whether the window's own is
        in the trace or not). None when the trace lacks a span's marker."""
        n = 2 * len(kinds)
        if len(self.markers) not in (n, n + 1):
            return None
        marks = self.markers[len(self.markers) - n:]
        total = 0.0
        for i, k in enumerate(kinds):
            if k != kind:
                continue
            a, b = marks[2 * i][1], marks[2 * i + 1][0]
            total += sum(min(e, b) - max(s, a) for s, e, _, _ in self.device if s < b and e > a)
        return total / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        by_name: Dict[str, float] = {}
        for a, b, name, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, intervals, top: int = 10) -> List[list]:
        """The longest idle gaps of the card inside the window: [label,
        seconds], labelled with the host stages open at the gap's middle
        (``intervals`` of a ``SpanTimer``, innermost first), else "none"."""
        lo, hi = self.ts0, self.ts0 + self.window_s * 1e6
        busy = sorted((max(a, lo), min(b, hi)) for a, b, _, _ in self.device if b > lo and a < hi)
        gaps, end = [], lo
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = self.perf0 + ((a + b) / 2 - self.ts0) / 1e6
            open_ = sorted((e - s, n) for n, s, e in intervals if s <= mid <= e)
            label = "+".join(dict.fromkeys(n for _, n in open_)) or "none"
            out.append([label, (b - a) / 1e6])
        return out
