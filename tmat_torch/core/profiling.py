"""Per-stage wall-clock accounting, the program's spans and counters, and
an opt-in device trace.

Counterpart of ``tmat_tpu/core/profiling.py``: ``StageTimer``, and
``maybe_profile``, a ``torch.profiler`` trace of the CPU and the card
written when ``TMAT_TORCH_PROFILE_DIR`` is set (where the JAX package
writes a ``jax.profiler`` trace under ``TMAT_TPU_PROFILE_DIR``).

Spans. While a ``torch.profiler`` records on the thread that called a
tool's entry point (``profiler_active``, checked once per plate call or per
stack), the tool runs its work inside ``traced(True, item, parent)``, on
that thread and in the pool tasks it hands the answer to. There every
``StageTimer.stage`` also keeps a ``SpanRecord``: its name, its start and
end on ``time.perf_counter``, the native id of its thread, the span that
caused it, its item (a plate call's sequence number and well id, or a
stack id) and what the thread's counters (``count``) added while it was
open. A ``Span`` is one that a thread opens and another may close. The
records go to a bounded in-memory record (``recorded_spans``), whatever
timer the tool was handed, and ``maybe_profile`` writes those of its block
into the trace it exports. The profiler records no CPU ops of threads it
was not started on, so pool threads' work shows in the trace only this way.

Off (the default), a stage costs what it cost before, with one
thread-local flag read, and allocates no record; ``count`` is an integer
add on a thread-local dict. Nothing here synchronises with the card or
launches on it.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, NamedTuple, Optional

PROFILE_DIR_ENV = "TMAT_TORCH_PROFILE_DIR"
SPAN_RECORD_LEN = 1 << 16  # the newest spans kept; a traced 8-well plate makes 96
SPAN_ANCHOR = "tmat_torch.spans"  # the record_function that ties spans to a trace's clock


class SpanRecord(NamedTuple):
    name: str
    start: float  # time.perf_counter()
    end: float
    thread: int  # threading.get_native_id() of the thread that opened it
    parent: Optional[int]  # the id of the span that caused it
    item: Optional[str]
    id: int
    counts: Optional[Dict[str, int]]  # its thread's counter increments while it was open


class _ThreadState(threading.local):
    def __init__(self):
        self.on = False
        self.item: Optional[str] = None
        self.parent: Optional[int] = None
        self.counts: Dict[str, int] = {}


_state = _ThreadState()
_span_ids = itertools.count(1)
_record: Deque[SpanRecord] = deque(maxlen=SPAN_RECORD_LEN)
_record_lock = threading.Lock()


def _keep(rec: SpanRecord) -> None:
    with _record_lock:
        _record.append(rec)


def recorded_spans() -> List[SpanRecord]:
    """The record's spans, oldest first (at most ``SPAN_RECORD_LEN``)."""
    with _record_lock:
        return list(_record)


def clear_spans() -> None:
    with _record_lock:
        _record.clear()


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` records on the calling thread."""
    import torch

    return torch.autograd._profiler_enabled()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the calling thread's counter ``name``; the spans open on
    the thread while it grows record the increment."""
    c = _state.counts
    c[name] = c.get(name, 0) + n


@contextmanager
def traced(on: bool, item: Optional[str] = None, parent: Optional[int] = None):
    """Within the block, this thread's stages are spans of ``item`` caused
    by ``parent`` if ``on``, and nothing is recorded if not."""
    st = _state
    saved = st.on, st.item, st.parent
    st.on, st.item, st.parent = on, item, parent
    try:
        yield
    finally:
        st.on, st.item, st.parent = saved


class Span:
    """A span opened now on this thread, and recorded by ``close`` from
    any thread (the plate's ``well``, from its producer to its host tail)."""

    __slots__ = ("name", "item", "parent", "id", "thread", "start")

    def __init__(self, name: str, item: Optional[str] = None, parent: Optional[int] = None):
        self.name, self.item, self.parent = name, item, parent
        self.id = next(_span_ids)
        self.thread = threading.get_native_id()
        self.start = time.perf_counter()

    def close(self) -> None:
        _keep(SpanRecord(self.name, self.start, time.perf_counter(), self.thread, self.parent,
                         self.item, self.id, None))


class StageTimer:
    """Accumulates wall-clock per named pipeline stage; inside
    ``traced(True, ...)`` each stage is also a span (module doc).

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
        st = _state
        on = st.on
        if on:
            sid, parent, counts0 = next(_span_ids), st.parent, dict(st.counts)
            st.parent = sid
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + end - start
                self.counts[name] = self.counts.get(name, 0) + 1
            if on:
                st.parent = parent
                added = {k: v - counts0.get(k, 0) for k, v in st.counts.items() if v != counts0.get(k, 0)}
                _keep(SpanRecord(name, start, end, threading.get_native_id(), parent, st.item, sid,
                                 added or None))

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"  {name}: {total:.3f}s total / {n} calls "
                         f"({total / n * 1000:.1f} ms avg)")
        return "\n".join(lines)


def add_spans_to_trace(path: str, t_anchor: float) -> int:
    """Add the spans recorded since ``t_anchor`` (the ``perf_counter`` at
    which the ``SPAN_ANCHOR`` annotation opened) to the Chrome trace at
    ``path``, on its clock, as complete events of category ``tmat_span``
    on their threads; returns how many. The anchor is the trace's last
    ``SPAN_ANCHOR`` annotation; a trace without one is left as it is."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    anchors = [e for e in events if e.get("name") == SPAN_ANCHOR and "ts" in e]
    if not anchors:
        return 0
    anchor = max(anchors, key=lambda e: float(e["ts"]))
    ts0, pid = float(anchor["ts"]), anchor.get("pid", os.getpid())
    added = [{"ph": "X", "cat": "tmat_span", "name": s.name, "pid": pid, "tid": s.thread,
              "ts": ts0 + (s.start - t_anchor) * 1e6, "dur": (s.end - s.start) * 1e6,
              "args": {"item": s.item, "id": s.id, "parent": s.parent, **(s.counts or {})}}
             for s in recorded_spans() if s.start >= t_anchor]
    events.extend(added)
    trace["traceEvents"] = events
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(added)


@contextmanager
def maybe_profile(label: str = "tmat_torch"):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA where there is
    a card) into ``$TMAT_TORCH_PROFILE_DIR/<label>/`` as a Chrome trace
    (``*.pt.trace.json``) that also holds the program's spans of the block
    (``add_spans_to_trace``), and yield the profiler; without the
    variable, do nothing and yield None."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(profile_dir, label)
    prof = profile(activities=activities)
    prof.start()
    try:
        with record_function(SPAN_ANCHOR):  # the first annotation pays the profiler's set-up
            pass
        t_anchor = time.perf_counter()
        with record_function(SPAN_ANCHOR):
            pass
        yield prof
    finally:
        prof.stop()
        os.makedirs(out, exist_ok=True)
        # tensorboard_trace_handler's file name
        path = os.path.join(out, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        add_spans_to_trace(path, t_anchor)
