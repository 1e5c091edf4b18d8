"""The program's own spans and counters in the traced part of a window, on
the device trace's clock.

While a ``torch.profiler`` records on the thread that called its entry
point (in a ``--trace 1`` run, the traced plates and stacks), the program
keeps a record of spans (``tmat_torch/core/profiling.py``): each with its
name, start and end on ``time.perf_counter``, thread, the span that caused
it, its item (a plate call's sequence number and well id, or a stack id)
and the counters its thread added while it was open. ``TraceSummary`` ties
the trace's clock to ``perf_counter`` through its first kernel launch (its marker's)
(``ts0`` at ``perf0``), so an instant ``t`` lies at ``ts0 + (t - perf0) *
1e6`` on the device's timeline, and the card's busy and idle time inside a
span comes from ``TraceSummary.device``. A program without the record (a
parent commit) gives nothing: ``traced_spans`` returns None and the
readers leave their metric out.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple


def traced_spans(run) -> Optional[list]:
    """The program's spans that start inside the traced part of the window,
    oldest first; None without a trace or without the program's record."""
    ts = run.trace_summary
    if ts is None:
        return None
    try:
        from tmat_torch.core import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded_spans", None)
    if recorded is None:
        return None
    lo, hi = ts.perf0, ts.perf0 + ts.window_s
    return [s for s in recorded() if lo <= s.start <= hi]


def named(spans: Iterable, name: str) -> list:
    """The spans called ``name``, leaving out one opened directly inside a
    span of the same name (a caller's own timer around a call that the
    program spans too)."""
    spans = list(spans)
    ids = {s.id for s in spans if s.name == name}
    return [s for s in spans if s.name == name and s.parent not in ids]


def host_s(spans: Iterable) -> float:
    """The spans' summed host time, seconds."""
    return sum(s.end - s.start for s in spans)


def counted(spans: Iterable, *counters: str) -> int:
    """The spans' summed increments of ``counters``."""
    return sum((s.counts or {}).get(c, 0) for s in spans for c in counters)


def to_trace_us(ts, t: float) -> float:
    """``perf_counter`` instant ``t`` on the trace's clock (µs)."""
    return ts.ts0 + (t - ts.perf0) * 1e6


def busy_intervals(ts) -> List[Tuple[float, float]]:
    """The union of the card's operations (kernels, copies, sets) as
    disjoint, sorted (start, end) intervals on the trace's clock (µs)."""
    out: List[Tuple[float, float]] = []
    for a, b, _, _ in ts.device:  # sorted by start
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _busy_us(busy: List[Tuple[float, float]], starts: List[float], a: float, b: float) -> float:
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < b:
        total += max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
        i += 1
    return total


def idle_s(ts, spans: Iterable) -> Optional[float]:
    """Seconds inside the spans in which no operation ran on the card;
    None without a launch to tie the clocks (no card)."""
    if not ts.tied:
        return None
    busy = busy_intervals(ts)
    starts = [a for a, _ in busy]
    total = 0.0
    for s in spans:
        a, b = to_trace_us(ts, s.start), to_trace_us(ts, s.end)
        total += (b - a) - _busy_us(busy, starts, a, b)
    return total / 1e6


def idle_at_start(ts, spans: Iterable) -> Optional[List[bool]]:
    """For each span, whether the card was idle at its mapped start (a
    check of the tie: a stage that starts on a drained stream starts idle);
    None without a launch to tie the clocks."""
    if not ts.tied:
        return None
    busy = busy_intervals(ts)
    starts = [a for a, _ in busy]
    out = []
    for s in spans:
        a = to_trace_us(ts, s.start)
        i = bisect.bisect_right(starts, a) - 1
        out.append(i < 0 or busy[i][1] <= a)
    return out
