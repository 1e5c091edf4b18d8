"""The reduction of a profiler trace (``trace.TraceSummary``) on a trace
made by hand: busy time, spans between marker kernels, idle gaps."""

from perfbench.trace import MARKER, TraceSummary


def _ev(cat, name, ts, dur, corr=None, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {"correlation": corr}}


def _trace():
    ev = []
    # the window's marker, then two spans (a down block and something else)
    marks = [(0, 1), (10, 1), (23, 1), (40, 1), (60, 1)]
    for i, (ts, dur) in enumerate(marks):
        ev.append(_ev("cuda_runtime", "cudaLaunchKernel", ts - 5 + 1000, 1, corr=100 + i))
        ev.append(_ev("kernel", f"void at::cuda::{MARKER}(long)", ts, dur, corr=100 + i))
    ev.append(_ev("kernel", "down_block_kernel", 12, 10, corr=1))   # inside span 0
    ev.append(_ev("kernel", "other", 25, 3, corr=2))                # between the spans
    ev.append(_ev("gpu_memcpy", "Memcpy", 45, 5, corr=3))           # inside span 1
    ev.append(_ev("cpu_op", "aten::add", 0, 100))                   # host work: not the device's
    return ev


def test_spans_busy_and_gaps():
    ts = TraceSummary(_trace(), t0=0.0, t1=100e-6)
    assert ts.busy_s == (10 + 3 + 5) / 1e6
    assert ts.span_device_s(["down_block", "focus_stack"], "down_block") == 10 / 1e6
    assert ts.span_device_s(["down_block", "focus_stack"], "focus_stack") == 5 / 1e6
    # a marker missing from the trace: no reading rather than a wrong one
    assert ts.span_device_s(["down_block"], "down_block") is None
    assert [n for n, _ in ts.device_ops()] == ["down_block_kernel", "Memcpy", "other"]
    gaps = ts.idle_gaps([("morse_graphs", -1.0, 1.0)])
    assert gaps[0][0] == "morse_graphs" and len(gaps) <= 10


def test_the_window_marker_lost_from_the_trace():
    """The window's own marker, the first kernel after the profiler starts,
    is at times missing from the trace: the spans' markers are counted from
    the end, and the clocks are tied at the first launch the trace has."""
    full = TraceSummary(_trace(), t0=0.0, t1=100e-6)
    ev = [e for e in _trace() if not (e["cat"] == "kernel" and e["args"]["correlation"] == 100)]
    ts = TraceSummary(ev, t0=0.0, t1=100e-6)
    assert len(ts.markers) == 4 and ts.tied and ts.ts0 == full.ts0
    assert ts.span_device_s(["down_block", "focus_stack"], "down_block") == 10 / 1e6
    assert ts.span_device_s(["down_block", "focus_stack"], "focus_stack") == 5 / 1e6
    # its launch gone too: tied at the next launch
    ev = [e for e in ev if e["args"]["correlation"] != 100]
    assert TraceSummary(ev, t0=0.0, t1=100e-6).ts0 == full.ts0 + 10
