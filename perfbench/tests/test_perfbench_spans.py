"""``spans.py`` and the readers of the program's spans and counters, on a
trace made by hand and a span record put in the program's place."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import spans as sp
from perfbench.harness import load_module
from perfbench.trace import MARKER, TraceSummary
from tmat_torch.core import profiling
from tmat_torch.core.profiling import SpanRecord

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PERF0 = 10.0  # perf_counter at the traced part's start; its marker launched at ts 1000 µs


def _ev(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
            "args": {"correlation": corr}}


def _trace(markers=True):
    ev = [_ev("kernel", "k1", 1010, 10, corr=1), _ev("gpu_memcpy", "Memcpy DtoH", 1030, 5, corr=2),
          _ev("kernel", "k2", 1080, 10, corr=3), _ev("cpu_op", "aten::add", 0, 5000)]
    if markers:
        ev += [_ev("cuda_runtime", "cudaLaunchKernel", 1000, 1, corr=100),
               _ev("kernel", f"void at::cuda::{MARKER}(long)", 1002, 1, corr=100)]
    return TraceSummary(ev, t0=PERF0, t1=PERF0 + 200e-6)


def _at(us):
    """The perf_counter instant that maps to trace time ``us``."""
    return PERF0 + (us - 1000) / 1e6


def _span(sid, name, a_us, b_us, parent=None, item=None, counts=None):
    return SpanRecord(name, _at(a_us), _at(b_us), 7, parent, item, sid, counts)


STAGE1 = {"gmm_iters": 12, "skeleton_passes": 6, "host_copies": 3}
PLATE = [
    _span(1, "device_stage1", -500, -400, counts=STAGE1),  # before the traced part: left out
    _span(2, "well", 1001, 1150, item="3/A01"),
    _span(3, "device_lock_wait", 1001, 1005, 2, "3/A01"),
    _span(4, "device_stage1", 1005, 1040, 2, "3/A01", STAGE1),  # busy 10 + 5 of 35 µs
    _span(5, "well", 1001, 1190, item="3/B01"),
    _span(6, "device_lock_wait", 1001, 1050, 5, "3/B01"),
    _span(7, "device_stage1", 1050, 1100, 5, "3/B01", dict(STAGE1, gmm_iters=30)),  # busy 10 of 50
    _span(8, "device_lock_wait", 1100, 1110, 5, "3/B01"),
]
INV = [
    _span(1, "host_resize", 1000, 1060, item="S8"),
    _span(2, "host_resize", 1001, 1059, 1, "S8"),  # the harness's own span inside the program's
    _span(3, "dispatch", 1060, 1070, item="S8"),
    _span(4, "host_resize", 1070, 1150, item="S9"),
    _span(5, "host_resize", 1071, 1149, 4, "S9"),
    _span(6, "dispatch", 1150, 1164, item="S9"),
    _span(7, "fetch_wait", 1164, 1167, item="S1"),
    _span(8, "fetch_wait", 1300, 1310, item="S2"),  # after the traced part: left out
]


def _run(kind, records, monkeypatch, markers=True):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(records))
    return SimpleNamespace(trace_summary=_trace(markers), driver=SimpleNamespace(kind=kind))


def _read(name, run):
    return load_module(METRICS / f"{name}.py").read(run)


def test_spans_map_onto_the_trace(monkeypatch):
    run = _run("plate", PLATE, monkeypatch)
    ts = run.trace_summary
    spans = sp.traced_spans(run)
    assert [s.id for s in spans] == [2, 3, 4, 5, 6, 7, 8]
    assert sp.to_trace_us(ts, _at(1234.5)) == pytest.approx(1234.5)
    assert sp.busy_intervals(ts) == [(1010, 1020), (1030, 1035), (1080, 1090)]
    stage1 = sp.named(spans, "device_stage1")
    assert sp.idle_s(ts, stage1) == pytest.approx((20 + 40) / 1e6)
    assert sp.idle_s(ts, [_span(9, "x", 1012, 1018)]) == pytest.approx(0, abs=1e-12)
    assert sp.idle_at_start(ts, stage1 + [_span(9, "x", 1015, 1016)]) == [True, True, False]
    assert sp.counted(stage1, "gmm_iters", "host_copies") == 12 + 3 + 30 + 3
    assert sp.host_s(sp.named(spans, "device_lock_wait")) == pytest.approx(63 / 1e6)
    inv = sp.named(sp.traced_spans(_run("inv_depth", INV, monkeypatch)), "host_resize")
    assert [s.id for s in inv] == [1, 4]


def test_plate_readers(monkeypatch):
    run = _run("plate", PLATE, monkeypatch)
    assert _read("stage1_idle_ms.plate", run) == pytest.approx(60 / 2 / 1e3)
    assert _read("stage1_syncs.plate", run) == (21 + 39) / 2
    assert _read("lock_wait_ms.plate", run) == pytest.approx(63 / 2 / 1e3)
    assert _read("well_ms.plate", run) == pytest.approx((149 + 189) / 2 / 1e3)
    for name in ("resize_ms.inv_depth", "dispatch_ms.inv_depth", "fetch_wait_ms.inv_depth"):
        assert _read(name, run) is None


def test_inv_depth_readers(monkeypatch):
    run = _run("inv_depth", INV, monkeypatch)
    assert _read("resize_ms.inv_depth", run) == pytest.approx((60 + 80) / 2 / 1e3)
    assert _read("dispatch_ms.inv_depth", run) == pytest.approx((10 + 14) / 2 / 1e3)
    assert _read("fetch_wait_ms.inv_depth", run) == pytest.approx(3 / 1e3)
    assert _read("well_ms.plate", run) is None


NEW = ("stage1_idle_ms.plate", "stage1_syncs.plate", "lock_wait_ms.plate", "well_ms.plate",
       "resize_ms.inv_depth", "dispatch_ms.inv_depth", "fetch_wait_ms.inv_depth")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(monkeypatch, name):
    kind = "plate" if name.endswith(".plate") else "inv_depth"
    run = _run(kind, PLATE if kind == "plate" else INV, monkeypatch)
    run.trace_summary = None  # an untraced run
    assert _read(name, run) is None
    run = _run(kind, [], monkeypatch)  # traced, but nothing recorded
    assert _read(name, run) is None
    # a program without the record (a parent commit): no reading, no error
    monkeypatch.delattr(profiling, "recorded_spans")
    assert _read(name, SimpleNamespace(trace_summary=_trace(), driver=SimpleNamespace(kind=kind))) is None


def test_no_marker_no_idle(monkeypatch):
    """Without a card there is no marker to tie the clocks: no idle reading."""
    run = _run("plate", PLATE, monkeypatch, markers=False)
    assert _read("stage1_idle_ms.plate", run) is None
    assert _read("stage1_syncs.plate", run) is not None


def test_fs_well_readers():
    """focus_stack_roofline from kernel names in a trace made by hand, and
    well_mask_ms.plate from the program's stage totals."""
    import numpy as np

    from perfbench.work import focus_work

    ev = [_ev("kernel", "void focus_stack_kernel<unsigned char>(unsigned char const*, int const*)", 1010, 40,
              corr=1),
          _ev("kernel", "void focus_stack_kernel<unsigned char>(unsigned char const*, int const*)", 1100, 60,
              corr=2),
          _ev("kernel", "k2", 1200, 500, corr=3)]
    traffic = {"size": 1024, "z": 8, "wells_per_plate": 2, "trace_plates": [2, 3],
               "run_plate": {"proj_method": "fs", "z_counts": [8, 5]}}
    driver = SimpleNamespace(kind="plate", counters={"plates": 4, "wells": 8}, plates=[np.zeros(1, np.uint8)])
    run = SimpleNamespace(trace_summary=TraceSummary(ev, PERF0, PERF0 + 1e-3), traffic=traffic, driver=driver,
                          timer=SimpleNamespace(totals={"well_mask": 0.2}, total=lambda *n: 0.2))
    bound = 2 * (focus_work([8], 1024, 1024, 1)["bound_s"] + focus_work([5], 1024, 1024, 1)["bound_s"])
    assert _read("focus_stack_roofline", run) == pytest.approx(bound / 100e-6 * 100)  # plates 2 and 3
    assert _read("well_mask_ms.plate", run) == pytest.approx(0.2 / 8 * 1e3)
    traffic["run_plate"]["proj_method"] = "max"  # no focus stacking: nothing to read
    assert _read("focus_stack_roofline", run) is None
    run.timer.totals = {}  # no well mask fitted
    assert _read("well_mask_ms.plate", run) is None
    traffic["run_plate"]["proj_method"] = "fs"
    run.trace_summary = TraceSummary(ev[2:], PERF0, PERF0 + 1e-3)  # no kernel launched
    assert _read("focus_stack_roofline", run) is None
