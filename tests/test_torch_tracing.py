"""The port's spans and counters (``tmat_torch/core/profiling.py``).

Spans are kept only while a ``torch.profiler`` records on the thread that
called the tool's entry point; a tiny 3-well plate and a tiny invasion
ensemble show their names, parents, threads and items; the counters
``gmm_iters`` and ``skeleton_passes`` against independent counts of the
loops they count; ``predict_rows`` with a timer never synchronises; the
spans' clock is ``time.perf_counter`` and ``maybe_profile`` writes them
into its trace on the trace's clock. All on the CPU, a few seconds.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tmat_torch.core import profiling
from tmat_torch.core.profiling import (
    PROFILE_DIR_ENV, StageTimer, clear_spans, maybe_profile, profiler_active, recorded_spans, traced)
from tmat_torch.models.layers import flax_variables
from tmat_torch.models.params_io import save_params
from tmat_torch.models.resnet import build_resnet50_tl
from tmat_torch.models.unet import UNetXceptionPatchSegmentor, build_unet_xception
from tmat_torch.ops import morphology, threshold
from tmat_torch.tools import compute_inv_depth as inv
from tmat_torch.tools import plate_pipeline as tpp

WELLS = ["W0", "W1", "W2"]
WELL_CHILDREN = ["device_lock_wait", "device_stage1", "post_filter", "device_lock_wait",
                 "post_stage2", "morse_graphs"]
STAGE1_PARTS = ["resize", "threshold", "segment", "median_skeleton", "to_host"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_record():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture(scope="module")
def plate_setup(tmp_path_factory):
    """A 3-well 64x64 plate (rings and a bar), a seeded 8-16 segmentor and
    its checkpoint."""
    ckpt = tmp_path_factory.mktemp("tracing") / "unet.msgpack"
    save_params(ckpt, flax_variables(build_unet_xception(1, (32, 32), 1, (8, 16), seed=7, device="cpu")))
    seg = UNetXceptionPatchSegmentor(32, ckpt, (8, 16), ds_ratio=0.5, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    rr, cc = np.mgrid[0:64, 0:64]
    plate = rng.rand(3, 2, 64, 64).astype(np.float32) * 10
    for i in range(3):
        plate[i, 1][np.abs(np.hypot(rr - 32, cc - 32) - (12 + 6 * i)) < 3] += 180
        plate[i, 1, 30:34, 8:-8] += 150
    return np.clip(plate, 0, 255).astype(np.uint8), seg, ckpt


def _run_plate(plate_setup):
    plate, seg, _ = plate_setup
    out = tpp.run_plate(plate, WELLS, seg, {"image_width_microns": 800.0}, device="cpu")
    out.pop("_timer")
    return out


def test_spans_only_while_a_profiler_records_on_the_calling_thread(plate_setup):
    assert not profiler_active()
    with traced(profiler_active(), "a"), StageTimer().stage("x"):
        pass
    plain = _run_plate(plate_setup)
    assert recorded_spans() == []
    seen = {}
    with _cpu_profile():
        assert profiler_active()
        t = threading.Thread(target=lambda: seen.setdefault("pool", profiler_active()))
        t.start()
        t.join(timeout=10)
        with traced(profiler_active(), "a"), StageTimer().stage("x"):
            pass
        traced_out = _run_plate(plate_setup)
    assert not t.is_alive() and seen == {"pool": False}  # hence the check on the calling thread
    names = [s.name for s in recorded_spans()]
    assert names[0] == "x" and names.count("well") == 3
    assert traced_out == plain
    n = len(names)
    _run_plate(plate_setup)  # the profiler stopped: nothing more
    assert len(recorded_spans()) == n


def test_plate_spans_parents_threads_and_items(plate_setup):
    with _cpu_profile():
        _run_plate(plate_setup)
        _run_plate(plate_setup)
    spans = recorded_spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    wells = [s for s in spans if s.name == "well"]
    assert len(wells) == 6
    seqs = sorted({int(w.item.split("/")[0]) for w in wells})
    assert len(seqs) == 2 and seqs[1] == seqs[0] + 1
    main = threading.get_native_id()
    for w in wells:
        seq, wid = w.item.split("/")
        assert wid in WELLS and w.parent is None and w.counts is None
        children = sorted((s for s in spans if s.parent == w.id), key=lambda s: s.start)
        assert [s.name for s in children] == WELL_CHILDREN
        assert {s.item for s in children} == {w.item}
        # opened by the producer, its stages run on one pool thread
        pool = {s.thread for s in children}
        assert len(pool) == 1 and w.thread not in pool | {main}
        assert w.start <= children[0].start and children[-1].end <= w.end
        stage1 = children[1]
        parts = sorted((s for s in spans if s.parent == stage1.id), key=lambda s: s.start)
        assert [s.name for s in parts] == STAGE1_PARTS
        assert all(stage1.start <= p.start <= p.end <= stage1.end for p in parts)
        assert all(p.thread in pool and p.item == w.item for p in parts)
        counts = stage1.counts
        assert counts["host_copies"] == 3 and counts["gmm_iters"] >= 2 and counts["skeleton_passes"] >= 1
        assert {p.name: p.counts for p in parts if p.counts} == {
            "threshold": {"gmm_iters": counts["gmm_iters"]},
            "median_skeleton": {"skeleton_passes": counts["skeleton_passes"]},
            "to_host": {"host_copies": 3}}
        # the lock waits lie outside the stages they wait for
        assert children[0].end <= stage1.start and children[3].end <= children[4].start


def _counted(fn):
    """``fn()`` inside a recorded span: its counters' increments."""
    with traced(True, "t"), StageTimer().stage("counted"):
        fn()
    (rec,) = recorded_spans()
    clear_spans()
    return rec.counts or {}


@pytest.mark.parametrize("n_iter", [100, 3])
def test_gmm_iters_counts_each_em_sync(monkeypatch, n_iter):
    rng = np.random.RandomState(3)
    pixels = torch.from_numpy(np.stack([
        np.concatenate([rng.normal(40, 9, 3000), rng.normal(150, 30, 1000)]),
        np.concatenate([rng.normal(20, 3, 2000), rng.normal(90, 20, 2000)]),
    ]).astype(np.float32))
    iterations = []  # one logsumexp per EM iteration
    logsumexp = torch.logsumexp
    monkeypatch.setattr(threshold.torch, "logsumexp", lambda *a, **k: iterations.append(1) or logsumexp(*a, **k))
    counts = _counted(lambda: threshold.gmm2_fit(pixels, n_iter=n_iter))
    em = len(iterations)
    if n_iter == 3:
        assert em == 3 and counts == {"gmm_iters": 3}  # the cap: no sync after the last
    else:
        assert 3 < em < n_iter and counts == {"gmm_iters": em + 1}  # the last sync ends it


def _plain_passes(mask: torch.Tensor) -> int:
    """Zhang-Suen passes of one mask until a pass changes nothing."""
    x, passes = (mask > 0).to(torch.uint8)[None], 0
    while True:
        passes += 1
        x2 = morphology._zhang_suen_subiter(morphology._zhang_suen_subiter(x, True), False)
        if torch.equal(x2, x):
            return passes
        x = x2


def test_skeleton_passes_counts_each_pass():
    rr, cc = np.mgrid[0:48, 0:48]
    masks = torch.from_numpy(np.stack([
        np.hypot(rr - 24, cc - 24) < 18,
        (np.abs(rr - 20) < 3) & (cc > 5),
        np.zeros((48, 48), bool),
    ]))
    plain = [_plain_passes(m) for m in masks]
    assert plain[0] > plain[1] > plain[2] == 1
    assert _counted(lambda: morphology.skeletonize(masks)) == {"skeleton_passes": max(plain)}
    assert _counted(lambda: morphology.skeletonize(masks[1])) == {"skeleton_passes": plain[1]}


@pytest.fixture(scope="module")
def ensemble():
    torch.manual_seed(0)
    member = build_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=1, device="cpu")
    rng = np.random.RandomState(1)
    stacks = [(f"S{i}", rng.randint(0, 255, (2, 64, 64)).astype(np.uint8)) for i in range(3)]
    return [member], stacks


@pytest.mark.parametrize("timer", [StageTimer, None])
def test_predict_rows_spans_and_no_synchronise(monkeypatch, ensemble, timer):
    def refuse(*a, **k):
        raise AssertionError("predict_rows synchronised with the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    members, stacks = ensemble
    plain = inv.predict_rows(stacks, members, (32, 32), 0.5, timer and timer())
    assert recorded_spans() == []
    given = timer and timer()
    with _cpu_profile():
        rows = inv.predict_rows(stacks, members, (32, 32), 0.5, given)
    assert rows == plain
    spans = recorded_spans()
    for sid, _ in stacks:
        mine = [s for s in spans if s.item == sid]
        assert sorted(s.name for s in mine) == ["dispatch", "fetch_wait", "host_resize"]
        assert all(s.parent is None and s.thread == threading.get_native_id() for s in mine)
        assert all(s.counts is None for s in mine)  # the CPU resize launches no kernel
    if given is not None:
        assert given.counts == {"host_resize": 3, "dispatch": 3, "fetch_wait": 3}


@pytest.mark.gpu
def test_predict_rows_counts_the_resize_launch_on_the_card(ensemble):
    """On the card each stack's ``host_resize`` span holds its one launch of
    the resize kernel, and no other span counts one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the resize kernel has no CPU or interpret mode")
    from tmat_torch.ops import resize_lanczos4 as rl

    _, stacks = ensemble
    card = [build_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=1, device="cuda")]
    before = rl.launches
    with _cpu_profile():
        rows = inv.predict_rows(stacks, card, (32, 32), 0.5)
    assert rl.launches == before + len(stacks) and len(rows) == sum(len(s) for _, s in stacks)
    spans = recorded_spans()
    for sid, _ in stacks:
        mine = {s.name: s.counts for s in spans if s.item == sid}
        assert mine == {"host_resize": {"resize_launches": 1}, "dispatch": None, "fetch_wait": None}


def test_the_span_clock_is_perf_counter():
    t0 = time.perf_counter()
    with traced(True, "c"), StageTimer().stage("outer"):
        time.sleep(0.002)
        t_mid = time.perf_counter()
        time.sleep(0.002)
    span = profiling.Span("cross", "c")
    t1 = time.perf_counter()
    threading.Thread(target=span.close).start()
    time.sleep(0.05)
    outer, cross = recorded_spans()
    assert t0 <= outer.start < t_mid < outer.end <= t1
    assert outer.end - outer.start >= 0.004
    assert outer.start < cross.start <= t1 < cross.end
    assert cross.thread == threading.get_native_id()


def test_maybe_profile_writes_spans_on_the_trace_clock(monkeypatch, tmp_path):
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path))
    box = {}

    def pool_task(on):
        box["tid"] = threading.get_native_id()
        with traced(on, "w1", 5), StageTimer().stage("pool_stage"):
            time.sleep(0.003)

    with maybe_profile("plate") as prof:
        assert prof is not None
        on = profiler_active()
        t = threading.Thread(target=pool_task, args=(on,))
        t.start()
        t.join(timeout=10)
        with traced(on, "w0"), StageTimer().stage("main_stage"):
            time.sleep(0.03)
            with record_function("inside"):
                time.sleep(0.01)
            time.sleep(0.03)
    assert not t.is_alive()
    (path,) = (tmp_path / "plate").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "tmat_span"}
    assert set(spans) == {"pool_stage", "main_stage"}
    assert spans["pool_stage"]["tid"] == box["tid"] and spans["pool_stage"]["args"]["parent"] == 5
    assert spans["main_stage"]["args"]["item"] == "w0"
    inside = next(e for e in events if e.get("name") == "inside")
    main = spans["main_stage"]
    assert main["tid"] == inside["tid"] == threading.get_native_id()
    # the profiler's own annotation lies inside the span, to within the tie's slack
    # (a descheduled thread between the anchor's clock reading and its annotation)
    assert main["ts"] + 20000 <= inside["ts"] and inside["ts"] + inside["dur"] + 20000 <= main["ts"] + main["dur"]


def test_plate_cli_writes_its_spans_with_the_profile(plate_setup, monkeypatch, tmp_path):
    """``process_plate`` under ``TMAT_TORCH_PROFILE_DIR``: one trace under
    ``plate/`` holding each well's spans from its pool thread."""
    from PIL import Image

    plate, _, ckpt = plate_setup
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for wid, stack in zip(WELLS, plate):
        frames = [Image.fromarray(s) for s in stack]
        frames[0].save(in_dir / f"{wid}.tif", save_all=True, append_images=frames[1:])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"patch_size": 32, "checkpoint_file": str(ckpt),
                               "filter_counts": [8, 16], "ds_ratio": 0.5, "dtype": "float32"}))
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path / "prof"))
    tpp.main(argv=[str(in_dir), str(tmp_path / "out"), "--image-width-microns", "800",
                   "--model-cfg", str(cfg)], device="cpu")
    (path,) = (tmp_path / "prof" / "plate").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "tmat_span"]
    wells = [e for e in spans if e["name"] == "well"]
    assert sorted(e["args"]["item"].split("/")[1] for e in wells) == WELLS
    stage1 = [e for e in spans if e["name"] == "device_stage1"]
    assert len(stage1) == 3 and all(e["args"]["host_copies"] == 3 for e in stage1)
    assert threading.get_native_id() not in {e["tid"] for e in stage1}


def test_concurrent_spans_are_all_kept():
    """16 threads recording at once, with a short switch interval: no span
    lost, no id reused, each thread's parent chain its own."""
    n_threads, per = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        timer = StageTimer()
        for _ in range(per):
            with traced(True, f"t{k}"), timer.stage("outer"), timer.stage("inner"):
                profiling.count("n")

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = recorded_spans()
    assert len(spans) == 2 * n_threads * per and len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.counts == {"n": 1}
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].item == s.item
        else:
            assert s.parent is None
