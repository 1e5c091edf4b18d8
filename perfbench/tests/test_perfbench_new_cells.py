"""Tiny cells of ``inv_depth_swinv2`` and ``plate_max_dense`` on the CPU, added
to the tiny copy (``tiny.py``) as new files and entries: each runs
correct through the whole harness, its control fails, and a planted fault
fails; the SwinV2 work counts against counts made by hand, and the
reference's independence of the program."""

import copy
import json
import shutil
from pathlib import Path

import pytest

from perfbench.tests.tiny import run_tiny

REPO = Path(__file__).resolve().parents[2]
SWIN = {"input_shape": [64, 64, 3], "patch": 4, "embed_dim": 32, "depths": [2, 2, 2, 2], "heads": [1, 2, 4, 8],
        "window": 4, "mlp_ratio": 4, "cpb_hidden": 64}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def cells(tiny):
    """(directory, BENCHMARK.json dict) of the tiny copy with ``tiny_swin``
    (a 64 px SwinV2 of embed 32, window 4, two members, float32, on 96 px
    stacks of 3 slices, the heads scaled on all of them) and ``tiny_dense``
    (``tiny_plate`` at the dense traffic's curves) added."""
    tmp, bench = tiny
    bench = copy.deepcopy(bench)
    pb = Path(tmp) / "perfbench"
    cfg = json.loads((pb / "configs" / "swinv2b_inv_ensemble_bf16.json").read_text())
    # the heads scaled on every slice of the 3-slice stacks: on 2 of 3 the
    # tiny model's checked logits spread wider than the sample's, and the
    # planted fault's gaps, over that spread, fall to the limits
    cfg.update(SWIN, n_pred_models=2, dtype="float32", reduced=list(SWIN), head_sample_slices=3)
    _write(pb / "configs" / "tiny_swin.json", cfg)
    inv = json.loads((pb / "traffic" / "inv_depth_swinv2.json").read_text())
    inv.update(size=96, z=3, cycle_stacks=3, warm_stacks=2, check_stacks=2, trace_stacks=[1, 2], check_stack_rate=1.0)
    _write(pb / "traffic" / "tiny_swin.json", inv)
    shutil.copy(pb / "limits" / "inv_depth_swinv2.json", pb / "limits" / "tiny_swin.json")
    dense = json.loads((pb / "traffic" / "tiny_plate.json").read_text())
    dense["curves"] = json.loads((pb / "traffic" / "plate_max_dense.json").read_text())["curves"]
    _write(pb / "traffic" / "tiny_dense.json", dense)
    shutil.copy(pb / "traffic" / "plate_max_dense.py", pb / "traffic" / "tiny_dense.py")
    shutil.copy(pb / "limits" / "plate_max_dense.json", pb / "limits" / "tiny_dense.json")
    bench["configs"].append({"name": "tiny_swin", "source": "https://arxiv.org/abs/2111.09883",
                             "file": "perfbench/configs/tiny_swin.json", "reduced": list(SWIN), "why": "test"})
    bench["workloads"] += [
        {"name": "tiny_swin", "config": "tiny_swin", "traffic": "tiny_swin", "chips": 1, "why": "test"},
        {"name": "tiny_dense", "config": "tiny_seg", "traffic": "tiny_dense", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, small in (("inv_depth_swinv2", "tiny_swin"), ("plate_max_dense", "tiny_dense")):
            if real in m.get("workloads", []):
                m["workloads"].append(small)
    return tmp, bench


def test_swin_cell_runs_and_reports(cells):
    tmp, bench = cells
    res = run_tiny(tmp, bench, "tiny_swin")
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"stacks_per_s", "setup_s"}
    # float32 on both sides: the gaps are rounding's
    assert res["check"]["logit_gap"]["value"] < 1e-4 and res["check"]["prob_gap"]["value"] <= 1e-4
    traced = run_tiny(tmp, bench, "tiny_swin", trace=True)
    assert traced["correct"], traced["check"]
    assert traced["metrics"]["swinv2_mfu"]["value"] > 0  # from the program's counters
    # (a traced stack's fetch comes MAX_IN_FLIGHT stacks later: after two traced stacks, outside the trace)
    assert {"dispatch_ms.inv_depth", "resize_ms.inv_depth", "idle_share.inv_depth"} <= set(traced["metrics"])
    # no kernel runs on the CPU: no attention call to time
    assert "window_attn_roofline" not in traced["metrics"] and "resnet50_mfu" not in traced["metrics"]


def _attention_without_table(run):
    """A fault: the window attention without its position bias and mask."""
    swin = run.driver.swin
    attention = swin.window_attention

    def broken(q, k, v, bias, mask, scale):
        return attention(q, k, v, bias * 0, mask, scale)

    swin.window_attention = broken
    run.faults_undo = lambda: setattr(swin, "window_attention", attention)


def _altered_rows(run):
    inv = run.driver.inv
    stack_rows = inv.stack_rows

    def altered(stack_id, member_probs, cls_thresh):
        rows = stack_rows(stack_id, member_probs, cls_thresh)
        rows[0][inv.PROB_COL] = round(min(1.0, rows[0][inv.PROB_COL] + 0.3), 4)
        return rows

    inv.stack_rows = altered
    run.faults_undo = lambda: setattr(inv, "stack_rows", stack_rows)


@pytest.mark.parametrize("control,fault", [("control", None), ("", _attention_without_table), ("", _altered_rows)],
                         ids=["control", "no_table", "altered_rows"])
def test_swin_control_and_faults_fail(cells, control, fault):
    tmp, bench = cells
    undo = []

    def plant(run):
        fault(run)
        undo.append(getattr(run, "faults_undo", None))

    try:
        res = run_tiny(tmp, bench, "tiny_swin", control=control, fault=fault and plant)
    finally:
        for u in undo:
            if u:
                u()
    assert not res["correct"], res["check"]


def test_dense_cell_draws_more_curves_and_runs(cells):
    from perfbench import harness
    from perfbench.inputs import vessels

    tmp, bench = cells
    cell = harness.Cell(bench, "tiny_dense", Path(tmp) / "perfbench")
    t = cell.traffic
    real = json.loads((REPO / "perfbench" / "traffic" / "plate_max_dense.json").read_text())
    dense = vessels.curve_counts(real["pool_wells"], real["size"], *real["curves"])
    assert sum(dense) >= 2.4 * sum(vessels.curve_counts(real["pool_wells"], real["size"]))
    plates = cell.generator.make(5, t)
    plain = vessels.plates(vessels.well_pool(5, t["pool_wells"], t["size"], t["z"]), 5, t["cycle_plates"],
                           t["wells_per_plate"])
    assert len(plates) == t["cycle_plates"] and plates[0].shape == plain[0].shape
    assert sum(p.mean() for p in plates) > sum(p.mean() for p in plain)  # more vessel pixels
    res = run_tiny(tmp, bench, "tiny_dense")
    assert res["correct"], res["check"]
    assert {"wells_per_s", "setup_s"} <= set(res["metrics"])


def test_dense_control_fails(cells):
    tmp, bench = cells
    res = run_tiny(tmp, bench, "tiny_dense", control="control")
    assert not res["correct"], res["check"]


# one window attention call's kernels as the card runs them (names cut short), and kernels between calls
CALL = ["void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, at::native::NormTwoOps<",
        "clamp_min_scalar_kernel", "BinaryFunctor<c10::BFloat16, DivFunctor>", "BinaryFunctor<MulFunctor>",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16, at::native::NormTwoOps<",
        "clamp_min_scalar_kernel", "BinaryFunctor<c10::BFloat16, DivFunctor>",
        "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64"]
BETWEEN = ["nvjet_tst_128x64_64x8_1x2_h_bz_bias_TNT", "vectorized_layer_norm_kernel", "GeluCUDAKernelImpl"]


def _trace(n_calls: int):
    """(device ops, each call's device µs): ``n_calls`` calls, each kernel
    of call i lasting i + 1 µs, the kernels between calls 50 µs each."""
    ops, t, per_call = [], 0.0, []
    for i in range(n_calls):
        for name in BETWEEN:
            ops.append((t, t + 50.0, name, 7))
            t += 60.0
        for name in CALL:
            ops.append((t, t + i + 1.0, name, 7))
            t += i + 3.0
        per_call.append(len(CALL) * (i + 1.0))
    return ops, per_call


def test_attention_calls_found_by_their_first_and_last_kernels():
    from perfbench import work_swinv2 as w

    ops, per_call = _trace(5)
    assert w.attention_calls(ops) == pytest.approx([us / 1e6 for us in per_call])
    assert w.attention_calls([op for op in ops if "sdpa" not in op[2]]) == []


def test_window_attn_roofline_reads_the_attention_kernels(monkeypatch):
    """On a trace whose first forward began before it: the bound of the
    whole forwards found (their images from the program's counters) over
    the device time of all their calls' kernels, norms included."""
    from types import SimpleNamespace

    from perfbench import spans as sp
    from perfbench import work_swinv2 as w
    from perfbench.harness import load_module

    cfg = json.loads((REPO / "perfbench" / "configs" / "swinv2b_inv_ensemble_bf16.json").read_text())
    counts = {"attn_calls": 24, "attn_windows": 8 * 60}
    spans = [SimpleNamespace(name="swin_forward", id=i, parent=0, counts=counts, start=1.0, end=1.1)
             for i in range(1, 4)]
    ops, per_call = _trace(5 + 2 * 24)  # the tail of a forward, then two whole ones
    run = SimpleNamespace(trace_summary=SimpleNamespace(device=ops), config=cfg)
    monkeypatch.setattr(sp, "traced_spans", lambda r: spans)
    reader = load_module(REPO / "perfbench" / "metrics" / "window_attn_roofline.py")
    assert reader.read(run) == pytest.approx(2 * w.attention_bound_s(cfg, 8) / (sum(per_call[5:]) / 1e6) * 100)
    # two replays of 8 slices in each forward's span: still 8 images an attention pass
    spans[0].counts = {"attn_calls": 48, "attn_windows": 16 * 60}
    assert reader.read(run) == pytest.approx(2 * w.attention_bound_s(cfg, 8) / (sum(per_call[5:]) / 1e6) * 100)
    # kernels the names no longer find: loud, not silent
    run.trace_summary.device = [op for op in ops if "NormTwoOps" not in op[2]]
    with pytest.raises(RuntimeError, match="ATTN_FIRST_KERNELS"):
        reader.read(run)
    # a program without the spans (a parent commit), or a trace without a card: nothing
    run.trace_summary.device = ops
    monkeypatch.setattr(sp, "traced_spans", lambda r: None)
    assert reader.read(run) is None
    monkeypatch.setattr(sp, "traced_spans", lambda r: spans)
    run.trace_summary.device = []
    assert reader.read(run) is None


def test_swinv2_work_by_hand():
    from perfbench import work_swinv2 as w

    cfg = json.loads((REPO / "perfbench" / "configs" / "swinv2b_inv_ensemble_bf16.json").read_text())
    layers = dict(w.swinv2_layers(cfg))
    assert layers["patch_embed"] == 2 * 64 * 64 * 48 * 128
    assert layers["block0.qkv"] == 2 * 4096 * 128 * 384 and layers["block0.qk"] == 2 * 4096 * 256 * 128
    assert layers["block4.fc1"] == 2 * 256 * 512 * 2048  # stage 2 at 16², C 512
    assert layers["block23.av"] == 2 * 64 * 64 * 1024  # stage 3: the window clamped to the 8² grid
    assert layers["merge2"] == 2 * 64 * 2048 * 1024 and layers["head"] == 2 * 1024
    # 21.8 G multiply-adds an image; 8 slices x 3 members a stack
    assert w.swinv2_flops(cfg) == pytest.approx(43.57e9, rel=1e-3)
    assert 24 * w.swinv2_flops(cfg) == pytest.approx(1.046e12, rel=1e-3)
    assert w.windows_per_image(cfg) == 2 * 16 + 2 * 4 + 18 + 2
    call = w.window_attn_work((128, 4, 256, 32), (16, 4, 256, 256), None, 2)
    assert call["flops"] == 4 * 128 * 4 * 256 * 256 * 32
    assert call["bytes"] == (4 * 128 * 4 * 256 * 32 + 16 * 4 * 256 * 256) * 2
    assert call["bound_s"] == call["bytes_s"] > call["ops_s"]  # the attention is bound by its bytes
    # a forward of 8 images: stages 0-1 shift their odd blocks (a table a window), 2-3 do not
    assert w.attention_bound_s(cfg, 8) == pytest.approx(sum(
        w.window_attn_work((8 * nw, h, n, 32), (t, h, n, n), None, 2)["bound_s"]
        for nw, h, n, t in [(16, 4, 256, 1), (16, 4, 256, 16), (4, 8, 256, 1), (4, 8, 256, 4)]
        + [(1, 16, 256, 1)] * 18 + [(1, 32, 64, 1)] * 2))
