"""Whole runs of tiny cells on the CPU: everything of ``run.py`` but the
look for a card. A configuration, a cell and a metric added as new files
and entries are found and run; the check passes the program, and fails the
control and each fault that the cells can have."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests.tiny import run_tiny

REPO = Path(__file__).resolve().parents[2]


def test_added_files_are_found_and_run(tiny):
    from perfbench import harness

    tmp, bench = tiny
    cell = harness.Cell(bench, "tiny_plate", Path(tmp) / "perfbench")
    assert Path(cell.generator.__file__) == Path(tmp) / "perfbench" / "traffic" / "tiny_plate.py"
    assert Path(cell.reference.__file__) == Path(tmp) / "perfbench" / "reference" / "tiny_segment.py"
    assert len(cell.generator.make(1, cell.traffic)) == 2  # the added generator's plates
    res = run_tiny(tmp, bench, "tiny_plate")
    assert res["correct"], res["check"]
    # plate_s_p80 needs 5 plates, more than a CPU window of 1.5 s may run
    assert {"wells_per_s", "setup_s"} <= set(res["metrics"]) <= {"wells_per_s", "plate_s_p80", "setup_s"}
    assert list(res)[-1] == "check" and res["attempted"] > 0 and res["failed"] == 0
    traced = run_tiny(tmp, bench, "tiny_plate", trace=True)
    assert traced["correct"]
    assert traced["metrics"]["plates_seen"]["value"] >= 2  # the dummy metric's reader
    assert {"host_tail_ms.plate", "stage1_ms.plate", "unet_mfu"} <= set(traced["metrics"])
    assert "window_s" in traced["device"] and "breakdown" in traced


def test_inv_depth_cell_runs(tiny):
    tmp, bench = tiny
    res = run_tiny(tmp, bench, "tiny_inv")
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"stacks_per_s", "setup_s"}
    assert res["check"]["prob_gap"]["value"] <= 1e-4


def test_plate_control_fails(tiny):
    tmp, bench = tiny
    res = run_tiny(tmp, bench, "tiny_plate", control="control")
    assert not res["correct"], res["check"]


def test_inv_depth_control_fails(tiny):
    tmp, bench = tiny
    res = run_tiny(tmp, bench, "tiny_inv", control="control")
    assert not res["correct"], res["check"]


def _half_batch_plate(run):
    pred = run.driver._pred

    def half(batch):
        n = batch.shape[0] // 2
        out = pred(batch[:n])
        return out.repeat(2, 1, 1, 1)[: batch.shape[0]]

    run.driver._pred = half


def _altered_plate(run):
    run_plate = run.driver.run_plate

    def altered(*a, **k):
        res = run_plate(*a, **k)
        res["total_branches"] = [n + 3 for n in res["total_branches"]]
        return res

    run.driver.run_plate = altered


def _half_batch_inv(run):
    for m in run.driver.ens:
        forward = m.forward

        def half(x, forward=forward):
            import torch

            n = max(1, x.shape[0] // 2)
            return forward(x[:n])[torch.arange(x.shape[0]) % n]

        m.forward = half


def _altered_inv(run):
    inv = run.driver.inv
    stack_rows = inv.stack_rows

    def altered(stack_id, member_probs, cls_thresh):
        rows = stack_rows(stack_id, member_probs, cls_thresh)
        rows[0][inv.PROB_COL] = round(min(1.0, rows[0][inv.PROB_COL] + 0.3), 4)
        return rows

    inv.stack_rows = altered
    run.faults_undo = lambda: setattr(inv, "stack_rows", stack_rows)


@pytest.mark.parametrize("cell,fault", [("tiny_plate", _half_batch_plate), ("tiny_plate", _altered_plate),
                                        ("tiny_inv", _half_batch_inv), ("tiny_inv", _altered_inv)])
def test_faults_fail(tiny, cell, fault):
    tmp, bench = tiny
    undo = []

    def plant(run):
        fault(run)
        undo.append(getattr(run, "faults_undo", None))

    try:
        res = run_tiny(tmp, bench, cell, fault=plant)
    finally:
        for u in undo:
            if u:
                u()
    assert not res["correct"], res["check"]


def test_fs_well_cell_runs(tiny):
    """The focus-stacked, well-masked plate: the program's masks are ones
    that the reference's fit allows, and the rest agrees inside them."""
    tmp, bench = tiny
    res = run_tiny(tmp, bench, "tiny_fs")
    assert res["correct"], res["check"]
    assert res["check"]["mask_gap"]["value"] == 0 and res["check"]["prob_gap"]["value"] < 1e-4
    assert res["check"]["proj_gap"]["value"] <= 1e-4  # the program's projections, kept and judged
    assert {"wells_per_s", "setup_s"} <= set(res["metrics"])
    traced = run_tiny(tmp, bench, "tiny_fs", trace=True)
    assert traced["correct"], traced["check"]
    assert traced["metrics"]["well_mask_ms.plate"]["value"] > 0
    assert traced["metrics"]["host_tail_ms.plate"]["value"] > 0  # read over the window, not the trace
    # no kernel runs on the CPU: the roofline has nothing to read
    assert "focus_stack_roofline" not in traced["metrics"]


def _fs_call(**changes):
    """A fault: ``run_plate`` called with the traffic's arguments changed
    (``calibrate.py --fault`` plants the same at the cell's size)."""
    from perfbench.calibrate import changed_call

    return lambda run: changed_call(run.driver, changes)


@pytest.mark.parametrize("control,fault", [
    ("control", None),
    ("", _fs_call(z_counts=None)),  # the padding counted
    ("", _fs_call(proj_method="max")),  # max in place of focus stacking
    ("", _fs_call(detect_well=False)),  # the well mask dropped
], ids=["control", "padding_counted", "max_for_fs", "mask_dropped"])
def test_fs_well_control_and_faults_fail(tiny, control, fault):
    tmp, bench = tiny
    res = run_tiny(tmp, bench, "tiny_fs", control=control, fault=fault)
    assert not res["correct"], res["check"]


def test_no_jax_in_a_run(tiny):
    """A run's process loads neither JAX nor the JAX package (whole
    top-level names: tmat_torch is not tmat_tpu)."""
    tmp, _ = tiny
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from perfbench.tests.tiny import run_tiny\n"
        "from perfbench.harness import forbidden_modules\n"
        "from pathlib import Path\n"
        f"tmp = Path({str(tmp)!r})\n"
        "bench = json.loads((tmp / 'BENCHMARK.json').read_text())\n"
        "res = run_tiny(tmp, bench, 'tiny_plate', seconds=0.5)\n"
        "assert 'tmat_torch' in sys.modules\n"
        "print(json.dumps(forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    from perfbench import harness

    sys.modules.setdefault("tmat_tpu_like", type(sys)("tmat_tpu_like"))
    try:
        assert "tmat_tpu" not in harness.forbidden_modules() or "tmat_tpu" in sys.modules
    finally:
        sys.modules.pop("tmat_tpu_like", None)
    names = {m.split(".")[0] for m in ("tmat_torch.ops", "jaxtyping", "flax_like")}
    assert not names & set(harness.FORBIDDEN)


def test_run_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    out = subprocess.run([sys.executable, str(REPO / "perfbench" / "run.py"), "--workload", "plate_max",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory with only BENCHMARK.json and perfbench/: no program to run
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "plate_max", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["plate_max", "inv_depth_1024", "plate_fs_well"])
def test_control_fails_at_the_cells_size_on_the_card(cuda, cell):
    """The control at the cell's own size on the card: one seed of the
    program is correct, one of the control is not (the readings the limits
    were set from: ``calibrate.py``, PERF.md)."""
    import torch
    from perfbench import harness

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    c = harness.Cell(bench, cell)
    for control, expect in (("", True), ("control", False)):
        run = harness.Run(c, 2**32 + 11, 5.0, False, cuda, control=control)
        try:
            res = harness.measure(run, __import__("time").time())
        finally:
            run.close()
        torch.cuda.empty_cache()
        assert res["correct"] is expect, res["check"]
