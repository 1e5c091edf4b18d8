"""The port's compute_inv_depth tool against the JAX tool, on the CPU.

Both tools read the same model directory and the same input directory.
The tiny ensemble is ``tests/test_tool_inv_depth.py::_setup_model_dir``
(64 px, conv4_block6_out) with random heads: the Flax head starts at zero,
which would make every probability 0.5. Tolerances: probabilities within
1e-4 (the CSV's 4 decimals), predictions and IDs equal. The CSVs came out
byte-equal on every input tried; the tests hold the values, not the bytes.
"""

import argparse
import csv
import json
import shutil

import numpy as np
import pytest
from PIL import Image

from test_tool_inv_depth import _setup_model_dir
from tmat_tpu.core import defs as jdefs
from tmat_tpu.models.params_io import load_params, save_params
from tmat_tpu.models.resnet import build_resnet50_tl as jbuild
from tmat_tpu.models.synthetic import synth_invasion_image as j_synth
from tmat_tpu.tools import compute_inv_depth as j_tool
from tmat_torch.core import defs
from tmat_torch.models.synthetic import synth_invasion_image
from tmat_torch.tools import compute_inv_depth as tool

CSV_NAME = "invasion_depth_predictions.csv"


@pytest.fixture(scope="module")
def _members(tmp_path_factory):
    """Two random 64-px members with random heads, made once per module."""
    mt = _setup_model_dir(tmp_path_factory.mktemp("members"))
    rng = np.random.RandomState(11)
    _, template = jbuild(1, (64, 64, 3), base_last_layer="conv4_block6_out", init="zeros")
    for i in range(2):
        path = mt / "best_ensemble" / f"best_finetune_weights_{i}.msgpack"
        variables = load_params(path, template)
        head = variables["params"]["head"]
        head["kernel"] = (rng.randn(1024, 1) * 0.5).astype(np.float32)
        head["bias"] = np.zeros(1, np.float32)
        save_params(path, variables)
    return mt


@pytest.fixture
def model_dir(tmp_path, monkeypatch, _members):
    """A copy of the members' model directory; both packages look there."""
    mt = tmp_path / "model_training"
    shutil.copytree(_members, mt)
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", mt)
    monkeypatch.setattr(jdefs, "MODEL_TRAINING_DIR", mt)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"n_pred_models": 2}))
    return mt, cfg


def _write_stacks(in_dir, stacks):
    in_dir.mkdir()
    for name, stack in stacks.items():
        frames = [Image.fromarray(s) for s in stack]
        frames[0].save(in_dir / f"{name}.tif", save_all=True, append_images=frames[1:])


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_rows_agree(rows, ref):
    assert [r[tool.ID_COL] for r in rows] == [r[tool.ID_COL] for r in ref]
    probs = np.array([float(r[tool.PROB_COL]) for r in rows])
    ref_probs = np.array([float(r[tool.PROB_COL]) for r in ref])
    np.testing.assert_allclose(probs, ref_probs, atol=1e-4, rtol=0)
    assert [r[tool.PRED_COL] for r in rows] == [r[tool.PRED_COL] for r in ref]


def test_main_matches_the_jax_tool(tmp_path, model_dir):
    _, cfg = model_dir
    rng = np.random.RandomState(0)
    in_dir = tmp_path / "in"
    _write_stacks(in_dir, {"well1": rng.randint(0, 255, (3, 80, 80)).astype(np.uint8),
                           "well2": rng.randint(0, 120, (2, 70, 90)).astype(np.uint8)})
    j_tool.main(argv=[str(in_dir), str(tmp_path / "jax"), "-c", str(cfg)])
    tool.main(argv=[str(in_dir), str(tmp_path / "port"), "-c", str(cfg)], device="cpu")
    ref, rows = _rows(tmp_path / "jax" / CSV_NAME), _rows(tmp_path / "port" / CSV_NAME)
    assert [r[tool.ID_COL] for r in rows] == [f"well1_z{z}" for z in range(3)] + ["well2_z0", "well2_z1"]
    _assert_rows_agree(rows, ref)
    probs = [float(r[tool.PROB_COL]) for r in rows]
    assert len(set(probs)) > 1 and all(0 <= p <= 1 for p in probs), probs
    # a second run writes the -2 sibling, not over the first file
    tool.main(argv=[str(in_dir), str(tmp_path / "port"), "-c", str(cfg)], device="cpu")
    assert _rows(tmp_path / "port" / "invasion_depth_predictions-2.csv") == rows


def test_predict_stack_is_file_free_and_gives_the_rows(tmp_path, model_dir):
    mt, cfg = model_dir
    stack = np.random.RandomState(2).randint(0, 255, (3, 80, 80)).astype(np.uint8)
    in_dir = tmp_path / "in"
    _write_stacks(in_dir, {"w": stack})
    tool.main(argv=[str(in_dir), str(tmp_path / "out"), "-c", str(cfg)], device="cpu")
    ranked = tool._rank_models_by_history(mt / "best_ensemble", 2)
    ens = tool.load_ensemble([mt / "best_ensemble" / f"best_finetune_weights_{i}.msgpack" for i in ranked],
                             (64, 64, 3), "conv4_block6_out", device="cpu")
    probs = tool.predict_stack(stack, ens, (64, 64))
    assert probs.shape == (2, 3, 1) and probs.dtype == np.float32
    rows = tool.stack_rows("w", probs, 0.5)
    assert [{k: str(v) for k, v in r.items()} for r in rows] == _rows(tmp_path / "out" / CSV_NAME)


def test_shipped_ensemble_at_256(tmp_path, monkeypatch):
    """The five shipped members (three used, ranked by history) on the two
    seed-5 slices: within 1e-4 of the JAX tool, not invaded then invaded."""
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", tmp_path / "nonexistent")
    monkeypatch.setattr(jdefs, "MODEL_TRAINING_DIR", tmp_path / "nonexistent")
    rng = np.random.RandomState(5)
    stack = np.stack([synth_invasion_image(rng, 256, invaded=False),
                      synth_invasion_image(rng, 256, invaded=True)])
    j_rng = np.random.RandomState(5)
    np.testing.assert_array_equal(
        stack, np.stack([j_synth(j_rng, 256, invaded=False), j_synth(j_rng, 256, invaded=True)]))
    in_dir = tmp_path / "in"
    _write_stacks(in_dir, {"well1": stack})
    j_tool.main(argv=[str(in_dir), str(tmp_path / "jax")])
    tool.main(argv=[str(in_dir), str(tmp_path / "port")], device="cpu")
    rows = _rows(tmp_path / "port" / CSV_NAME)
    _assert_rows_agree(rows, _rows(tmp_path / "jax" / CSV_NAME))
    assert [int(r[tool.PRED_COL]) for r in rows] == [0, 1]


def test_history_ranking(tmp_path):
    ens = defs.PKG_MODEL_DIR / "best_ensemble"
    np.testing.assert_array_equal(tool._rank_models_by_history(ens, 5),
                                  j_tool._rank_models_by_history(ens, 5))
    # no history at all: identity; some histories: ranked, the rest last
    d = tmp_path / "ens"
    d.mkdir()
    np.testing.assert_array_equal(tool._rank_models_by_history(d, 3), [0, 1, 2])
    for i, loss in ((2, 0.1), (1, 0.3)):
        with open(d / f"best_model_history_{i}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["val_loss", "training_stage"])
            w.writeheader()
            w.writerow({"val_loss": loss + 0.5, "training_stage": "frozen"})
            w.writerow({"val_loss": loss, "training_stage": "finetune"})
    for n in (3, 4):
        np.testing.assert_array_equal(tool._rank_models_by_history(d, n),
                                      j_tool._rank_models_by_history(d, n))
    assert tool._rank_models_by_history(d, 3).tolist()[:2] == [2, 1]


@pytest.mark.parametrize("case", ["too_many_models", "missing_checkpoint", "missing_config",
                                  "default_config", "missing_input", "mixed_input"])
def test_exit_1_paths(tmp_path, model_dir, case):
    mt, cfg = model_dir
    in_dir = tmp_path / "in"
    _write_stacks(in_dir, {"w": np.zeros((2, 16, 16), np.uint8)})
    argv = [str(in_dir), str(tmp_path / "out"), "-c", str(cfg)]
    if case == "too_many_models":
        cfg.write_text(json.dumps({"n_pred_models": 3}))
    elif case == "missing_checkpoint":
        (mt / "best_ensemble" / "best_finetune_weights_1.msgpack").unlink()  # the best-ranked one
    elif case == "missing_config":
        argv[-1] = str(tmp_path / "none.json")
    elif case == "default_config":
        argv = argv[:2]  # the shipped default asks for 3 of these 2 members
    elif case == "missing_input":
        argv[0] = str(tmp_path / "none")
    else:
        (in_dir / "sub").mkdir()
    with pytest.raises(SystemExit) as exc:
        tool.main(argv=argv, device="cpu")
    assert exc.value.code == 1
    assert not (tmp_path / "out" / CSV_NAME).exists()


def test_gui_namespace(tmp_path, model_dir):
    """A namespace as the GUI builds it: config None takes the default
    (3 members: exit 1 here); a config field is honoured."""
    _, cfg = model_dir
    in_dir = tmp_path / "in"
    _write_stacks(in_dir, {"w": np.random.RandomState(3).randint(0, 255, (2, 40, 40)).astype(np.uint8)})
    ns = argparse.Namespace(in_root=str(in_dir), out_root=str(tmp_path / "out"), channel=None,
                            time=None, config=None)
    with pytest.raises(SystemExit) as exc:
        tool.main(args=ns, device="cpu")
    assert exc.value.code == 1
    ns.config = str(cfg)
    tool.main(args=ns, device="cpu")
    assert len(_rows(tmp_path / "out" / CSV_NAME)) == 2


def test_load_ensemble_on_the_cpu_captures_nothing_and_runs_eagerly(model_dir):
    """On the CPU ``load_ensemble`` captures no graph (``capture`` is a no-op
    there): each member counts one ``eager_forwards`` in its stack's
    ``dispatch`` span and no ``graph_replays``, and its probabilities are
    those of the forward before the features and the head were split, bit
    for bit."""
    import torch

    from tmat_torch.core.profiling import StageTimer, recorded_spans, traced
    from tmat_torch.models.preprocess import prep_tail

    mt, _ = model_dir
    paths = [mt / "best_ensemble" / f"best_finetune_weights_{i}.msgpack" for i in range(2)]
    ens = tool.load_ensemble(paths, (64, 64, 3), "conv4_block6_out", device="cpu")
    assert all(m._graph is None and m.capture() is m and m._graph is None for m in ens)
    stack = np.random.RandomState(3).randint(0, 255, (3, 80, 80)).astype(np.uint8)
    with traced(True, "cpu_eager"):
        probs = tool.dispatch_stack(stack, ens, (64, 64), StageTimer())
    spans = {s.name: s.counts for s in recorded_spans() if s.item == "cpu_eager"}
    assert spans == {"host_resize": None, "dispatch": {"eager_forwards": len(ens)}}
    x = prep_tail(tool.resize_stack(stack, (64, 64), torch.device("cpu")))
    assert all(m.replays(x) == 0 for m in ens)
    with torch.no_grad():
        for m, p in zip(ens, probs):
            feats = m.base(x.permute(0, 3, 1, 2).to(m.dtype)).mean(dim=(2, 3))
            assert torch.equal(p, torch.sigmoid(m.head(feats.float())))
    assert probs.shape == (2, 3, 1) and not torch.equal(probs[0], probs[1])
