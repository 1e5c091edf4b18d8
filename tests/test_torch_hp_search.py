"""The port's hyperparameter search and Bayesian optimizer against
``tmat_tpu/models/hp_search.py`` and ``bo.py``: the same seeds draw the
same trials, and ``search`` with a stubbed objective (as
``tests/test_hp_search.py`` runs it) returns the same best configuration."""

import json

import numpy as np
import pytest
from PIL import Image

from tmat_tpu.models import bo as JB, hp_search as JH
from tmat_torch.core import defs
from tmat_torch.models import bo as TB, hp_search as TH

SPACE = {
    "adam_beta_1_range": [0.8, 0.99],
    "adam_beta_2_range": [0.98, 0.999],
    "frozen_lr_range": [1e-4, 1e-2],
    "fine_tune_lr_range": [1e-5, 1e-3],
    "last_layer_options": ["conv5_block3_out", "conv4_block6_out"],
    "num_initial_points": 3,
    "max_opt_trials": 6,
}


def _objective(hp):
    return abs(np.log(hp["frozen_lr"]) - np.log(1e-3)) + 0.1 * (hp["last_resnet_layer"] != "conv4_block6_out")


def test_sample_hp_equal():
    incumbent = {"adam_beta_1": 0.9, "adam_beta_2": 0.99, "frozen_lr": 1e-3,
                 "fine_tune_lr": 1e-4, "last_resnet_layer": "conv4_block6_out"}
    r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
    for i in range(40):
        kw = {"incumbent": incumbent, "shrink": 0.2} if i % 2 else {}
        assert TH.sample_hp(SPACE, r1, **kw) == JH.sample_hp(SPACE, r2, **kw)


def test_bo_proposes_the_same_trials():
    outs = []
    for B in (JB, TB):
        trials = []
        best = B.minimize(_objective, SPACE, trials=8, num_initial_points=3, seed=4,
                          callback=lambda t, hp, loss: trials.append((hp, loss)))
        outs.append((best, trials))
    assert outs[0] == outs[1]
    gp = TB.GP(np.random.RandomState(0).rand(5, 3), np.arange(5.0))
    ref = JB.GP(np.random.RandomState(0).rand(5, 3), np.arange(5.0))
    grid = np.random.RandomState(1).rand(7, 3)
    for a, b in zip(gp.predict(grid), ref.predict(grid)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["bo", "random"])
def test_search_with_a_stubbed_objective(monkeypatch, method):
    calls = []

    def fake_eval(hp, *args, **kwargs):
        calls.append(kwargs.get("device"))
        return _objective(hp)

    monkeypatch.setattr(TH, "evaluate_hp", fake_eval)
    monkeypatch.setattr(JH, "evaluate_hp", lambda hp, *a, **k: _objective(hp))
    out = TH.search({}, {}, trials=12, initial_points=6, space=SPACE, verbose=False, method=method,
                    device="cpu")
    ref = JH.search({}, {}, trials=12, initial_points=6, space=SPACE, verbose=False, method=method)
    assert out == ref and calls == ["cpu"] * 12
    assert out[1] < 0.8


def test_main_runs_a_real_trial_and_writes_the_best(tmp_path, monkeypatch):
    """One real two-stage trial on the CPU (ResNet truncated at
    conv2_block3_out, 32 px); the best configuration lands in the user base dir."""
    rng = np.random.RandomState(0)
    for cls in ("no_invasion", "invasion"):
        (tmp_path / "data" / cls).mkdir(parents=True)
        for i in range(5):
            Image.fromarray((rng.rand(40, 40) * 255).astype(np.uint8)).save(
                tmp_path / "data" / cls / f"{i}.tif")
    mt = tmp_path / "mt"
    mt.mkdir()
    (mt / "invasion_depth_hp_space.json").write_text(json.dumps(
        {**SPACE, "last_layer_options": ["conv2_block3_out"]}))
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", mt)
    out = TH.main([str(tmp_path / "data"), "--trials", "1", "--initial-points", "1",
                   "--frozen-epochs", "1", "--fine-tune-epochs", "1", "--batch-size", "2",
                   "--img-size", "32"], device="cpu")
    best = json.loads(out.read_text())
    assert out == mt / "invasion_depth_best_hp.json"
    assert best["last_resnet_layer"] == "conv2_block3_out" and 1e-4 <= best["frozen_lr"] <= 1e-2
