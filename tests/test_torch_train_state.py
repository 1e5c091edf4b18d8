"""Train-state checkpoints across the two packages.

The port's ``save_train_state`` writes ``opt_state`` as the state dict of
the optax transformation the JAX trainer builds for the same run, so for
the segmentation trainer's ``adamw`` under a schedule, the fine-tune
stage's plain ``adam`` and the frozen stage's ``multi_transform``:

- the port's file is byte-equal to ``flax.serialization.to_bytes`` of the
  JAX ``TrainState`` that holds the same values (written by the JAX
  ``save_train_state`` after a JAX step, or loaded by the JAX
  ``load_train_state`` from the port's file);
- either package resumes from the other's file, and the next step's loss
  agrees within 1e-5 relative (one step's tolerance in
  ``test_torch_train.py``), the step after it within 1e-3 (its five-step
  tolerance).
"""

import jax
import numpy as np
import optax
import pytest

from test_torch_train import FILTERS, LAYER, _resnet_pair, _seg_batch, _unet_pair
from tmat_tpu.models import train as JT
from tmat_torch.models import train as T
from tmat_torch.models.layers import load_flax_variables
from tmat_torch.models.resnet import build_trainable_resnet50_tl
from tmat_torch.models.unet import build_unet_xception


def _cls_batch():
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 32, 32, 3) * 20).astype(np.float32)
    y = np.array([[0.0], [1.0], [1.0], [0.0]], np.float32)
    return x, y, np.array([1.0, 2.0, 1.0, 0.5], np.float32)


def _case(kind):
    """(JAX model, variables, a fresh port module for them, JAX tx, port tx,
    JAX step, port step, batch) of one optimizer."""
    if kind == "adamw_schedule":  # train_segmentation's optimizer
        model, v, _ = _unet_pair()
        jtx = optax.adamw(JT.warmup_schedule(2, JT.cosine_decay_restarts(3e-3, 3, t_mul=1.0, m_mul=0.5)))
        ptx = T.adamw(T.warmup_schedule(2, T.cosine_decay_restarts(3e-3, 3, t_mul=1.0, m_mul=0.5)))

        def module():
            return load_flax_variables(build_unet_xception(1, (32, 32), filter_counts=FILTERS, device="cpu"), v)

        return (model, v, module, jtx, ptx, JT.make_unet_train_step(model, jtx),
                T.make_unet_train_step(ptx), _seg_batch(seed=4))
    model, v, _ = _resnet_pair()
    frozen = kind == "frozen_multi_transform"  # the two stages of two_stage_tl_fit
    jtx = JT.make_tl_optimizer(v["params"], 1e-2, base_trainable=not frozen)
    ptx = T.make_tl_optimizer(1e-2, base_trainable=not frozen)

    def module():
        return load_flax_variables(build_trainable_resnet50_tl(1, (32, 32, 3), LAYER, device="cpu"), v)

    return (model, v, module, jtx, ptx, JT.make_classifier_train_step(model, jtx),
            T.make_classifier_train_step(ptx), _cls_batch())


KINDS = ["adamw_schedule", "adam", "frozen_multi_transform"]


def _jax_bytes(state) -> bytes:
    import flax.serialization

    return flax.serialization.to_bytes({"params": state.params, "batch_stats": state.batch_stats,
                                        "opt_state": state.opt_state, "step": state.step})


def test_optax_layouts_of_the_three_optimizers():
    """``Optimizer.state_tree`` has the keys of optax's state dict."""
    import flax.serialization

    for kind in KINDS:
        _, v, _, jtx, ptx, *_ = _case(kind)
        ref = flax.serialization.to_state_dict(jtx.init(v["params"]))
        adam = {"count": 0, "mu": {}, "nu": {}}
        mine = ptx.state_tree(adam)

        def keys(t):
            return {k: keys(x) for k, x in t.items()} if isinstance(t, dict) else None

        ref_adam = ptx.adam_state(ref)
        assert set(ref_adam) == {"count", "mu", "nu"}, kind
        assert ptx.adam_state(mine) is adam
        assert ptx.adam_state(ref) is ref_adam
        ref_keys, mine_keys = keys(ref), keys(mine)
        for t in (ref_keys, mine_keys):  # the moments' trees are compared by the byte tests
            node = ptx.adam_state(t)
            node["mu"] = node["nu"] = None
        assert mine_keys == ref_keys, kind
    with pytest.raises(ValueError, match="multi_transform"):
        T.make_tl_optimizer(1e-3).adam_state({"0": {}})


@pytest.mark.parametrize("kind", KINDS)
def test_jax_writes_the_port_resumes(kind, tmp_path):
    model, v, module, jtx, ptx, jstep, pstep, batch = _case(kind)
    jstate, _ = jstep(JT.init_train_state(v, jtx), *batch)
    JT.save_train_state(tmp_path / "jax.msgpack", jstate)

    pstate = T.load_train_state(tmp_path / "jax.msgpack", T.init_train_state(module(), ptx))
    assert pstate.step == 1
    T.save_train_state(tmp_path / "port.msgpack", pstate)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()

    for tol in (1e-5, 1e-3):
        jstate, jm = jstep(jstate, *batch)
        pstate, pm = pstep(pstate, *batch)
        ref = float(jm["loss"])
        assert abs(pm["loss"].item() - ref) <= tol * ref, (kind, pm["loss"].item(), ref)
    assert pstate.step == int(jstate.step) == 3


@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_jax_resumes(kind, tmp_path):
    model, v, module, jtx, ptx, jstep, pstep, batch = _case(kind)
    pstate, _ = pstep(T.init_train_state(module(), ptx), *batch)
    T.save_train_state(tmp_path / "port.msgpack", pstate)

    jstate = JT.load_train_state(tmp_path / "port.msgpack", JT.init_train_state(v, jtx))
    assert int(jstate.step) == 1
    assert _jax_bytes(jstate) == (tmp_path / "port.msgpack").read_bytes()

    for tol in (1e-5, 1e-3):
        jstate, jm = jstep(jstate, *batch)
        pstate, pm = pstep(pstate, *batch)
        ref = float(jm["loss"])
        assert abs(pm["loss"].item() - ref) <= tol * ref, (kind, pm["loss"].item(), ref)
    if kind == "frozen_multi_transform":  # the JAX step leaves the base as the port wrote it
        for a, b in zip(jax.tree.leaves(jstate.params["base_model"]),
                        jax.tree.leaves(JT.load_train_state(tmp_path / "port.msgpack",
                                                            JT.init_train_state(v, jtx)).params["base_model"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fresh_state_writes_zero_moments(tmp_path):
    """Before any step: count 0, zero moments, and the JAX reader takes it."""
    from tmat_torch.models.params_io import load_variables

    model, v, module, jtx, ptx, *_ = _case("adam")
    T.save_train_state(tmp_path / "s.msgpack", T.init_train_state(module(), ptx))
    tree = load_variables(tmp_path / "s.msgpack")
    adam = ptx.adam_state(tree["opt_state"])
    assert int(adam["count"]) == 0 and int(tree["step"]) == 0
    assert all(not np.any(a) for a in jax.tree.leaves(adam["mu"]))
    jstate = JT.load_train_state(tmp_path / "s.msgpack", JT.init_train_state(v, jtx))
    assert int(jstate.opt_state[0].count) == 0
    with pytest.raises(ValueError, match="Optimizer"):
        T.save_train_state(tmp_path / "t.msgpack", T.TrainState(module(), None))
    with pytest.raises(ValueError, match="adamw"):  # an adam file into an adamw state
        T.load_train_state(tmp_path / "s.msgpack", T.init_train_state(module(), T.adamw(1e-3)))
