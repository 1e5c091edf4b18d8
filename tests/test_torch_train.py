"""The port's trainable models, steps, schedules, optimizer state and fit
loops against the JAX package (``tmat_tpu/models/train.py``).

Both packages get the same variables (Flax trees filled from a numpy seed,
carried over through ``load_flax_variables``) and the same numpy batches.
Tolerances:

- one step: the loss within 1e-5 relative; BatchNorm running statistics
  within 1e-6; each leaf's gradient within 1e-4 of that leaf's largest
  |g|, floored at 1e-2 of the model's largest |g| (a bias in front of a
  BatchNorm has a zero gradient, so only rounding noise). The UNet's
  train-mode gradients are held against the JAX function evaluated in
  float64: Flax's batch variance E[x²] − E[x]² cancels in float32, and
  with Flax's own init JAX's float32 gradients sit more than 1e-3 off its
  float64 ones (``test_jax_float32_batchnorm_cancels``), where the port's
  float32 gradients stay within 1e-4;
- five AdamW steps under a warmup schedule: losses within 1e-3 relative;
- schedules: within 5e-7 relative (numpy's and XLA's float32 cos and log1p
  differ by an ulp at some steps); metrics within 1e-6;
- the frozen stage's base and resume on the CPU: bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import optax
import pytest
import torch

from tmat_tpu.models import train as JT
from tmat_tpu.models.resnet import build_resnet50_tl as jax_resnet
from tmat_tpu.models.unet import UNetXception as JaxUNet, build_unet_xception as jax_unet
from tmat_torch.models import train as T
from tmat_torch.models.layers import flax_variables, load_flax_variables
from tmat_torch.models.resnet import build_trainable_resnet50_tl
from tmat_torch.models.unet import build_unet_xception

FILTERS = (8, 16)
LAYER = "conv2_block3_out"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(a)
            for path, a in tu.tree_flatten_with_path(tree)[0]}


def _seg_batch(seed=0, n=4, hw=32):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, hw, hw, 1).astype(np.float32)
    y = np.zeros((n, hw, hw, 1), np.float32)
    y[:, hw // 4: 3 * hw // 4, hw // 4: 3 * hw // 4] = 1.0
    w = np.where(y > 0, 2.0, 0.5).astype(np.float32)
    return x, y, w


def _fill(shapes, seed, head_std=None):
    """Flax-like variables from a numpy seed: kernels N(0, 1/fan-in) (the
    head's ``head_std``), zero biases, unit BN scales, statistics 0 / 1 (or
    random, with ``head_std``, so that a frozen-BN base passes gradients)."""
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            std = head_std if path[0].key == "params" and path[1].key == "head" else None
            v = rng.randn(*a.shape) * (std or np.sqrt(1.0 / np.prod(a.shape[:-1])))
        elif name == "scale":
            v = np.ones(a.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, a.shape) if head_std else np.ones(a.shape)
        elif name == "mean" and head_std:
            v = 0.1 * rng.randn(*a.shape)
        else:
            v = np.zeros(a.shape)
        return np.asarray(v, np.float32)

    return tu.tree_map_with_path(fill, shapes)


def _unet_pair(bn_momentum=0.9, seed=0):
    model, shapes = jax_unet(1, (32, 32), filter_counts=FILTERS, bn_momentum=bn_momentum,
                             init="zeros")
    v = _fill(shapes, seed)
    net = build_unet_xception(1, (32, 32), filter_counts=FILTERS, bn_momentum=bn_momentum,
                              device="cpu")
    return model, v, load_flax_variables(net, v)


def _resnet_pair(seed=0):
    """A Flax ResNet50TL truncated at conv2_block3_out and the port's twin
    with the same variables: a random head (Flax starts it at zero) and
    random BN statistics, so that every leaf has a gradient."""
    model, shapes = jax_resnet(1, (32, 32, 3), base_last_layer=LAYER, init="zeros")
    v = _fill(shapes, seed, head_std=0.05)
    net = build_trainable_resnet50_tl(1, (32, 32, 3), LAYER, device="cpu")
    return model, v, load_flax_variables(net, v)


def _assert_grads(port_grads, ref_grads):
    gmax = max(np.abs(a).max() for a in ref_grads.values())
    assert set(port_grads) == set(ref_grads)
    for k, ref in ref_grads.items():
        tol = 1e-4 * max(np.abs(ref).max(), 1e-2 * gmax)
        np.testing.assert_allclose(port_grads[k], ref, atol=tol, rtol=0, err_msg=k)


# --------------------------------------------------------------------------
# the Flax tree of the trainable models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["unet", "resnet"])
def test_flax_variables_round_trip(kind):
    if kind == "unet":
        _, v = jax_unet(1, (32, 32), filter_counts=FILTERS, init="zeros")
        net = build_unet_xception(1, (32, 32), filter_counts=FILTERS, seed=3, device="cpu")
    else:
        _, v = jax_resnet(1, (32, 32, 3), base_last_layer=LAYER, init="zeros")
        net = build_trainable_resnet50_tl(1, (32, 32, 3), LAYER, seed=3, device="cpu")
    tree = flax_variables(net)
    # Flax's names, nesting and key order (the init's creation order), shapes
    assert jax.tree.structure(tree) == jax.tree.structure(v)
    assert _flat(tree).keys() == _flat(v).keys()
    assert list(_flat(tree)) == list(_flat(v))
    for k, a in _flat(v).items():
        assert _flat(tree)[k].shape == a.shape and _flat(tree)[k].dtype == np.float32, k
    # out and back: exact
    rng = np.random.RandomState(1)
    filled = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
    out = flax_variables(load_flax_variables(net, filled))
    for k, a in _flat(filled).items():
        np.testing.assert_array_equal(_flat(out)[k], a, err_msg=k)
    with pytest.raises(ValueError, match="do not fit"):
        load_flax_variables(net, {"params": {}, "batch_stats": {}})


@pytest.mark.parametrize("kind", ["unet", "resnet"])
def test_init_draws_flax_distributions(kind):
    """Truncated lecun-normal kernels, zero biases, unit BN scales; the
    ResNet's head at zero; the same seed draws the same weights."""
    build = ((lambda s: build_unet_xception(1, (64, 64), filter_counts=(16, 32, 64), seed=s,
                                            device="cpu")) if kind == "unet" else
             (lambda s: build_trainable_resnet50_tl(1, (32, 32, 3), LAYER, seed=s, device="cpu")))
    net = build(5)
    for name, p in net.named_parameters():
        t = p.detach().numpy()
        leaf = name.rsplit(".", 1)[-1]
        if name == "head.kernel" or leaf == "bias":
            assert not t.any(), name
        elif leaf == "scale":
            assert (t == 1).all(), name
        else:
            std = np.sqrt(1.0 / np.prod(t.shape[:-1])) / 0.87962566103423978
            assert np.abs(t).max() <= 2 * std + 1e-7, name
            if t.size >= 2000:
                assert abs(t.std() / np.sqrt(1.0 / np.prod(t.shape[:-1])) - 1) < 0.1, name
    for (n1, a), (_, b) in zip(net.state_dict().items(), build(5).state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n1)
    assert not torch.equal(net.state_dict()[next(iter(net.state_dict()))],
                           build(6).state_dict()[next(iter(net.state_dict()))])


# --------------------------------------------------------------------------
# one step against the JAX step
# --------------------------------------------------------------------------


def _port_unet_grads(net, x, y, w):
    net.train()
    out = net(torch.tensor(x))
    loss = T.weighted_bce(out, torch.tensor(y), torch.tensor(w))
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in net.named_parameters()}


def test_unet_train_step_matches_jax():
    model, v, net = _unet_pair()
    x, y, w = _seg_batch()

    def jloss(params, variables, xx, yy, ww, mod):
        out, mut = mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                             train=True, mutable=["batch_stats"])
        return JT.weighted_bce(out, yy, ww), mut

    (ref_loss, mut), _ = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, v, x, y, w, model), has_aux=True))(v["params"])
    with jax.enable_x64():  # the same function in float64
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        m64 = JaxUNet(1, FILTERS, bn_momentum=0.9, dtype=jnp.float64)
        g64 = _flat(jax.jit(jax.grad(lambda p: jloss(
            p, v64, x.astype(np.float64), y.astype(np.float64), w.astype(np.float64), m64)[0]))(
                v64["params"]))
    loss, grads = _port_unet_grads(net, x, y, w)
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    _assert_grads(grads, g64)
    stats = _flat(flax_variables(net)["batch_stats"])
    for k, a in _flat(mut["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], a, atol=1e-6, rtol=0, err_msg=k)
    # the same step through the step function moves the same statistics
    _, _, net2 = _unet_pair()
    state = T.init_train_state(net2, T.adam(1e-3))
    state, metrics = T.make_unet_train_step(T.adam(1e-3))(state, x, y, w)
    assert state.step == 1 and abs(metrics["loss"].item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    for k, a in _flat(flax_variables(net2)["batch_stats"]).items():
        np.testing.assert_allclose(a, stats[k], atol=1e-7, rtol=0, err_msg=k)


def test_unet_float64_step_matches_jax():
    """The port's UNet as a float64 reference (``.double()``: the input cast
    to the weights' dtype, float64 kernels in the default layout), as
    ``chip_smoke.py`` holds the card's float32 gradients to it, against
    JAX's float64 step. Both round the logits to float32, where a last-bit
    difference of the float64 sums can flip a rounding: loss within 1e-8
    relative, gradients within 1e-7 of the largest (the chip check's
    smallest tolerance is 1e-6 of it; float32 steps sit near 1e-4)."""
    model, v, net = _unet_pair()
    x, y, w = _seg_batch()
    net = net.double()

    def jloss(params, variables, mod):
        out = mod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        x.astype(np.float64), train=True, mutable=["batch_stats"])[0]
        return JT.weighted_bce(out, y.astype(np.float64), w.astype(np.float64))

    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        m64 = JaxUNet(1, FILTERS, bn_momentum=0.9, dtype=jnp.float64)
        ref_loss, g64 = jax.jit(jax.value_and_grad(lambda p: jloss(p, v64, m64)))(v64["params"])
        ref_loss, g64 = float(ref_loss), _flat(g64)
    net.train()
    out = net(torch.tensor(x, dtype=torch.float64))
    assert out.dtype == torch.float32 and net.Conv_0.kernel.dtype == torch.float64
    loss = T.weighted_bce(out, torch.tensor(y, dtype=torch.float64), torch.tensor(w, dtype=torch.float64))
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-8 * abs(ref_loss)
    gmax = max(np.abs(a).max() for a in g64.values())
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g64[k], atol=1e-7 * gmax, rtol=0, err_msg=k)


def test_jax_float32_batchnorm_cancels():
    """Why the UNet's gradients are held in float64: with Flax's own init
    (seed 0) JAX's float32 train-mode gradients sit far from its float64
    ones in the first layers, while the port's float32 gradients do not."""
    model = JaxUNet(1, FILTERS, bn_momentum=0.9)
    v = _np(jax.jit(lambda k, d: model.init(k, d, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 1), np.float32)))
    net = load_flax_variables(build_unet_xception(1, (32, 32), filter_counts=FILTERS,
                                                  bn_momentum=0.9, device="cpu"), v)
    rng = np.random.RandomState(0)
    x = rng.rand(4, 32, 32, 1).astype(np.float32)
    y = (rng.rand(4, 32, 32, 1) > 0.5).astype(np.float32)
    w = np.ones_like(y)

    def jloss(params, variables, mod, xx, yy, ww):
        out = mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                        train=True, mutable=["batch_stats"])[0]
        return JT.weighted_bce(out, yy, ww)

    g32 = _flat(jax.jit(jax.grad(lambda p: jloss(p, v, model, x, y, w)))(v["params"]))
    with jax.enable_x64():
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        m64 = JaxUNet(1, FILTERS, bn_momentum=0.9, dtype=jnp.float64)
        x64, y64, w64 = (a.astype(np.float64) for a in (x, y, w))
        g64 = _flat(jax.jit(jax.grad(lambda p: jloss(p, v64, m64, x64, y64, w64)))(v64["params"]))
    _, port = _port_unet_grads(net, x, y, w)

    def rel(g, k):
        return np.abs(g[k] - g64[k]).max() / np.abs(g64[k]).max()

    kernels = [k for k in g64 if k.endswith("kernel")]
    assert max(rel(g32, k) for k in kernels) > 1e-3
    assert max(rel(port, k) for k in kernels) < 1e-4


def test_resnet_step_matches_jax():
    """The classifier's step (frozen-BN base) against the JAX one, all leaves."""
    model, v, net = _resnet_pair()
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 32, 32, 3) * 20).astype(np.float32)
    y = np.array([[0.0], [1.0], [1.0], [0.0]], np.float32)
    w = np.array([1.0, 2.0, 1.0, 0.5])

    def jloss(params):
        out = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True)
        return JT.weighted_bce(out, y, w)

    ref_loss, g = jax.jit(jax.value_and_grad(jloss))(v["params"])
    net.train()
    loss = T.weighted_bce(net(torch.tensor(x)), torch.tensor(y), torch.tensor(w, dtype=torch.float32))
    loss.backward()
    assert 0.1 < float(ref_loss) < 5
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * float(ref_loss)
    _assert_grads({k: p.grad.numpy() for k, p in net.named_parameters()}, _flat(g))
    # train mode never touches the base's statistics
    for k, a in _flat(flax_variables(net)["batch_stats"]).items():
        np.testing.assert_array_equal(a, _flat(v["batch_stats"])[k])


def test_five_adamw_steps_follow_optax():
    model, v, net = _unet_pair()
    x, y, w = _seg_batch(seed=4)
    jsched = JT.warmup_schedule(2, JT.cosine_decay_restarts(3e-3, 3, t_mul=1.0, m_mul=0.5))
    tsched = T.warmup_schedule(2, T.cosine_decay_restarts(3e-3, 3, t_mul=1.0, m_mul=0.5))
    tx = optax.adamw(jsched)
    jstate, jstep = JT.init_train_state(v, tx), JT.make_unet_train_step(model, tx)
    ptx = T.adamw(tsched)
    pstate, pstep = T.init_train_state(net, ptx), T.make_unet_train_step(ptx)
    for i in range(5):
        jstate, jm = jstep(jstate, x, y, w)
        pstate, pm = pstep(pstate, x, y, w)
        ref = float(jm["loss"])
        assert abs(pm["loss"].item() - ref) <= 1e-3 * ref, (i, pm["loss"].item(), ref)
        assert abs(pm["mean_iou_coef"].item() - float(jm["mean_iou_coef"])) <= 1e-3
    assert pstate.step == 5 and float(jm["loss"]) < 0.95 * float(jstep(JT.init_train_state(v, tx), x, y, w)[1]["loss"])


# --------------------------------------------------------------------------
# schedules, metrics, losses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda M: M.warmup_schedule(10, 1e-3),
    lambda M: M.warmup_schedule(5, M.cosine_decay_restarts(1e-2, 7, t_mul=1.0, m_mul=0.5)),
    lambda M: M.cosine_decay_restarts(1.0, 10, t_mul=2.0, m_mul=0.7, alpha=0.1),
    lambda M: M.cosine_decay_restarts(1e-3, 33, t_mul=1.0, m_mul=0.5),
], ids=["warmup_const", "warmup_cosine", "geometric", "linear"])
def test_schedules_equal_jax(make):
    ref = np.array([float(make(JT)(i)) for i in range(300)])
    out = np.array([float(make(T)(i)) for i in range(300)])
    np.testing.assert_allclose(out, ref, rtol=5e-7, atol=0)
    assert (out > 0).all()


def test_metrics_and_losses_equal_jax():
    rng = np.random.RandomState(7)
    y = (rng.rand(3, 8, 8, 1) > 0.6).astype(np.float32)
    p = rng.rand(3, 8, 8, 1).astype(np.float32)
    p[0, 0, 0, 0], p[0, 0, 1, 0] = 0.0, 1.0  # clipped ends
    pix_w = rng.rand(3, 8, 8, 1).astype(np.float32)
    pt, yt = torch.tensor(p), torch.tensor(y)
    np.testing.assert_allclose(T.mean_iou_coef(yt, pt).item(), float(JT.mean_iou_coef(y, p)), rtol=1e-6)
    np.testing.assert_allclose(T.weighted_bce(pt, yt).item(), float(JT.weighted_bce(p, y)), rtol=1e-6)
    np.testing.assert_allclose(T.weighted_bce(pt, yt, torch.tensor(pix_w)).item(),
                               float(JT.weighted_bce(p, y, pix_w)), rtol=1e-6)
    cls_p, cls_y = p[:, 0, 0, :1] * 0.8 + 0.1, y[:, 0, 0, :1]
    sample_w = np.array([2.0, 1.0, 0.5])  # per sample, aligned on the batch axis
    np.testing.assert_allclose(
        T.weighted_bce(torch.tensor(cls_p), torch.tensor(cls_y), sample_w).item(),
        float(JT.weighted_bce(cls_p, cls_y, sample_w)), rtol=1e-6)


# --------------------------------------------------------------------------
# transfer learning, resume, fit
# --------------------------------------------------------------------------


def test_frozen_stage_leaves_the_base_bit_equal():
    _, v, net = _resnet_pair()
    before = {k: t.clone() for k, t in net.state_dict().items()}
    tx = T.make_tl_optimizer(1e-2, base_trainable=False)
    state = T.init_train_state(net, tx)
    step = T.make_classifier_train_step(tx)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    y = np.array([[0.0], [1.0]], np.float32)
    for _ in range(3):
        state, metrics = step(state, x, y)
    after = net.state_dict()
    for k, t in before.items():
        if k.startswith("base_model."):
            assert torch.equal(after[k], t), k
    assert not torch.equal(after["head.kernel"], before["head.kernel"])
    assert all(not p.requires_grad for n, p in net.named_parameters() if n.startswith("base_model."))
    # the fine-tune optimizer trains the base again
    T.init_train_state(net, T.make_tl_optimizer(1e-3, base_trainable=True))
    assert all(p.requires_grad for p in net.parameters())


def test_two_stage_fit_frozen_then_fine_tune():
    _, _, net = _resnet_pair()
    base0 = {k: t.clone() for k, t in net.state_dict().items() if k.startswith("base_model.")}
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    y = np.array([[0.0], [1.0]], np.float32)
    state, frozen_res, ft_res = T.two_stage_tl_fit(
        net, lambda: [(x, y)], None, frozen_lr=1e-3, fine_tune_lr=1e-4,
        frozen_epochs=2, fine_tune_epochs=1)
    assert len(frozen_res.history["loss"]) == 2 and len(ft_res.history["loss"]) == 1
    changed = [k for k, t in base0.items() if not torch.equal(state.module.state_dict()[k], t)]
    assert changed and all(not k.endswith((".mean", ".var")) for k in changed)


def test_resume_bitexact(tmp_path):
    """The counterpart of tests/test_resume.py."""
    _, v, _ = _unet_pair()
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 1).astype(np.float32)
    y = (x > 0.5).astype(np.float32)

    def fresh():
        net = build_unet_xception(1, (32, 32), filter_counts=FILTERS, device="cpu")
        return T.init_train_state(load_flax_variables(net, v), T.adamw(1e-3))

    step = T.make_unet_train_step(T.adamw(1e-3))
    state, _ = step(fresh(), x, y)
    state, _ = step(state, x, y)
    path = tmp_path / "resume.msgpack"
    T.save_train_state(path, state)
    restored = T.load_train_state(path, fresh())
    assert restored.step == state.step == 2
    for (k, a), (_, b) in zip(state.module.state_dict().items(), restored.module.state_dict().items()):
        assert torch.equal(a, b), k
    cont_orig, _ = step(state, x, y)
    cont_rest, _ = step(restored, x, y)
    for (k, a), (_, b) in zip(cont_orig.module.state_dict().items(),
                              cont_rest.module.state_dict().items()):
        assert torch.equal(a, b), k
    # the file's weights are the Flax tree the JAX reader takes
    from tmat_torch.models.params_io import load_variables

    tree = load_variables(path)
    assert set(tree) == {"params", "batch_stats", "opt_state", "step"}
    assert tree["opt_state"]["0"]["count"] == 2  # optax.adamw's state: scale_by_adam first


def test_fit_early_stopping_checkpoint_and_best_copy(tmp_path):
    _, v, net = _unet_pair()
    x, y, _ = _seg_batch(n=2)
    tx = T.adam(1e-3)
    ckpt = tmp_path / "best.msgpack"
    state, result, best = T.fit(T.init_train_state(net, tx), T.make_unet_train_step(tx),
                                T.make_unet_eval_step(), lambda: [(x, y, None)],
                                lambda: [(x, y)], epochs=4, monitor="val_loss",
                                checkpoint_path=str(ckpt))
    assert ckpt.is_file() and len(result.history["loss"]) == 4 and "val_loss" in result.history
    # the best state is a copy taken at its epoch, not the live module
    assert best is not None and best.module is not state.module and best.opt is None
    if result.best_epoch < 3:
        assert not torch.equal(best.module.state_dict()["Conv_0.kernel"],
                               state.module.state_dict()["Conv_0.kernel"])
    # the checkpoint holds the best epoch's weights and loads in the JAX package
    from tmat_tpu.models.params_io import load_params

    loaded = _flat(load_params(ckpt, v))
    for k, a in _flat(flax_variables(best.module)).items():
        np.testing.assert_array_equal(loaded[k], a, err_msg=k)
    # an absent monitored metric ranks worst: no best, no checkpoint
    _, res, none = T.fit(T.init_train_state(net, tx), T.make_unet_train_step(tx), None,
                         lambda: [(x, y)], None, epochs=2, monitor="val_loss", patience=0)
    assert none is None and len(res.history["loss"]) == 1


def test_grid_search_persists_best(tmp_path):
    x, y, _ = _seg_batch(n=2)
    search = T.UNetXceptionGridSearch(str(tmp_path), [(4, 8), (8, 16)], [lambda: T.adam(1e-3)],
                                      1, (32, 32), device="cpu")
    best_fc, best = search.search("loss", "min", lambda: [(x, y, None)], epochs=2)
    assert best_fc in ((4, 8), (8, 16)) and len(search.histories) == 2
    meta = json.loads((tmp_path / "best_model_hps.json").read_text())
    assert meta["best_hps"]["filter_counts"] == list(best_fc) and meta["best_score"] == best
    assert (tmp_path / "best_weights_config_0.msgpack").is_file()
