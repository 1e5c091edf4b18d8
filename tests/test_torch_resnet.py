"""The port's ResNet50 classifier and its ingest against the JAX package.

Both packages get the same weights: Flax variables filled from a numpy
seed (random BatchNorm statistics), turned into the port's BN-folded
weights by ``from_flax_resnet_variables``. Tolerances: float32 logits
within 1e-5 of the largest, probabilities atol 1e-5; bfloat16 against
JAX's bfloat16 (the port folds BN into the convolution, so its rounding
points differ) within 2e-2; the host resize and the hybrid prep equal for
uint8 and within 1e-5 of the largest value for float32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.models import preprocess as jprep
from tmat_tpu.models.resnet import BN_EPS, ResNet50TL as JaxResNet50TL
from tmat_tpu.ops import resize as jresize
from tmat_torch.models import preprocess as tprep, resnet as tr
from tmat_torch.models.params_io import (RESNET_BN_EPS, from_flax_resnet_variables,
                                         load_variables)
from tmat_torch.ops import resize as tresize

SHIPPED_MEMBER = "model_training/best_ensemble/best_finetune_weights_0.msgpack"
# (last layer, input size): every truncation the JAX model offers, small inputs
CASES = [("conv5_block3_out", 64), ("conv5_block2_out", 48), ("conv5_block1_out", 40),
         ("conv4_block6_out", 32)]


def _rand_variables(last_layer, size, n_outputs=2, output_act="linear", seed=0):
    """A Flax ResNet50TL and its variables filled from a numpy seed: kernels
    scaled by 1/sqrt(fan-in), random biases, BN scales and statistics."""
    model = JaxResNet50TL(n_outputs=n_outputs, last_layer=last_layer, output_act=output_act)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "scale":
            v = rng.uniform(0.3, 0.8, a.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*a.shape)
        return np.asarray(v, np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _port(variables, last_layer, size, n_outputs=2, output_act="linear", dtype=torch.float32):
    net = tr.build_resnet50_tl(n_outputs, (size, size, 3), last_layer, output_act, dtype, init="zeros",
                               device="cpu")
    return tr.load_member(net, from_flax_resnet_variables(variables))


def _inputs(size, n=2, seed=1):
    """Caffe-normalised-like inputs: values in about -125..150."""
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 255 - 120).astype(np.float32)


@pytest.mark.parametrize("last_layer,size", CASES)
def test_forward_matches_flax_f32(last_layer, size):
    model, variables = _rand_variables(last_layer, size)
    x = _inputs(size)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x)))
    out = _port(variables, last_layer, size)(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (2, 2)
    np.testing.assert_allclose(out, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)
    # the probabilities the tool thresholds
    np.testing.assert_allclose(torch.sigmoid(torch.tensor(out)).numpy(),
                               np.asarray(jax.nn.sigmoid(ref)), atol=1e-5, rtol=0)


def test_sigmoid_and_softmax_heads():
    size, last = 32, "conv4_block6_out"
    for act, n in (("sigmoid", 1), ("softmax", 3)):
        model, variables = _rand_variables(last, size, n, act, seed=4)
        x = _inputs(size, 3)
        ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x)))
        out = _port(variables, last, size, n, act)(torch.tensor(x)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_forward_bf16_matches_flax_bf16():
    size, last = 48, "conv4_block6_out"
    _, variables = _rand_variables(last, size, 1, "sigmoid", seed=2)
    model = JaxResNet50TL(n_outputs=1, last_layer=last, output_act="sigmoid", dtype=jnp.bfloat16)
    x = _inputs(size, 4, seed=3)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x)))
    net = _port(variables, last, size, 1, "sigmoid", torch.bfloat16)
    assert net.base.conv1.weight.dtype == torch.bfloat16 and net.head.weight.dtype == torch.float32
    out = net(torch.tensor(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-2, rtol=0)


def test_keras_v1_layout():
    """Stride on the first 1x1 of a stage's first block (not the 3x3), a
    projection shortcut there only, 1024 channels at conv4_block6_out."""
    base = tr.ResNet50Base("conv4_block6_out")
    assert list(base.blocks) == [f"conv{s}_block{b}" for s, n in ((2, 3), (3, 4), (4, 6))
                                 for b in range(1, n + 1)]
    first = base.blocks["conv3_block1"]
    assert first.conv1.stride == (2, 2) and first.conv2.stride == (1, 1)
    assert first.conv0.stride == (2, 2) and base.blocks["conv3_block2"].conv0 is None
    assert base.out_channels == 1024
    with pytest.raises(ValueError):
        tr._parse_last_layer("conv4_block7_out")
    assert tr.LAST_LAYER_OPTIONS == tuple(c for c, _ in CASES)
    # odd sizes: the 1x1 stride-2 convolutions pad nothing, the pool pads -inf
    _, variables = _rand_variables("conv4_block6_out", 37, seed=6)
    x = _inputs(37, 1)
    model = JaxResNet50TL(n_outputs=2, last_layer="conv4_block6_out", output_act="linear")
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(x)))
    out = _port(variables, "conv4_block6_out", 37)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)


def test_from_flax_resnet_variables_on_the_shipped_member():
    variables = load_variables(SHIPPED_MEMBER)
    weights = from_flax_resnet_variables(variables)
    net = tr.build_resnet50_tl(1, (256, 256, 3), "conv4_block6_out", init="zeros", device="cpu")
    state = net.state_dict()
    assert set(weights) == set(state)
    assert all(weights[k].shape == tuple(state[k].shape) and weights[k].dtype == np.float32
               for k in weights)
    assert sum(v.size for v in weights.values()) == sum(t.numel() for t in state.values())
    assert RESNET_BN_EPS == BN_EPS
    tr.load_member(net, weights)
    # one conv + BN pair as Flax applies it, against the folded convolution
    p = variables["params"]["base_model"]["conv3_block1"]
    bs = variables["batch_stats"]["base_model"]["conv3_block1"]
    x = np.random.RandomState(0).randn(2, 9, 9, 256).astype(np.float32)
    conv = fnn.Conv(128, (1, 1), strides=2)
    bn = fnn.BatchNorm(use_running_average=True, epsilon=BN_EPS)
    y = conv.apply({"params": p["1_conv"]}, jnp.asarray(x))
    ref = np.asarray(bn.apply({"params": p["1_bn"], "batch_stats": bs["1_bn"]}, y))
    out = net.base.blocks["conv3_block1"].conv1(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4, rtol=1e-5)
    head = variables["params"]["head"]
    np.testing.assert_array_equal(net.head.weight.numpy(), head["kernel"].T)
    with pytest.raises(ValueError, match="do not fit"):
        tr.load_member(tr.build_resnet50_tl(1, (64, 64, 3), "conv5_block1_out", init="zeros", device="cpu"),
                       weights)


@pytest.mark.parametrize("in_size,out_size", [(1024, 256), (80, 64), (64, 64), (50, 96)])
def test_lanczos4_weight_matrix_and_host_resize(in_size, out_size):
    np.testing.assert_array_equal(tresize.lanczos4_weight_matrix(in_size, out_size),
                                  jresize._lanczos_weight_matrix(in_size, out_size))
    rng = np.random.RandomState(in_size)
    stack = (rng.rand(3, in_size, in_size + 6) * 255).astype(np.float32)
    shape = (out_size, out_size + 2)
    np.testing.assert_array_equal(tresize.resize_lanczos4_host(stack, shape),
                                  jresize.resize_lanczos4_host(stack, shape))


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_hybrid_prep_matches_jax(dtype):
    rng = np.random.RandomState(7)
    top = {"uint8": 255, "uint16": 4095, "float32": 1.0}[dtype]
    stack = (rng.rand(3, 80, 72) * top).astype(dtype)
    stack[1] = stack[1] // 2 if dtype != "float32" else stack[1] / 2  # a slice with its own range
    resized = tprep.host_resize(stack, (64, 64))
    assert resized.dtype == (np.float32 if dtype == "float32" else np.dtype(dtype))
    ref = np.asarray(jprep.prep_inv_depth_imgs_hybrid(stack, (64, 64)))
    out = tprep.prep_inv_depth_imgs_hybrid(stack, (64, 64), "cpu").numpy()
    assert out.shape == ref.shape == (3, 64, 64, 3)
    if dtype == "uint8":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5 * 255, rtol=0)
    # a single 2-D image is a stack of one
    one = tprep.prep_inv_depth_imgs_hybrid(stack[0], (64, 64), "cpu").numpy()
    ref_one = np.asarray(jprep.prep_inv_depth_imgs_hybrid(stack[0], (64, 64)))
    assert one.shape == ref_one.shape == (1, 64, 64, 3)
    if dtype == "uint8":
        np.testing.assert_array_equal(one, ref_one)
    else:
        np.testing.assert_allclose(one, ref_one, atol=1e-5 * 255, rtol=0)


def test_device_prep_matches_jax():
    stack = (np.random.RandomState(8).rand(2, 100, 90) * 255).astype(np.uint8)
    ref = np.asarray(jprep.prep_inv_depth_imgs(jnp.asarray(stack), (64, 64)))
    out = tprep.prep_inv_depth_imgs(torch.tensor(stack), (64, 64)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * 255, rtol=0)
    x = np.random.RandomState(9).rand(2, 5, 5, 3).astype(np.float32) * 255
    np.testing.assert_allclose(tprep.resnet50_preprocess(torch.tensor(x)).numpy(),
                               np.asarray(jprep.resnet50_preprocess(jnp.asarray(x))), atol=1e-5)


def test_ensemble_forward_stacks_members():
    size, last = 32, "conv4_block6_out"
    nets = []
    for seed in (0, 1):
        _, v = _rand_variables(last, size, 1, "sigmoid", seed=seed)
        nets.append(_port(v, last, size, 1, "sigmoid"))
    x = torch.tensor(_inputs(size, 3))
    out = tr.ensemble_forward(nets, x)
    assert out.shape == (2, 3, 1) and out.dtype == torch.float32
    for k, net in enumerate(nets):
        torch.testing.assert_close(out[k], net(x), atol=0, rtol=0)
