"""The port's checkpoint writer against ``flax.serialization.to_bytes`` and
``tmat_tpu/models/params_io.py::save_params`` / ``load_params``.

The bytes must be equal for the same tree of numpy arrays (with and
without the float16 down-cast), and a file the port writes must load
through the JAX reader, into the same forward (float32 logits within 1e-5
of the largest, as the eval models are held in ``test_torch_unet.py`` and
``test_torch_resnet.py``)."""

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from tmat_tpu.models.params_io import load_params, save_params as jax_save
from tmat_tpu.models.resnet import ResNet50TL as JaxResNet50TL, build_resnet50_tl as jax_resnet
from tmat_tpu.models.unet import build_unet_xception as jax_unet
from tmat_torch.models import params_io as P
from tmat_torch.models.layers import flax_variables
from tmat_torch.models.resnet import (build_resnet50_tl, build_trainable_resnet50_tl,
                                      ensemble_forward, load_member)
from tmat_torch.models.unet import UNetXception, build_unet_xception


def _trees():
    rng = np.random.RandomState(0)
    _, unet = jax_unet(1, (32, 32), filter_counts=(8, 16), init="zeros")
    return {
        "unet": jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), unet),
        "scalars": {"f": 0.25, "i": -40000, "big": 2**40, "small": -3, "u8": 200, "b": True,
                    "s": "x" * 40, "np64": np.float64(1.5), "npi": np.int32(-7),
                    "npb": np.bool_(False), "bytes": b"\x00\x01"},
        "arrays": {f"k{i}": np.arange(i, dtype=[np.int32, np.uint8, np.float16, np.float64][i % 4])
                   for i in range(20)}
                  | {"empty": np.zeros((0, 3)), "0d": np.array(3.0, np.float32),
                     "f16": rng.rand(2, 3).astype(np.float16), "big": rng.rand(300, 300),
                     "nd": np.zeros((1,) * 17, np.uint8)},
        "nested": {"a": {"b": {"c": np.ones(2)}, "d": [np.zeros(1), 3]}, "long": "y" * 70000,
                   "empty": {}},
        "step": {"params": {"w": rng.rand(4).astype(np.float32)}, "step": 7},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_bytes_equal_flax(name):
    tree = _trees()[name]
    assert P.to_msgpack(tree) == flax.serialization.to_bytes(tree)


@pytest.mark.parametrize("dtype", [None, np.float16])
def test_save_params_file_equal_jax(tmp_path, dtype):
    tree = _trees()["unet"]
    tree["batch_stats"]["count"] = np.int32(3)  # non-float leaves are not cast
    P.save_params(tmp_path / "port.msgpack", tree, dtype=dtype)
    jax_save(tmp_path / "jax.msgpack", tree, dtype=dtype)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    back = P.load_variables(tmp_path / "port.msgpack")
    assert back["batch_stats"]["count"] == 3
    tol = 0 if dtype is None else 1e-3
    np.testing.assert_allclose(back["params"]["Conv_0"]["kernel"], tree["params"]["Conv_0"]["kernel"],
                               rtol=tol, atol=tol)


def test_torch_leaves_and_bad_leaves():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert P.to_msgpack({"w": t}) == flax.serialization.to_bytes({"w": t.numpy()})
    with pytest.raises(TypeError):
        P.to_msgpack({"w": object()})


def test_jax_loads_the_port_unet_to_the_same_forward(tmp_path):
    """A trainable UNet's weights (seeded, BN statistics moved by a train
    forward) written by the port, read by the JAX ``load_params`` into a JAX
    template, give the port's eval forward; the port's own reader and its
    BN-folded inference model agree too."""
    filters = (8, 16)
    net = build_unet_xception(1, (32, 32), filter_counts=filters, seed=4, bn_momentum=0.5,
                              device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 1).astype(np.float32)
    net.train()
    net(torch.tensor(x))  # moves the running statistics off 0 / 1
    net.eval()
    path = tmp_path / "unet.msgpack"
    P.save_params(path, flax_variables(net))
    model, template = jax_unet(1, (32, 32), filter_counts=filters, init="zeros")
    ref = np.asarray(jax.jit(lambda v, b: model.apply(v, b, train=False))(load_params(path, template), x))
    with torch.no_grad():
        out = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    folded = UNetXception(P.from_flax_variables(P.load_variables(path), filters)).eval()
    np.testing.assert_allclose(folded(torch.tensor(x)).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_member_loads_in_both_packages(tmp_path, dtype):
    """A trainable ResNet member written as the trainer writes it (float16
    by default) loads through the JAX ``load_params`` and through the
    port's ``load_member`` / ``ensemble_forward`` to the same probabilities."""
    net = build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=2, device="cpu")
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 32, 32, 3) * 20).astype(np.float32)
    with torch.no_grad():  # a head that spreads the probabilities (Flax starts it at zero)
        feats = net.base_model(torch.tensor(x)).mean(dim=(1, 2))
        head = torch.tensor(rng.randn(256, 1).astype(np.float32))
        net.head.kernel.copy_(head / (feats - feats.mean(0)).matmul(head).std())
        net.head.bias.copy_(-(feats.mean(0) @ net.head.kernel))
    path = tmp_path / "member.msgpack"
    P.save_params(path, flax_variables(net), dtype=dtype)
    _, template = jax_resnet(1, (32, 32, 3), base_last_layer="conv2_block3_out", init="zeros")
    model = JaxResNet50TL(1, "conv2_block3_out")
    ref = np.asarray(jax.jit(lambda v, b: model.apply(v, b, train=False))(load_params(path, template), x))
    member = load_member(build_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", device="cpu"),
                         P.from_flax_resnet_variables(P.load_variables(path)))
    out = ensemble_forward([member], torch.tensor(x))[0].numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert 0 < ref.min() and ref.max() < 1 and np.ptp(ref) > 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float16])
def test_chunked_leaves_round_trip_with_flax(tmp_path, monkeypatch, dtype):
    """Flax splits array leaves over ``MAX_CHUNK_SIZE`` bytes into chunks;
    with the limit lowered (in both packages) the port reads the file JAX
    writes and writes the same bytes, and a leaf at the limit stays whole."""
    import flax.serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 100)
    monkeypatch.setattr(P, "_MAX_CHUNK_SIZE", 100)
    rng = np.random.RandomState(1)
    tree = {"params": {"big": (rng.rand(7, 11, 3) * 200).astype(dtype),
                       "edge": (rng.rand(100 // np.dtype(dtype).itemsize) * 9).astype(dtype),
                       "small": np.arange(5, dtype=np.int32)},
            "top": (rng.rand(60) * 9).astype(dtype)}
    jax_save(tmp_path / "jax.msgpack", tree)
    data = (tmp_path / "jax.msgpack").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    back = P.load_variables(tmp_path / "jax.msgpack")
    for key in ("big", "edge", "small"):
        np.testing.assert_array_equal(back["params"][key], tree["params"][key].astype(back["params"][key].dtype))
    np.testing.assert_array_equal(back["top"], tree["top"].astype(back["top"].dtype))
    assert back["params"]["big"].shape == (7, 11, 3)
    P.save_params(tmp_path / "port.msgpack", tree)
    assert (tmp_path / "port.msgpack").read_bytes() == data
    restored = fs.msgpack_restore(data)
    np.testing.assert_array_equal(restored["params"]["big"], tree["params"]["big"])
