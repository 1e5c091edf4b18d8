"""The port's from-scratch inits against Flax's ``model.init(PRNGKey(seed))``
in the JAX package, leaf by leaf.

``build_unet_xception`` (the trainable UNet) and
``build_trainable_resnet50_tl`` draw every kernel from the key Flax gives it
(``core/prng.py``: threefry, Flax's SHA-1 path keys, XLA's float32
truncated normal). Held to: the same tree, names, key order and shapes, and
every leaf bit-equal to the JAX package's builder with the same seed.
"""

import numpy as np
import pytest
import torch

from tmat_tpu.models.resnet import build_resnet50_tl as jax_resnet
from tmat_tpu.models.unet import build_unet_xception as jax_unet
from tmat_torch.models.layers import flatten_tree, flax_variables
from tmat_torch.models.params_io import from_flax_resnet_variables
from tmat_torch.models.resnet import build_resnet50_tl, build_trainable_resnet50_tl
from tmat_torch.models.unet import build_unet_xception


def assert_same_variables(port: dict, ref: dict) -> None:
    """Same collections, leaf names in the same order, shapes, float32
    values bit for bit."""
    assert list(port) == list(ref) == ["params", "batch_stats"]
    for col in port:
        p, r = flatten_tree(port[col]), flatten_tree(dict(ref[col]))
        assert list(p) == list(r), col
        for name in p:
            a, b = p[name], np.asarray(r[name])
            assert a.shape == b.shape and b.dtype == np.float32, name
            np.testing.assert_array_equal(a, b, err_msg=name)


FILTERS = (8, 16, 32)


@pytest.mark.parametrize("seed", [0, 3, -1])
def test_unet_init_equals_flax(seed):
    filters = FILTERS
    _, ref = jax_unet(1, (32, 32), channels=1, filter_counts=filters, seed=seed)
    port = build_unet_xception(1, (32, 32), channels=1, filter_counts=filters, seed=seed, device="cpu")
    assert_same_variables(flax_variables(port), ref)
    kernels = [k for k in flatten_tree(ref["params"]) if k.endswith(".kernel")]
    assert len(kernels) == 2 + 5 * (len(filters) - 1) + 3 * len(filters)  # entry, down, up, head


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_unet_dtype_and_zeros_init(dtype):
    """``dtype`` is the compute dtype: every leaf is Flax's float32 init
    cast to it, bit for bit, and the forward in it is within the dtype's
    reach of the JAX model's float32 forward (float64 1e-6, bfloat16 0.05).
    ``init="zeros"`` gives JAX's all-zero tree."""
    import jax.numpy as jnp

    model, ref = jax_unet(1, (32, 32), filter_counts=FILTERS, seed=2)
    port = build_unet_xception(1, (32, 32), filter_counts=FILTERS, dtype=dtype, seed=2, device="cpu")
    assert all(t.dtype == dtype for t in port.state_dict().values())
    cast = {c: {k: torch.tensor(np.asarray(v)).to(dtype).float().numpy()
                for k, v in flatten_tree(dict(ref[c])).items()} for c in ref}
    got = flax_variables(port)  # float32 copies
    for c in cast:
        for name, want in cast[c].items():
            np.testing.assert_array_equal(flatten_tree(got[c])[name], want, err_msg=name)
    x = np.random.RandomState(0).rand(2, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        out = port.eval()(torch.tensor(x)).float().numpy()
    want = np.asarray(model.apply(ref, jnp.asarray(x), train=False))
    np.testing.assert_allclose(out, want, atol=1e-6 if dtype == torch.float64 else 0.05, rtol=0)
    _, zeros = jax_unet(1, (32, 32), filter_counts=FILTERS, init="zeros")  # its keys sorted
    got = flax_variables(build_unet_xception(1, (32, 32), filter_counts=FILTERS, init="zeros", device="cpu"))
    for c in ("params", "batch_stats"):
        want = flatten_tree(dict(zeros[c]))
        assert set(flatten_tree(got[c])) == set(want)
        for name, a in flatten_tree(got[c]).items():
            np.testing.assert_array_equal(a, np.asarray(want[name]), err_msg=name)
    with pytest.raises(ValueError, match="init"):
        build_unet_xception(1, (32, 32), filter_counts=FILTERS, init="ones", device="cpu")


def test_unet_seeds_differ():
    a = flax_variables(build_unet_xception(1, (32, 32), filter_counts=FILTERS, seed=1, device="cpu"))
    b = flax_variables(build_unet_xception(1, (32, 32), filter_counts=FILTERS, seed=2, device="cpu"))
    assert not np.array_equal(a["params"]["Conv_0"]["kernel"], b["params"]["Conv_0"]["kernel"])


@pytest.mark.parametrize("seed", [0, 1234])
def test_resnet_init_equals_flax(seed):
    """The whole ResNet50 (its ~23.5M parameters) and the zero head; the
    inference classifier of ``build_resnet50_tl(seed=seed)`` holds the same
    init with its BatchNorm folded, bit for bit."""
    _, ref = jax_resnet(1, (32, 32, 3), seed=seed)
    port = build_trainable_resnet50_tl(1, (32, 32, 3), seed=seed, device="cpu")
    assert_same_variables(flax_variables(port), ref)
    assert not port.head.kernel.any() and not port.head.bias.any()
    assert float(port.base_model.conv1_conv.kernel.detach().std()) > 0
    folded = from_flax_resnet_variables({c: {k: dict(v) for k, v in ref[c].items()} for c in ref})
    state = build_resnet50_tl(1, (32, 32, 3), seed=seed, device="cpu").state_dict()
    assert set(state) == set(folded)
    for name, t in state.items():
        np.testing.assert_array_equal(t.numpy(), folded[name], err_msg=name)


def test_truncated_resnet_init_equals_flax():
    _, ref = jax_resnet(1, (32, 32, 3), base_last_layer="conv3_block1_out", seed=9)
    port = build_trainable_resnet50_tl(1, (32, 32, 3), "conv3_block1_out", seed=9, device="cpu")
    assert_same_variables(flax_variables(port), ref)


def test_init_draws_no_torch_generator(monkeypatch):
    """The kernels come from the threefry streams alone: torch's own
    generators are never drawn from."""
    def refuse(*a, **k):
        raise AssertionError("torch's generator was used")

    for name in ("rand", "randn", "normal", "manual_seed"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", refuse)
    port = build_unet_xception(1, (32, 32), filter_counts=FILTERS, seed=5, device="cpu")
    _, ref = jax_unet(1, (32, 32), filter_counts=FILTERS, seed=5)
    np.testing.assert_array_equal(port.state_dict()["Conv_0.kernel"].numpy(),
                                  np.asarray(ref["params"]["Conv_0"]["kernel"]))
