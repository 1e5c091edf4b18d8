"""The port's pure-Python checkpoint reader and BN folding against the JAX
package (``load_params``, ``extract_fused_params``)."""

from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest

from tmat_tpu.core import defs
from tmat_tpu.models.params_io import load_params, save_params
from tmat_tpu.models.unet import build_unet_xception
from tmat_tpu.ops.pallas_unet import extract_fused_params
from tmat_torch.models import params_io as tio

SHIPPED = ((64, 128, 256, 512), 320)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_shipped_checkpoint_equals_load_params():
    path = Path(defs.model_training_path("binary_segmentation/checkpoints/checkpoint_1.msgpack"))
    assert path.is_file(), "the shipped segmentor checkpoint is part of the repo"
    filters, patch = SHIPPED
    _, template = build_unet_xception(1, (patch, patch), filter_counts=filters, init="zeros")
    ref = _flat(jax.tree.map(np.asarray, load_params(path, template)))
    out = _flat(tio.load_variables(path))
    assert set(out) == set(ref) and len(ref) > 50
    for key, a in ref.items():
        assert out[key].dtype == np.float32 and out[key].shape == a.shape, key
        np.testing.assert_array_equal(out[key], a, err_msg=str(key))


def _rand_variables(filters, patch, seed):
    _, shapes = build_unet_xception(1, (patch, patch), filter_counts=filters, init="zeros")
    rng = np.random.RandomState(seed)

    def fill(path, a):
        lo = 0.2 if path[-1].key in ("scale", "var") else -1.0
        return np.asarray(rng.uniform(lo, 1.5, a.shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("filters,patch", [((8, 16), 32), ((4, 8, 16), 32)])
def test_bn_folding_equals_extract_fused_params(filters, patch):
    v = _rand_variables(filters, patch, seed=11)

    def flat(folded):  # the block lists become {index: block}
        return _flat({k: (dict(enumerate(x)) if isinstance(x, list) else x) for k, x in folded.items()})

    out, ref = flat(tio.from_flax_variables(v, filters)), flat(extract_fused_params(v, filters))
    assert set(out) == set(ref)
    for key, a in ref.items():
        np.testing.assert_array_equal(out[key], np.asarray(a, np.float32), err_msg=str(key))


@pytest.mark.parametrize("dtype", [None, np.float16])
def test_saved_variables_round_trip(tmp_path, dtype):
    """Leaves saved by ``save_params`` (f16-stored too) read back cast up
    to float32, equal to the JAX package's load."""
    v = _rand_variables((8, 16), 32, seed=2)
    path = tmp_path / "v.msgpack"
    save_params(path, v, dtype=dtype)
    ref = _flat(jax.tree.map(np.asarray, load_params(path, v)))
    out = _flat(tio.load_variables(path))
    for key, a in ref.items():
        assert out[key].dtype == np.float32
        np.testing.assert_array_equal(out[key], a)


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict, the leaves as they are."""
    out = {}
    for k, x in tree.items():
        out.update(_leaves(x, prefix + (k,)) if isinstance(x, dict) else {prefix + (k,): x})
    return out


@pytest.mark.parametrize("leaf", ["float32", "bfloat16"])
def test_load_params_into_a_template_equals_jax(tmp_path, leaf):
    """A float16 checkpoint written by the JAX package, loaded into a float32
    template (numpy leaves, as ``load_variables`` gives them) and into a
    bfloat16 one (tensor leaves): each leaf in its template leaf's dtype and
    bit-equal to the JAX package's ``load_params`` into the same template. A
    key only the file has is dropped; a missing or misplaced one raises."""
    import jax.numpy as jnp
    import torch

    v = _rand_variables((8, 16), 32, seed=5)
    path = tmp_path / "v.msgpack"
    save_params(path, v, dtype=np.float16)
    bf16 = leaf == "bfloat16"
    ref = _flat(load_params(path, jax.tree.map(
        lambda a: jnp.zeros(a.shape, jnp.bfloat16 if bf16 else jnp.float32), v)))
    template = jax.tree.map(
        lambda a: torch.zeros(a.shape, dtype=torch.bfloat16) if bf16 else np.zeros(a.shape, np.float32), v)
    del template["params"]["Conv_0"]  # a key the file has and the template lacks
    out = _leaves(tio.load_params(path, template))
    assert set(out) == {k for k in ref if k[:2] != ("params", "Conv_0")} and len(out) > 40
    for key, a in out.items():
        if bf16:
            assert a.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), ref[key].view(np.int16), err_msg=str(key))
        else:
            assert a.dtype == np.float32, key
            np.testing.assert_array_equal(a, ref[key], err_msg=str(key))
    template["params"]["Extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="Extra"):
        tio.load_params(path, template)
    with pytest.raises(ValueError, match="a dict"):
        tio.load_params(path, {"params": {"Conv_1": {"kernel": {"inner": np.zeros(1)}}}})


def test_decoder_matches_msgpack():
    """Every msgpack type the reader takes decodes as the msgpack package does."""
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33, -128,
                 -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.5, -1.25e300, float("inf")],
        "str": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
        "bin": [b"", b"x" * 300, b"y" * 70000],
        "nest": {"none": None, "t": True, "f": False, "list16": list(range(20)),
                 "map16": {str(i): i for i in range(20)}},
    }
    data = msgpack.packb(obj, use_bin_type=True)
    assert tio.read_msgpack(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert tio.read_msgpack(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError):
        tio.read_msgpack(data[:-1])
    with pytest.raises(ValueError):
        tio.read_msgpack(data + b"\x00")
