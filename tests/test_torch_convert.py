"""The port's Keras .h5 converter against ``tmat_tpu/models/convert.py``:
the same synthetic Keras-layout file gives equal trees and byte-equal
checkpoints in both packages (``tests/test_convert.py`` writes the files)."""

import filecmp

import jax.tree_util as tu
import numpy as np
import pytest

from test_convert import _keras_unet_layers, _write_legacy_h5
from tmat_tpu.models import convert as J
from tmat_tpu.models.resnet import build_resnet50_tl as jax_resnet
from tmat_tpu.models.unet import build_unet_xception as jax_unet
from tmat_torch.models import convert as C
from tmat_torch.models.layers import flax_variables
from tmat_torch.models.params_io import load_variables
from tmat_torch.models.resnet import build_trainable_resnet50_tl
from tmat_torch.models.unet import build_unet_xception


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(a)
            for path, a in tu.tree_flatten_with_path(tree)[0]}


def _assert_same_tree(out, ref):
    assert list(_flat(out)) == list(_flat(ref))
    for k, a in _flat(ref).items():
        np.testing.assert_array_equal(_flat(out)[k], a, err_msg=k)


def _resnet_h5(path, rng, last_layer="conv2_block3_out"):
    """A Keras-named h5 for every layer of the truncated ResNet."""
    _, template = jax_resnet(1, (32, 32, 3), base_last_layer=last_layer, init="zeros")
    flat = _flat(template["params"])
    layers, seen = [], set()
    for key in flat:
        parts = key.split("/")
        lname = ("dense" if parts[0] == "head" else parts[1] if parts[1].startswith("conv1_")
                 else f"{parts[1]}_{parts[2]}")
        if lname in seen:
            continue
        seen.add(lname)
        prefix = "/".join(parts[:-1])
        if lname.endswith("_bn"):
            c = flat[f"{prefix}/scale"].shape[0]
            layers.append((lname, {"gamma": rng.rand(c).astype(np.float32),
                                   "beta": rng.rand(c).astype(np.float32),
                                   "moving_mean": rng.rand(c).astype(np.float32),
                                   "moving_variance": (rng.rand(c) + 0.5).astype(np.float32)}))
        else:
            w = {"kernel": rng.rand(*flat[f"{prefix}/kernel"].shape).astype(np.float32)}
            w["bias"] = rng.rand(*flat[f"{prefix}/bias"].shape).astype(np.float32)
            layers.append((lname, w))
    _write_legacy_h5(path, layers)
    return template


def test_unet_conversion_equal_and_byte_equal(tmp_path, rng):
    h5 = tmp_path / "w.h5"
    _write_legacy_h5(h5, _keras_unet_layers(rng))
    _, jtemplate = jax_unet(1, (32, 32), channels=1, filter_counts=(8, 16), init="zeros")
    template = flax_variables(build_unet_xception(1, (32, 32), filter_counts=(8, 16), device="cpu"))
    _assert_same_tree(C.convert_unet_weights(str(h5), template),
                      J.convert_unet_weights(str(h5), jtemplate))
    C.main(["unet", str(h5), str(tmp_path / "port.msgpack"), "--patch-size", "32",
            "--filters", "8", "16"])
    J.main(["unet", str(h5), str(tmp_path / "jax.msgpack"), "--patch-size", "32",
            "--filters", "8", "16"])
    assert filecmp.cmp(tmp_path / "port.msgpack", tmp_path / "jax.msgpack", shallow=False)
    assert load_variables(tmp_path / "port.msgpack")["batch_stats"]["BatchNorm_6"]["var"].min() >= 0.5


def test_resnet_conversion_equal_and_byte_equal(tmp_path, rng):
    h5 = tmp_path / "resnet.h5"
    jtemplate = _resnet_h5(h5, rng)
    template = flax_variables(build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out",
                                                          device="cpu"))
    out = C.convert_resnet_weights(str(h5), template)
    _assert_same_tree(out, J.convert_resnet_weights(str(h5), jtemplate))
    args = ["resnet", str(h5), "--last-layer", "conv2_block3_out", "--img-size", "32"]
    C.main(args[:2] + [str(tmp_path / "port.msgpack")] + args[2:])
    J.main(args[:2] + [str(tmp_path / "jax.msgpack")] + args[2:])
    assert filecmp.cmp(tmp_path / "port.msgpack", tmp_path / "jax.msgpack", shallow=False)


def test_shape_mismatch_raises(tmp_path, rng):
    layers = _keras_unet_layers(rng)
    layers[0][1]["kernel"] = rng.rand(3, 3, 1, 999).astype(np.float32)
    _write_legacy_h5(tmp_path / "bad.h5", layers)
    template = flax_variables(build_unet_xception(1, (32, 32), filter_counts=(8, 16), device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch at Conv_0/kernel"):
        C.convert_unet_weights(str(tmp_path / "bad.h5"), template)
