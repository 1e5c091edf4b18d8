"""The port's UNet-Xception forward and patch segmentor against Flax.

Both packages get the same weights: Flax variables filled from a numpy
seed (with random BatchNorm statistics), saved with ``tmat_tpu``'s
``save_params`` where a checkpoint is needed. The port folds BN and runs
its down blocks through ``ops.down_block`` (the plain version on the CPU).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.models.params_io import save_params
from tmat_tpu.models.unet import UNetXceptionPatchSegmentor as JaxSegmentor, build_unet_xception
from tmat_torch.models import unet as tunet
from tmat_torch.models.params_io import from_flax_variables
from tmat_torch.ops import tiled
from tmat_torch.ops.down_block import _maxpool3x3s2

FILTER_CASES = [((8, 16), 32), ((4, 8, 16), 32), ((64, 128, 256, 512), 64)]


def _rand_variables(filters, patch, seed=3):
    """Flax UNet variables filled from a numpy seed: kernels scaled by
    1/sqrt(fan-in), random biases, BN scales and running statistics."""
    model, shapes = build_unet_xception(1, (patch, patch), channels=1, filter_counts=filters, init="zeros")
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.2, 1.5, a.shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*a.shape)
        return np.asarray(v, np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("filters,patch", FILTER_CASES)
def test_forward_matches_flax_f32(filters, patch):
    model, variables = _rand_variables(filters, patch)
    x = np.random.RandomState(0).rand(3, patch, patch, 1).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    net = tunet.UNetXception(from_flax_variables(variables, filters), torch.float32)
    out = net(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (3, patch, patch, 1)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


def _trap_case(name, rng):
    """(port result, Flax result) for one padding/layout convention."""
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    if name == "same_stride2_conv":
        mod = fnn.Conv(6, (3, 3), strides=2, padding="SAME")
        v = mod.init(jax.random.PRNGKey(0), xj)
        k = np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)
        out = tunet._conv_nhwc(xt, torch.tensor(k), 2) + torch.tensor(np.asarray(v["params"]["bias"]))
    elif name == "conv_transpose_same":
        mod = fnn.ConvTranspose(6, (3, 3), padding="SAME")
        v = mod.init(jax.random.PRNGKey(0), xj)
        k = np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)
        out = tunet._conv_nhwc(xt, torch.tensor(k), 1) + torch.tensor(np.asarray(v["params"]["bias"]))
    elif name == "residual_1x1_stride2":
        mod = fnn.Conv(6, (1, 1), strides=2, padding="SAME")
        v = mod.init(jax.random.PRNGKey(0), xj)
        w = torch.tensor(np.asarray(v["params"]["kernel"])[0, 0])
        out = xt[:, ::2, ::2] @ w + torch.tensor(np.asarray(v["params"]["bias"]))
    elif name == "up_residual":
        mod = fnn.Conv(6, (1, 1), padding="SAME")
        v = mod.init(jax.random.PRNGKey(0), xj)
        w = torch.tensor(np.asarray(v["params"]["kernel"])[0, 0])
        out = tunet._upsample2(tunet._pointwise(xt, w, torch.tensor(np.asarray(v["params"]["bias"]))))
        ref = mod.apply(v, xj)
        return out, jnp.repeat(jnp.repeat(ref, 2, axis=1), 2, axis=2)
    else:  # maxpool_same_stride2
        return _maxpool3x3s2(xt), fnn.max_pool(xj, (3, 3), strides=(2, 2), padding="SAME")
    return out, mod.apply(v, xj)


@pytest.mark.parametrize("name", ["same_stride2_conv", "conv_transpose_same", "residual_1x1_stride2",
                                  "up_residual", "maxpool_same_stride2"])
def test_flax_conventions(name):
    """SAME at stride 2 pads (0, 1); ConvTranspose(3x3, stride 1, SAME) is a
    plain correlation with the unflipped kernel; the 1x1 stride-2 residual
    is x[::2, ::2]; the up residual is a 1x1 conv then a nearest x2."""
    assert tunet._same_pads(8, 3, 2) == (0, 1)
    out, ref = _trap_case(name, np.random.RandomState(1))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("canvas,expected", [(640, 200), (320, 72)])
def test_production_patch_batch(canvas, expected):
    """A 1024-px well at ds_ratio 0.625 is a 640-px canvas: 5 x 5 patches of
    320 x 8 dihedral variants = one UNet batch of 200."""
    seen = []
    img = torch.rand(canvas, canvas, generator=torch.Generator().manual_seed(0))
    tiled.tiled_core(img, lambda b: seen.append(tuple(b.shape)) or b[..., :1], 320, 2, 1, 8)
    assert seen == [(expected, 320, 320, 1)]
    batch = tiled.tile_patches(img[..., None], 320, 2, 8)
    # patch 0: the identity variant's top-left window, the image 160 px in
    np.testing.assert_array_equal(batch[0, 160:, 160:, 0].numpy(), img[:160, :160].numpy())


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    _, variables = _rand_variables((8, 16), 32, seed=5)
    path = tmp_path_factory.mktemp("ckpt") / "ckpt.msgpack"
    save_params(path, variables)
    return path


@pytest.mark.parametrize("size,tta", [(48, 8), (64, 4), (96, 1), (77, 8)])
def test_segmentor_predict_matches_jax(tiny_checkpoint, size, tta):
    img = np.random.RandomState(size).rand(size, size).astype(np.float32)
    ref = JaxSegmentor(32, tiny_checkpoint, (8, 16), ds_ratio=0.625, dtype=jnp.float32, tta=tta).predict(img)
    seg = tunet.UNetXceptionPatchSegmentor(32, tiny_checkpoint, (8, 16), ds_ratio=0.625,
                                           dtype=torch.float32, tta=tta, device="cpu")
    out = seg.predict(img)
    assert out.shape == ref.shape == (size, size)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_segmentor_from_cfg_dtype(tmp_path, tiny_checkpoint):
    """The config's "dtype" key overrides the device default (f32 on the CPU)."""
    import json

    cfg = {"patch_size": 32, "checkpoint_file": str(tiny_checkpoint), "filter_counts": [8, 16],
           "ds_ratio": 0.625, "tta": 4}
    (tmp_path / "a.json").write_text(json.dumps(cfg))
    (tmp_path / "b.json").write_text(json.dumps(dict(cfg, dtype="bfloat16")))
    a = tunet.get_unet_patch_segmentor_from_cfg(str(tmp_path / "a.json"), device="cpu")
    b = tunet.get_unet_patch_segmentor_from_cfg(str(tmp_path / "b.json"), device="cpu")
    assert (a.dtype, b.dtype, a.tta, a.patch_size, a.ds_ratio) == (torch.float32, torch.bfloat16, 4, 32, 0.625)
    assert b.model.down0_w1.dtype == torch.bfloat16 and b.model.down0_b1.dtype == torch.float32
