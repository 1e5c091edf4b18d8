"""The port's fused down block against the Pallas kernel it replaces.

The JAX side runs ``tmat_tpu.ops.pallas_unet._down_block`` in interpret
mode on the CPU; the port's ``down_block`` on a CPU tensor runs its plain
PyTorch version, which rounds at the kernel's points. Weights come from a
Flax UNet with random BatchNorm statistics, folded by both packages. The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.models.unet import build_unet_xception
from tmat_tpu.ops.pallas_unet import _down_block, extract_fused_params
from tmat_torch.models.params_io import from_flax_variables
from tmat_torch.ops import down_block as db


def _rand_variables(filters, patch, seed=3):
    """Flax UNet variables filled from a numpy seed: kernels scaled by
    1/sqrt(fan-in), random biases, BN scales and running statistics."""
    _, shapes = build_unet_xception(1, (patch, patch), channels=1, filter_counts=filters, init="zeros")
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

    return jax.tree_util.tree_map_with_path(fill, shapes)


_CACHE = {}


def _blocks(filters, patch):
    key = (filters, patch)
    if key not in _CACHE:
        v = _rand_variables(filters, patch)
        _CACHE[key] = (extract_fused_params(v, filters)["down"], from_flax_variables(v, filters)["down"])
    return _CACHE[key]


CASES = [
    (filters, patch, i)
    for filters, patch in (((8, 16), 32), ((4, 8, 16), 32), ((64, 128, 256, 512), 64))
    for i in range(len(filters) - 1)
]


def _inputs(filters, patch, i, dtype_np=np.float32, batch=2, seed=0):
    hw = patch // 2 ** (i + 1)
    rng = np.random.RandomState(seed)
    return rng.randn(batch, hw, hw, filters[i]).astype(dtype_np)


def _torch_blk(blk, dtype):
    return {k: torch.tensor(v) if k in db.BIAS_KEYS else torch.tensor(v).to(dtype) for k, v in blk.items()}


def _jax_blk(blk, dtype):
    return {k: jnp.asarray(v, jnp.float32 if k in db.BIAS_KEYS else dtype) for k, v in blk.items()}


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("filters,patch,i", CASES)
def test_plain_matches_pallas_f32(filters, patch, i, first):
    jblk, tblk = _blocks(filters, patch)
    x = _inputs(filters, patch, i)
    ref = np.asarray(_down_block(jnp.asarray(x), _jax_blk(jblk[i], jnp.float32), first=first, interpret=True))
    before = db.launches
    out = db.down_block(torch.tensor(x), _torch_blk(tblk[i], torch.float32), first)
    assert db.launches == before, "a CPU tensor must not count a kernel launch"
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("filters,patch,i", [c for c in CASES if c[0] != (4, 8, 16)])
def test_plain_matches_pallas_bf16(filters, patch, i):
    """The same rounding points in bf16. f32 sums taken in another order
    can land a rounding of t or u on the other side of a bf16 step, and the
    step propagates, so the bound is 4 bf16 steps (2**-6 relative) of the
    output's largest magnitude."""
    jblk, tblk = _blocks(filters, patch)
    x = _inputs(filters, patch, i)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(_down_block(xb, _jax_blk(jblk[i], jnp.bfloat16), first=(i == 0), interpret=True), np.float32)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = db.down_block(xt, _torch_blk(tblk[i], torch.bfloat16), i == 0)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert err.max() <= 2.0 ** -6 * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    assert np.mean(err == 0) > 0.9, "most outputs must round to the same bf16 value"


def test_wrapper_checks_inputs():
    _, tblk = _blocks((8, 16), 32)
    blk = _torch_blk(tblk[0], torch.float32)
    with pytest.raises(ValueError, match="even"):
        db.down_block(torch.zeros(1, 15, 16, 8), blk, True)
    with pytest.raises(TypeError):
        db.down_block(torch.zeros(1, 16, 16, 8, dtype=torch.float64), blk, True)
    bad = dict(blk, w1=blk["w1"].t().contiguous())
    with pytest.raises(ValueError, match="w1"):
        db.down_block(torch.zeros(1, 16, 16, 8), bad, True)
    with pytest.raises(ValueError, match="contiguous"):
        db.down_block(torch.zeros(1, 16, 16, 16)[..., :8], blk, True)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("hw", [8, 10, 20])
def test_plain_matches_pallas_bf16_at_the_warpgroup_widths(hw, first):
    """64 -> 128 channels in bf16 (the widths the kernel's warpgroup form
    takes) at sizes whose pooled tiles are whole and ragged (5 x 5 and
    10 x 10 pooled pixels against tiles of 8): the plain version the card
    holds that form against agrees with the Pallas kernel. Same bound as
    ``test_plain_matches_pallas_bf16``."""
    filters = (64, 128, 256, 512)
    jblk, tblk = _blocks(filters, 64)
    x = np.random.RandomState(hw).randn(3, hw, hw, 64).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(_down_block(xb, _jax_blk(jblk[0], jnp.bfloat16), first=first, interpret=True), np.float32)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = db.down_block(xt, _torch_blk(tblk[0], torch.bfloat16), first)
    assert tuple(out.shape) == (3, hw // 2, hw // 2, 128) and out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert err.max() <= 2.0 ** -6 * np.abs(ref).max(), (err.max(), np.abs(ref).max())
    assert np.mean(err == 0) > 0.9, "most outputs must round to the same bf16 value"
