"""The port's threefry streams (``tmat_torch/core/prng.py``) against
``jax.random`` on the CPU, with JAX's default configuration.

Held to: the keys, the bits, ``uniform``, ``split`` and ``fold_in``
array-equal; ``truncated_normal`` array-equal too (the port copies XLA's
float32 ``erf``, ``log``, ``log1p`` and ``erf_inv`` and the fused
multiply-adds that XLA's CPU code makes of them), and never more than
1 ulp apart, the bound the port's docstring states for a float64 sum
rounded twice. Flax's per-parameter keys equal the keys ``model.init``
hands to a module's params.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tmat_torch.core import prng

SEEDS = [0, 1, 2**31 - 1, -1, 2**40 + 3]
SHAPES = [(), (0,), (7,), (3, 5), (25000, 6)]


def _ulps(a, b):
    """Distance in float32 steps, across zero too."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def test_jax_runs_the_mode_the_port_copies():
    """The port copies JAX's defaults: a partitionable threefry and 32-bit
    seeds. If JAX's side ever differs, this fails rather than skipping."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert prng.prng_key(seed) == tuple(int(v) for v in ref)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform(seed, shape):
    key = jax.random.PRNGKey(seed)
    bits = prng.random_bits(prng.prng_key(seed), shape)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    out = prng.uniform(prng.prng_key(seed), shape).numpy()
    ref = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("bounds", [(-0.3, 0.9), (-1.5, 0.25), (2.0, 7.0)])
@pytest.mark.parametrize("seed", [0, -1])
def test_uniform_bounds(seed, bounds):
    out = prng.uniform(prng.prng_key(seed), (3, 1000), *bounds).numpy()
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (3, 1000), jnp.float32, *bounds))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    for num in (1, 2, 5):
        ref = np.asarray(jax.random.key_data(jax.random.split(key, num)))
        assert prng.split(prng.prng_key(seed), num) == [tuple(int(v) for v in r) for r in ref]
    for data in (0, 1, 7, 123456789, 2**32 - 1):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        assert prng.fold_in(prng.prng_key(seed), data) == tuple(int(v) for v in ref)


@pytest.mark.parametrize("shape", SHAPES + [(3, 3, 64, 128)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_truncated_normal(seed, shape):
    out = prng.truncated_normal(prng.prng_key(seed), -2.0, 2.0, shape).numpy()
    ref = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2, 2, shape, jnp.float32))
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.size:
        assert _ulps(out, ref).max() <= 1
        assert -2 < out.min() and out.max() < 2
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("bounds", [(-0.3, 0.9), (-1.5, 0.25), (0.1, 0.2), (-3.0, 3.0)])
def test_truncated_normal_bounds(bounds):
    for seed in (0, 7):
        out = prng.truncated_normal(prng.prng_key(seed), *bounds, (4000,)).numpy()
        ref = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), *bounds, (4000,),
                                                     jnp.float32))
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("fn", ["erf", "log", "log1p", "erf_inv"])
def test_float32_functions_equal_xla(fn):
    """The float32 functions under ``truncated_normal``, each on 250,000
    points of its range, against the XLA function on the CPU."""
    rng = np.random.RandomState(0)
    if fn == "erf":
        x = rng.uniform(-4.5, 4.5, 250_000)
        ours, ref = prng._erf, lax.erf
    elif fn == "log":
        x = np.concatenate([rng.uniform(2.0**-126, 4, 249_998), [1.0, 2.0**-126]])
        ours, ref = prng._log, jnp.log
    elif fn == "log1p":
        x = np.concatenate([-rng.uniform(-1, 1, 249_999) ** 2, [0.0]])
        ours, ref = prng._log1p, lax.log1p
    else:
        x = np.concatenate([rng.uniform(-1, 1, 249_996), np.linspace(-1, 1, 4)])
        ours, ref = prng.erf_inv, lax.erf_inv
    x = x.astype(np.float32)
    out = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax.jit(ref)(x)))


@pytest.mark.parametrize("chunk", [1 << 15, 100])
def test_lecun_normal_equals_flax(chunk, monkeypatch):
    """Several kernels drawn as one run of elements, each under its own key,
    in one chunk or (``_CHUNK`` lowered) in chunks that cut kernels."""
    monkeypatch.setitem(prng._CHUNK, "cpu", chunk)
    shapes = [(3, 3, 1, 8), (1, 1, 16, 32), (64, 10), (3, 3, 4, 4)]
    keys = [jax.random.PRNGKey(s) for s in (11, 12, -3, 2**31 - 1)]
    out = prng.lecun_normal([prng.prng_key(s) for s in (11, 12, -3, 2**31 - 1)], shapes)
    assert [tuple(t.shape) for t in out] == shapes
    for key, shape, t in zip(keys, shapes, out):
        ref = np.asarray(nn.initializers.lecun_normal()(key, shape, jnp.float32))
        np.testing.assert_array_equal(t.numpy(), ref)


class _Two(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.Conv(4, (3, 3), use_bias=False, name="first")(x)
        x = nn.BatchNorm(use_running_average=True)(x)
        return nn.Dense(3, bias_init=nn.initializers.normal(1.0))(x)


def test_flax_param_key_is_the_key_init_hands_out():
    """Every param of a small module, bias and BatchNorm scale included,
    drawn from ``flax_param_key`` with its own initialiser."""
    seed = 5
    variables = _Two().init(jax.random.PRNGKey(seed), np.zeros((1, 6, 6, 2), np.float32))
    params = variables["params"]
    root = prng.prng_key(seed)
    k = prng.flax_param_key(root, ["first"], 1)
    np.testing.assert_array_equal(prng.lecun_normal([k], [(3, 3, 2, 4)])[0].numpy(), params["first"]["kernel"])
    k = prng.flax_param_key(root, ["Dense_0"], 1)
    np.testing.assert_array_equal(prng.lecun_normal([k], [(4, 3)])[0].numpy(), params["Dense_0"]["kernel"])
    k = jnp.asarray(prng.flax_param_key(root, ["Dense_0"], 2), jnp.uint32)
    ref = nn.initializers.normal(1.0)(jax.random.wrap_key_data(k), (3,), jnp.float32)
    np.testing.assert_array_equal(ref, params["Dense_0"]["bias"])
    assert list(params["BatchNorm_0"]) == ["scale", "bias"]



def test_chip_smoke_digests_are_jax_s():
    """The digests that ``chip_smoke.py``'s ``rng`` phase holds the card to
    (the card has no JAX): the JAX package's well-search draws for seed 0
    and its UNet's kernels from ``model.init(PRNGKey(0))`` at the shipped
    geometry, and the port's, drawn here on the CPU."""
    import hashlib

    import chip_smoke as cs
    from tmat_tpu.models.unet import UNetXception
    from tmat_torch.models.layers import flatten_tree
    from tmat_torch.models.unet import build_unet_xception
    from tmat_torch.ops.wellmask import unit_draws

    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (25000, 6), jnp.float32))
    assert hashlib.sha256(draws.tobytes()).hexdigest() == cs.RNG_DIGESTS["unit_draws_0"]
    assert hashlib.sha256(unit_draws(0).tobytes()).hexdigest() == cs.RNG_DIGESTS["unit_draws_0"]

    cfg = cs.RNG_UNET
    model = UNetXception(n_outputs=cfg["n_outputs"], filter_counts=cfg["filter_counts"])
    dummy = np.zeros((1, *cfg["img_shape"], cfg["channels"]), np.float32)
    # jitted: bit-equal to the eager init of tmat_tpu's build_unet_xception, in a quarter of the time
    params = jax.jit(lambda k: model.init(k, dummy, train=False))(jax.random.PRNGKey(0))["params"]
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    port = build_unet_xception(**cfg, seed=0, device="cpu").state_dict()
    assert {k for k in port if k.endswith(".kernel")} == {k for k in flat if k.endswith(".kernel")}
    assert cs.kernels_digest(port) == cs.RNG_DIGESTS["unet_kernels_0"]
    # a jitted init returns its dicts with sorted keys: take the leaves in
    # the port's order, which is Flax's (tests/test_torch_init.py)
    assert cs.kernels_digest({k: flat[k] for k in port if k in flat}) == cs.RNG_DIGESTS["unet_kernels_0"]
