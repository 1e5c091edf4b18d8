"""JAX's default PRNG, threefry-2x32, in torch.

The JAX package draws its random numbers from ``jax.random.PRNGKey(seed)``:
the well-mask search's candidates and every kernel of a model built from
scratch (``model.init``). This module reproduces those streams bit for bit
with torch, numpy and ``hashlib``, so the same seed gives the same draws in
both packages, on the CPU and on the card.

It follows JAX's defaults:

- ``jax_threefry_partitionable`` is True (the default since JAX 0.5): a
  draw of shape ``s`` hashes the flat index ``i`` of each element, as a
  64-bit number split into its high and low words, under the key, and
  ``split`` is the same hash of the indices of the new keys.
- ``jax_enable_x64`` is False: ``PRNGKey`` keeps the low 32 bits of a
  Python int seed (negative seeds in two's complement), and the key's high
  word is 0.

Counters and bits are uint32 values held in int32 tensors (their bits;
PyTorch's int32 sums wrap like uint32 ones, and its left shift drops the
high bits), keys are Python ints. Everything runs on the device it is
given and gives the same bits on every device.

``truncated_normal`` copies, step by step, XLA's float32 ``erf`` (for the
bounds), ``log`` (Cephes' logf), ``log1p`` (Cephes' rational form below
sqrt(2) - 1) and ``erf_inv`` (Giles' polynomial), and it rounds each
multiply-add once where XLA's CPU code contracts one into a fused
multiply-add, and it matches ``jax.random.truncated_normal`` on the CPU bit
for bit. The fused multiply-add is emulated in float64: the product is
exact there, and the sum is rounded twice, which can move a result by 1 ulp
when the first rounding lands on a float32 half-way point (not met in the
tests). JAX on another backend (a TPU, a GPU) may itself round otherwise.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tmat_torch.device import DeviceLike

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# what Flax hashes between the names of a parameter's path: nothing, with
# ``flax_fix_rng_separator`` False (Flax 0.12's default; True hashes b"\0")
FLAX_RNG_SEPARATOR = b""

Key = Tuple[int, int]
# elements computed at a time: on the CPU no more than PyTorch's grain size
# (32768), so that each of the few hundred elementwise steps runs on the
# calling thread (spread over the intra-op threads, every step waits for
# all of them, which a busy host turns into seconds: on an 8-core host
# beside twelve busy processes, five sets of well-search draws took 12 s
# that way and 0.06 s in chunks); on the card enough that the launches do
# not dominate
_CHUNK = {"cpu": 1 << 15, "cuda": 1 << 24}


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as two uint32 words (see the module
    doc: the low 32 bits of ``seed``, high word 0)."""
    return 0, int(seed) & _MASK


def _s32(v: int) -> int:
    """A uint32 as the int32 with its bits."""
    v &= _MASK
    return v - (1 << 32) if v >> 31 else v


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under the key ``(k1, k2)``; JAX's ``threefry2x32_p``. Each is a uint32
    as an int32: a Python int, or an int32 tensor (a key per element, or
    counters of any shape). The same operators serve both, so a key is
    derived on the host without a device launch; Python ints are wrapped to
    32 bits after each step, tensors wrap by themselves."""
    wrap = (lambda v: v) if isinstance(x0, torch.Tensor) or isinstance(k1, torch.Tensor) else _s32
    ks = (k1, k2, k1 ^ k2 ^ _s32(_PARITY))
    a, b = wrap(x0 + ks[0]), wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = wrap(a + b)
            # rotate left: the right shift is arithmetic, so keep its low r bits
            b = (wrap(b << r) | ((b >> (32 - r)) & ((1 << r) - 1))) ^ a
        a = wrap(a + ks[(i + 1) % 3])
        b = wrap(wrap(b + ks[(i + 2) % 3]) + (i + 1))
    return a, b


def _chunked(part, n: int, device) -> torch.Tensor:
    """``part(start, stop)`` over consecutive ranges of the flat indices
    ``[0, n)``, ``_CHUNK`` at a time, joined."""
    step = _CHUNK[torch.device(device).type]
    return torch.cat([part(i, min(i + step, n)) for i in range(0, max(n, 1), step)])


def _hash(k1, k2, idx: torch.Tensor) -> torch.Tensor:
    """``bits1 ^ bits2`` of the hash of the 64-bit counters ``idx`` (int64,
    split into high and low words as JAX's ``iota_2x32_shape``)."""
    a, b = threefry2x32(k1, k2, (idx >> 32).to(torch.int32), idx.to(torch.int32))
    return a ^ b


def _key_bits(key: Key, device):
    """``part(start, stop)``: the bits of flat indices ``[start, stop)``
    under ``key``."""
    k1, k2 = _s32(key[0]), _s32(key[1])
    return lambda i, j: _hash(k1, k2, torch.arange(i, j, dtype=torch.int64, device=device))


def random_bits(key: Key, shape: Sequence[int], device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the uint32 values' bits in
    an int32 tensor."""
    return _chunked(_key_bits(key, device), math.prod(shape), device).reshape(tuple(shape))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    a, b = threefry2x32(_s32(key[0]), _s32(key[1]), 0, _s32(int(data)))
    return a & _MASK, b & _MASK


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: the fold-like split of the
    partitionable mode, the hash of the new keys' indices."""
    k1, k2 = _s32(key[0]), _s32(key[1])
    return [tuple(v & _MASK for v in threefry2x32(k1, k2, 0, i)) for i in range(num)]


def _float_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the 23 high bits of each uint32."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 rounded once: XLA's CPU code generator
    contracts a product that feeds one sum into a fused multiply-add. The
    product of two float32 numbers is exact in float64, so only the sum is
    rounded twice (to float64, then float32), which changes a result only
    when the first rounding lands on a float32 half-way point."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return a.double().mul_(b).add_(c).float()


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo, hi = _f32(minval), _f32(maxval)
    return torch.clamp_min(_fma(_float_from_bits(bits), _f32(hi - lo), lo), lo)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = _key_bits(key, device)
    return _chunked(lambda i, j: _uniform_from_bits(bits(i, j), minval, maxval),
                    math.prod(shape), device).reshape(tuple(shape))


# Cephes' logf, as XLA's CPU ``log`` evaluates it: its polynomial on
# [sqrt(1/2) - 1, sqrt(2) - 1] in three interleaved parts, and the exponent's
# log 2 in two parts
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
# XLA's ``log1p`` below sqrt(2) - 1: Cephes' rational form (highest power first)
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_SMALL = _f32(0.41421356237309504880)
# XLA's ``erf``: numerator and denominator in the argument's square
_ERF_NUM = (0.00022905065270606428, 0.0034082909114658833, 0.050955694168806076,
            0.18520832061767578, 1.1283791065216064)
_ERF_DEN = (-1.1791603071742429e-07, 2.354796561121475e-05, 0.0010179625824093819,
            0.01407046988606453, 0.11098504811525345, 0.4974692463874817, 1.0)
_ERF_CLAMP = 3.7439212799072266
# XLA's ``ErfInv32``: Giles, "Approximating the erfinv function" (2010)
_ERFINV_W_LT_5 = tuple(_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_W_GE_5 = tuple(_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _horner(x: torch.Tensor, coeffs: Sequence[float]) -> torch.Tensor:
    """Horner's rule from the highest power, each step a fused
    multiply-add."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (float64 has the digits to
    round it once), which ``torch.sqrt`` on the CPU is not."""
    return torch.sqrt(x.double()).float()


def _log(u: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (Cephes' logf) of positive normal numbers."""
    v = torch.clamp_min(u, 2.0 ** -126)
    bits = v.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    lt = m < _SQRTHF
    e = ((bits >> 23) - 127).float() + 1.0 - lt.float()
    x = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y0, y1, y2 = _fma(x, p[0], p[1]), _fma(x, p[3], p[4]), _fma(x, p[6], p[7])
    y0, y1, y2 = _fma(y0, x, p[2]), _fma(y1, x, p[5]), _fma(y2, x, p[8])
    y0 = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y0, x3, e * _LOG_Q1)
    r = _fma(x2, -0.5, x) + y
    return _fma(e, _LOG_Q2, r)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p``: Cephes' rational form below sqrt(2) - 1,
    ``log(1 + x)`` above."""
    x2 = x * x
    rational = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * rational)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``lax.erf_inv``) as its CPU code computes
    it."""
    w = -_log1p(x * -x)
    p = _horner(w - 2.5, _ERFINV_W_LT_5)
    tail = w >= 5.0  # |x| > 0.9966: never within truncated_normal's (-2, 2)
    if bool(tail.any()):
        p = torch.where(tail, _horner(_sqrt(w) - 3.0, _ERFINV_W_GE_5), p)
    p = torch.where(x.abs() == 1.0, torch.full_like(p, float("inf")), p)
    return x * p


def _erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf``: a rational function of the argument clamped to
    [-3.74, 3.74]."""
    x = x.clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    return (x * _horner(x2, _ERF_NUM)) / _horner(x2, _ERF_DEN)


def _truncated(lower: float, upper: float):
    """``f(bits)``: ``jax.random.truncated_normal``'s values from the bits,
    ``sqrt(2) * erf_inv(u)`` for ``u`` uniform between the bounds' ``erf``,
    clipped to the open interval between the bounds."""
    sqrt2 = _f32(math.sqrt(2))
    # XLA turns the division by a constant into a product with its reciprocal
    a, b = _erf(torch.tensor([lower, upper], dtype=torch.float32) * _f32(1.0 / sqrt2)).tolist()
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return lambda bits: (erf_inv(_uniform_from_bits(bits, a, b)) * sqrt2).clamp_(lo, hi)


def truncated_normal(key: Key, lower: float, upper: float, shape: Sequence[int],
                     device: DeviceLike = "cpu") -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``."""
    bits, values = _key_bits(key, device), _truncated(lower, upper)
    return _chunked(lambda i, j: values(bits(i, j)), math.prod(shape), device).reshape(tuple(shape))


def flax_param_key(root: Key, path: Sequence[str], counter: int) -> Key:
    """The key Flax's ``init`` gives a parameter: the root key folded with
    the first 4 bytes (big-endian) of the SHA-1 of the module scope's path
    names and then the parameter's ``counter`` (1 for a scope's first
    ``param`` call, 2 for its second, ...), as ``flax.core.scope.
    _fold_in_static`` does."""
    m = hashlib.sha1()
    for x in (*path, counter):
        m.update(FLAX_RNG_SEPARATOR)
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(keys: Sequence[Key], shapes: Sequence[Sequence[int]],
                 device: DeviceLike = "cpu") -> List[torch.Tensor]:
    """Flax's default kernel init, ``lecun_normal()(keys[i], shapes[i],
    float32)`` for every i: ``truncated_normal(-2, 2) * sqrt(1 / fan_in) /
    0.8796...``, fan-in = every axis but the last. The arrays are drawn as
    one run of elements, each under its own array's key and counter, so that
    a model's hundreds of kernels take a few hundred launches on the card,
    not tens of thousands."""
    sizes = [math.prod(shape) for shape in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    k1 = torch.tensor([_s32(k[0]) for k in keys], dtype=torch.int32, device=device)
    k2 = torch.tensor([_s32(k[1]) for k in keys], dtype=torch.int32, device=device)
    starts = torch.tensor(offsets[:-1], device=device)
    std = torch.tensor(np.array([np.sqrt(np.float32(1.0 / math.prod(shape[:-1])))
                                 / np.float32(0.87962566103423978) for shape in shapes],
                                np.float32), device=device)
    values = _truncated(-2.0, 2.0)

    def part(i: int, j: int) -> torch.Tensor:
        first, last = np.searchsorted(offsets, i, "right") - 1, np.searchsorted(offsets, j, "left")
        lens = np.minimum(offsets[first + 1:last + 1], j) - np.maximum(offsets[first:last], i)
        lens = torch.tensor(lens, device=device)

        def each(t):
            return torch.repeat_interleave(t[first:last], lens)
        # each array's own flat index: its counter under its own key
        idx = torch.arange(i, j, dtype=torch.int64, device=device) - each(starts)
        return values(_hash(each(k1), each(k2), idx)) * each(std)

    flat = _chunked(part, int(offsets[-1]), device)
    return [v.reshape(tuple(shape)) for v, shape in zip(torch.split(flat, sizes), shapes)]
