"""The plain version of the int8 convolution (``tmat_torch/ops/int8_conv.py``)
against the JAX package's int8 conv and against float64 ``F.conv2d``.

The JAX package computes the conv with ``lax.conv_general_dilated(...,
preferred_element_type=jnp.int32)`` and its epilogue as XLA elementwise
ops (``tmat_tpu/models/quant.py``). Tolerances:

- the int32 sums: exact (both are exact integer sums);
- the epilogue: bit-equal to the same two rounded float32 operations in
  numpy, and to the JAX epilogue except at an int8 rounding tie, where an
  output may differ by one step (XLA may contract the multiply-add);
- float outputs: bit-equal to numpy's float32 (bfloat16: round to nearest
  even of numpy's float32).

The CUDA kernel is held against this plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from tmat_torch.ops import int8_conv as ic

DN = ("NHWC", "HWIO", "NHWC")
# (B, H, W, Cin, Cout): odd sizes, the entry conv's single channel, widths
# that are and are not multiples of 16 and of the 64-wide output tile
SHAPES = [(2, 9, 13, 1, 24), (1, 7, 7, 5, 8), (2, 10, 6, 16, 70), (1, 5, 11, 48, 16)]
FORMS = ["int8", "int8_relu", "float32", "bfloat16", "float32_sout", "bfloat16_sout_relu"]


def _case(shape, kh, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (kh, kh, cin, cout)).astype(np.int8)
    m = (rng.rand(cout) * 2e-3).astype(np.float32)
    c = rng.randn(cout).astype(np.float32)
    sout = (rng.rand(cout) * 3).astype(np.float32)
    return x, wq, m, c, sout


def _jax_acc(x, wq, stride):
    return np.asarray(lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(wq), (stride, stride), "SAME",
                                               dimension_numbers=DN, preferred_element_type=jnp.int32))


def _form(form):
    out = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}[form.split("_")[0]]
    return out, "relu" in form, "sout" in form


def _numpy_epilogue(acc, m, c, relu, out, sout):
    v = acc.astype(np.float32) * m
    v = v + c
    if relu:
        v = np.maximum(v, np.float32(0))
    if out == torch.int8:
        return np.clip(np.round(v), -127, 127).astype(np.int8)
    if sout is not None:
        v = v * sout
    return torch.tensor(v).to(out)


@pytest.mark.parametrize("stride", ic.STRIDES)
@pytest.mark.parametrize("kh", ic.KERNEL_SIZES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sums_exact_against_lax_and_float64_conv(shape, kh, stride):
    x, wq, *_ = _case(shape, kh)
    cout = wq.shape[-1]
    packed = ic.pack_weights(wq)
    assert packed.shape == (cout, ic.padded_depth(kh, shape[3])) and packed.shape[1] % 32 == 0
    assert torch.equal(ic.unpack_weights(packed, kh, shape[3]), torch.tensor(wq).permute(3, 2, 0, 1))
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    # m = 1, c = 0 into float32: the sums themselves (all below 2**24 here)
    acc = ic.conv2d_s8_plain(torch.tensor(x), packed, kh, stride, ones, zeros, out_dtype=torch.float32)
    ref = _jax_acc(x, wq, stride)
    assert acc.shape == ref.shape
    np.testing.assert_array_equal(acc.numpy(), ref.astype(np.float32))
    # float64 F.conv2d with explicit TF-SAME pads, in NCHW
    (pt, pb), (pl, pr) = ic.same_pads(shape[1], kh, stride), ic.same_pads(shape[2], kh, stride)
    xd = F.pad(torch.tensor(x).permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    ref64 = F.conv2d(xd, torch.tensor(wq).permute(3, 2, 0, 1).double(), stride=stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(acc.double().numpy(), ref64.numpy())


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kh,stride", [(3, 1), (3, 2), (1, 2), (1, 1)])
def test_epilogue_forms(kh, stride, form):
    shape = (2, 9, 13, 16, 24)
    x, wq, m, c, sout = _case(shape, kh, seed=3)
    out_dtype, relu, use_sout = _form(form)
    t = torch.tensor
    got = ic.conv2d_s8(t(x), ic.pack_weights(wq), kh, stride, t(m), t(c), relu, out_dtype,
                       t(sout) if use_sout else None)
    assert got.dtype == out_dtype and got.is_contiguous()
    acc = _jax_acc(x, wq, stride)
    want = _numpy_epilogue(acc, m, c, relu, out_dtype, sout if use_sout else None)
    if out_dtype == torch.int8:
        np.testing.assert_array_equal(got.numpy(), want)
        # the JAX package's epilogue (forward_quant's conv): ties may round apart
        y = acc.astype(jnp.float32) * jnp.asarray(m) + jnp.asarray(c)
        if relu:
            y = jnp.maximum(y, 0.0)
        jax_q = np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))
        diff = np.abs(got.numpy().astype(int) - jax_q.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        assert (got.numpy() == 127).any() and (got.numpy() == -127).any() or relu
    else:
        assert torch.equal(got, want)


def test_rounds_half_to_even_and_clips():
    """acc * 1 + c lands exactly on .5 ties and beyond +-127."""
    x = torch.ones((1, 1, 8, 1), dtype=torch.int8)
    packed = ic.pack_weights(np.ones((1, 1, 1, 8), np.int8))
    c = torch.tensor([-1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 300.0, -300.0])
    got = ic.conv2d_s8(x, packed, 1, 1, torch.ones(8), c - 1.0)  # acc is 1
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), [-2, 0, 0, 2, 2, 126, 127, -127])


def test_wrapper_refuses():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    p3 = ic.pack_weights(np.zeros((3, 3, 16, 8), np.int8))
    one = torch.ones(8)
    with pytest.raises(ValueError, match="kernel sizes"):
        ic.conv2d_s8(x, p3, 5, 1, one, one)
    with pytest.raises(ValueError, match="strides"):
        ic.conv2d_s8(x, p3, 3, 3, one, one)
    with pytest.raises(ValueError, match="int8"):
        ic.conv2d_s8(x.float(), p3, 3, 1, one, one)
    with pytest.raises(ValueError, match="packed weights"):
        ic.conv2d_s8(x, p3, 1, 1, one, one)
    with pytest.raises(ValueError, match="float32 of shape"):
        ic.conv2d_s8(x, p3, 3, 1, torch.ones(7), one)
    with pytest.raises(ValueError, match="sout"):
        ic.conv2d_s8(x, p3, 3, 1, one, one, sout=one)
    with pytest.raises(TypeError):
        ic.conv2d_s8(x, p3, 3, 1, one, one, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="square"):
        ic.pack_weights(np.zeros((3, 1, 3, 8), np.int8))
    before = ic.launches
    ic.conv2d_s8(x, p3, 3, 1, one, one)
    assert ic.launches == before  # the plain version is no launch
