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
  even of numpy's float32);
- a float batch requantised on load (``inv_sx``, ``relu_in``): its int8
  input equal to JAX's ``clip(round(h.astype(f32) * inv_sx))``, the output
  bit-equal to ``requantize`` followed by the int8 plain conv;
- a requantised output (``inv_next``): bit-equal to ``epilogue_plain``'s
  float output rounded to ``mid_dtype``, relu, ``requantize``; against the
  same steps in JAX an output may differ by one step at a tie.

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
# tokens: the output type, "relu", "sout"; a float batch ("f32in", "bf16in")
# requantised on load, after a relu with "reluin"; an int8 output requantised
# through a float32 / bfloat16 rounding ("rqf32", "rqbf16")
FORMS = ["int8", "int8_relu", "float32", "bfloat16", "float32_sout", "bfloat16_sout_relu",
         "bf16in_reluin_bfloat16", "f32in_int8_relu", "int8_relu_rqbf16", "bf16in_reluin_int8_relu_rqbf16",
         "f32in_reluin_int8_rqf32"]
IN_TOKENS = {"f32in": torch.float32, "bf16in": torch.bfloat16}
MID_TOKENS = {"rqf32": torch.float32, "rqbf16": torch.bfloat16}


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
    outs = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}
    tokens = form.split("_")
    out = next(outs[t] for t in tokens if t in outs)
    return out, "relu" in tokens, "sout" in tokens


def _fused(form):
    """(float batch dtype or None, relu_in, mid dtype of a requantised output or None)"""
    tokens = form.split("_")
    return (next((IN_TOKENS[t] for t in tokens if t in IN_TOKENS), None), "reluin" in tokens,
            next((MID_TOKENS[t] for t in tokens if t in MID_TOKENS), None))


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
    in_dtype, relu_in, mid = _fused(form)
    t = torch.tensor
    kw = {}
    if in_dtype is not None:  # a float batch at int8 scale 1 / inv_sx, some of it beyond +-127
        rng = np.random.RandomState(5)
        h = t((rng.randn(*x.shape) * 60).astype(np.float32)).to(in_dtype)
        inv_sx = (rng.rand(shape[3]) + 0.5).astype(np.float32)
        kw.update(inv_sx=t(inv_sx), relu_in=relu_in)
        hf = np.maximum(h.float().numpy(), 0) if relu_in else h.float().numpy()
        x = np.asarray(jnp.clip(jnp.round(jnp.asarray(hf) * jnp.asarray(inv_sx)), -127, 127).astype(jnp.int8))
        xq = ic.requantize(h, t(inv_sx), relu_in)
        np.testing.assert_array_equal(xq.numpy(), x)  # the JAX package's requantisation
        assert (np.abs(x) == 127).any() and (x == 0).any()
    acc = _jax_acc(x, wq, stride)
    if mid is not None:  # scales that put a tenth of each channel's outputs past +-127
        v = np.abs(acc.astype(np.float32) * m + c).reshape(-1, shape[4])
        inv_next = (127 / np.percentile(v, 90, axis=0)).astype(np.float32)
        kw.update(inv_next=t(inv_next), mid_dtype=mid)
    packed = ic.pack_weights(wq)
    batch = h if in_dtype is not None else t(x)
    got = ic.conv2d_s8(batch, packed, kh, stride, t(m), t(c), relu, out_dtype, t(sout) if use_sout else None,
                       **kw)
    assert got.dtype == out_dtype and got.is_contiguous()
    if in_dtype is not None:  # PyTorch requantisation, then the int8 plain conv
        unfused = {k: v for k, v in kw.items() if k not in ("inv_sx", "relu_in")}
        assert torch.equal(got, ic.conv2d_s8_plain(xq, packed, kh, stride, t(m), t(c), relu, out_dtype,
                                                   t(sout) if use_sout else None, **unfused))
    if mid is not None:
        # the composition: the float epilogue, rounded to mid, relu, requantised
        v = ic.epilogue_plain(t(acc), t(m), t(c), relu, mid, None)
        want = ic.requantize(torch.relu(v) if relu else v, t(inv_next))
        assert torch.equal(got, want)
        # the same steps in JAX: an output at a tie may round apart
        y = acc.astype(jnp.float32) * jnp.asarray(m) + jnp.asarray(c)
        y = jnp.maximum(y, 0.0) if relu else y
        y = y.astype(jnp.bfloat16 if mid == torch.bfloat16 else jnp.float32).astype(jnp.float32)
        jax_q = np.asarray(jnp.clip(jnp.round(y * jnp.asarray(inv_next)), -127, 127).astype(jnp.int8))
        diff = np.abs(got.numpy().astype(int) - jax_q.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        assert (np.abs(got.numpy()) == 127).any() and (got.numpy() != 0).mean() > 0.2
        return
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
    with pytest.raises(ValueError, match="inv_sx"):  # a float batch without its scale
        ic.conv2d_s8(x.to(torch.bfloat16), p3, 3, 1, one, one)
    with pytest.raises(ValueError, match="int8 batch has neither"):
        ic.conv2d_s8(x, p3, 3, 1, one, one, inv_sx=torch.ones(16))
    with pytest.raises(ValueError, match="float32 of shape \\(16,\\)"):
        ic.conv2d_s8(x.float(), p3, 3, 1, one, one, inv_sx=one)
    with pytest.raises(ValueError, match="inv_next"):  # a float output has no requantisation
        ic.conv2d_s8(x, p3, 3, 1, one, one, out_dtype=torch.bfloat16, inv_next=one)
    with pytest.raises(ValueError, match="mid_dtype"):
        ic.conv2d_s8(x, p3, 3, 1, one, one, mid_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mid_dtype"):
        ic.conv2d_s8(x, p3, 3, 1, one, one, inv_next=one, mid_dtype=torch.float16)
    before = ic.launches
    ic.conv2d_s8(x, p3, 3, 1, one, one)
    assert ic.launches == before  # the plain version is no launch
