"""The Lanczos-4 stack resize's plain PyTorch version (what the CUDA kernel is
held against on the card) against the host resize, on the CPU.

``ops/resize_lanczos4.py::resize_lanczos4`` on a CPU tensor against
``models/preprocess.py::host_resize`` (``resize_lanczos4_host``, equal to
the JAX package's), its banded weights against the dense matrix, the
kernel's tile plans, the wrapper's checks, and ``compute_inv_depth``'s
upload-then-resize against the host resize for dtypes the kernel does not
take.

Tolerances. The two versions sum in other orders, so an integer may round
the other way where the exact value lies within float32's rounding error
of a half-integer: integers are held equal wherever the float64 value lies
farther than ``half_margin`` from one (1e-3 for uint8; for uint16 the
rounding error grows with the values, to 1e-6 of the range), and never
more than one level apart; float32 within 1e-4 of the input's range.
"""

import numpy as np
import pytest
import torch

from tmat_torch.models.preprocess import host_resize
from tmat_torch.ops import resize_lanczos4 as rl
from tmat_torch.ops.resize import lanczos4_weight_matrix
from tmat_torch.tools import compute_inv_depth as inv

TOPS = {"uint8": 255, "uint16": 65535, "float32": 1.0}
# (input (Z, H, W) or (H, W), output (h, w)): the cell's 4x downsample, a
# mild one, an unchanged size, an upsample, a non-square stack, a 2-D image
SIZES = [((2, 1024, 1024), (256, 256)), ((3, 80, 80), (64, 64)), ((3, 64, 64), (64, 64)),
         ((2, 50, 50), (96, 96)), ((3, 100, 90), (64, 64)), ((80, 70), (33, 47))]


def size_id(case):
    return "x".join(map(str, case[0])) + "-" + "x".join(map(str, case[1]))


def half_margin(dtype: str) -> float:
    return max(1e-3, 1e-6 * TOPS[dtype])


def exact(stack: np.ndarray, shape) -> np.ndarray:
    """The resize in float64 with the float32 weights, before rounding."""
    x = stack.astype(np.float64).reshape(-1, *stack.shape[-2:])
    wv = lanczos4_weight_matrix(x.shape[1], shape[0]).astype(np.float64)
    wh = lanczos4_weight_matrix(x.shape[2], shape[1]).astype(np.float64)
    return wv @ x @ wh.T


def assert_resized_close(out: np.ndarray, ref: np.ndarray, stack: np.ndarray, shape) -> None:
    """``out`` and ``ref``, two resizes of ``stack``, within the module
    doc's tolerances."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    if stack.dtype == np.float32:
        assert diff.max() <= 1e-4 * (float(stack.max()) - float(stack.min()))
        return
    assert diff.max() <= 1
    value = exact(stack, shape)
    near_half = np.abs(value - np.floor(value) - 0.5) <= half_margin(stack.dtype.name)
    assert not (diff[~near_half] > 0).any()


def random_stack(dtype: str, shape, seed=0) -> np.ndarray:
    return (np.random.RandomState(seed).rand(*shape) * TOPS[dtype]).astype(dtype)


@pytest.mark.parametrize("case", SIZES, ids=size_id)
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_plain_matches_the_host_resize(dtype, case):
    shape_in, shape = case
    stack = random_stack(dtype, shape_in)
    out = rl.resize_lanczos4(torch.from_numpy(stack), shape)
    assert rl.resize_lanczos4_plain(torch.from_numpy(stack), shape).equal(out)
    assert out.shape == (shape_in[0] if len(shape_in) == 3 else 1, *shape)
    assert_resized_close(out.numpy(), host_resize(stack, shape), stack, shape)


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_plain_rounds_and_clips_at_full_range(dtype):
    """Dark and saturated squares: Lanczos rings past both ends of the range,
    so the clip acts on both sides."""
    rr, cc = np.mgrid[0:96, 0:96]
    stack = np.where(((rr // 12) + (cc // 12)) % 2 == 0, TOPS[dtype], 0).astype(dtype)[None]
    value = exact(stack, (40, 40))
    assert value.min() < -0.5 and value.max() > TOPS[dtype] + 0.5
    out = rl.resize_lanczos4(torch.from_numpy(stack), (40, 40)).numpy()
    assert out.min() == 0 and out.max() == TOPS[dtype]
    assert_resized_close(out, host_resize(stack, (40, 40)), stack, (40, 40))


@pytest.mark.parametrize("n_in,n_out,taps", [(1024, 256, 32), (80, 64, 10), (64, 64, 7), (50, 96, 8),
                                             (2048, 37, 443), (7, 300, 7)])
def test_band_holds_every_nonzero_weight(n_in, n_out, taps):
    dense = lanczos4_weight_matrix(n_in, n_out)
    b = rl.band(n_in, n_out)
    assert b.first.dtype == b.count.dtype == np.int32 and b.weights.dtype == np.float32
    assert b.weights.shape == (n_out, taps) and b.count.max() == taps
    rebuilt = np.zeros_like(dense)
    for i in range(n_out):
        rebuilt[i, b.first[i]:b.first[i] + b.count[i]] = b.weights[i, :b.count[i]]
        assert (b.weights[i, b.count[i]:] == 0).all()
        assert dense[i, b.first[i]] != 0 and dense[i, b.first[i] + b.count[i] - 1] != 0
    np.testing.assert_array_equal(rebuilt, dense)
    assert (np.diff(b.first) >= 0).all() and (np.diff(b.first + b.count) >= 0).all()


@pytest.mark.parametrize("sizes,expected", [
    ((1024, 1024, 256, 256), (16, 32, 92, 156)),  # the cell's: every row of a tile in one load
    ((2048, 300, 37, 256), None),                  # rows in chunks
    ((8192, 8192, 256, 256), None),                # tiles shrink
    ((50, 50, 96, 96), None), ((64, 64, 64, 64), None), ((100, 90, 64, 64), None),
])
def test_plan_fits_and_covers_every_tile(sizes, expected):
    H, W, h, w = sizes
    th, tw, rc, cp = plan = rl.plan(H, W, h, w)
    if expected is not None:
        assert plan == expected
    bv, bh = rl.band(H, h), rl.band(W, w)
    assert rl.smem_bytes(th, tw, rc, cp, bv, bh) <= rl.SMEM_BYTES
    for j0 in range(0, w, tw):
        j1 = min(j0 + tw, w) - 1
        assert bh.first[j1] + bh.count[j1] - bh.first[j0] <= cp
    rows = max(bv.first[min(i0 + th, h) - 1] + bv.count[min(i0 + th, h) - 1] - bv.first[i0]
               for i0 in range(0, h, th))
    assert 1 <= rc <= rows == rl._span(bv, th)
    if sizes[0] == 2048:
        assert rc < rows  # loaded in chunks


def test_wrapper_refuses():
    stack = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8, uint16 or float32"):
        rl.resize_lanczos4(stack.to(torch.int16), (4, 4))
    for bad in (stack[None], stack[0, 0], stack[:, :0]):
        with pytest.raises(ValueError, match="non-empty"):
            rl.resize_lanczos4(bad, (4, 4))
    with pytest.raises(ValueError, match="not contiguous"):
        rl.resize_lanczos4(stack.transpose(1, 2), (4, 4))
    with pytest.raises(ValueError, match="positive output size"):
        rl.resize_lanczos4(stack, (0, 4))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        rl.resize_lanczos4_plain(stack.to("meta"), (4, 4))


def test_the_cpu_counts_no_launch():
    before = rl.launches
    rl.resize_lanczos4(torch.zeros((1, 8, 8)), (4, 4))
    assert rl.launches == before


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32", "float64", "int16", "int32", "uint32",
                                   "float16", "bool"])
def test_resize_stack_is_the_host_resize(dtype):
    """``compute_inv_depth.resize_stack``, the tool's upload and resize, for
    every dtype the host resize takes: the kernel's dtypes as they are,
    others as float32 and integers rounded and clipped to their range."""
    rng = np.random.RandomState(3)
    if dtype == "bool":
        stack = rng.rand(2, 40, 36) > 0.5
    elif np.issubdtype(np.dtype(dtype), np.integer):
        info = np.iinfo(dtype)
        stack = rng.randint(max(info.min, -30000), min(info.max, 30000) + 1, (2, 40, 36)).astype(dtype)
    else:
        stack = (rng.rand(2, 40, 36) * 100 - 20).astype(dtype)
    out = inv.resize_stack(stack, (32, 32), torch.device("cpu"))
    ref = host_resize(stack, (32, 32))
    if dtype in ("uint8", "uint16", "float32"):
        assert out.dtype == getattr(torch, dtype)
        assert_resized_close(out.numpy(), ref, stack, (32, 32))
        return
    assert out.dtype == torch.float32
    diff = np.abs(out.numpy().astype(np.float64) - ref.astype(np.float64))
    if ref.dtype.kind == "f":
        assert diff.max() <= 1e-4 * 120
    else:
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
