"""The focus-stacking projection's plain PyTorch version (what the CUDA
kernel is held against on the card) against the JAX package on the CPU:
the Pallas kernel in interpret mode, the XLA composition
``_focus_stack_zhw`` and the ragged ``proj_masked(..., "fs")``.

Tolerances. uint8 input: exact, ties included (every intermediate is an
exact float32 multiple of 2**-8). uint16 and float32 at the shapes of
``tests/test_pallas_zproj.py``: the plain version sums the Pallas kernel's
taps in its order, and is equal to both references there. Elsewhere a
float32 near-tie may fall to another slice: at most 1e-4 of the pixels,
each with the two slices' scores within 1e-5 relative. On an axis of
length 3 the border's period is 4 and the centre's Laplacian is zero by
symmetry in every slice, so all slices tie at rounding noise: there the
scores are held within 1e-5 of the Laplacian's tap mass (128) times the
largest input, and any share of the (at most 36) pixels may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.ops import zproj as jzproj
from tmat_tpu.ops.pallas_zproj import proj_focus_stacking_pallas
from tmat_torch.ops import zproj
from tmat_torch.ops.focus_stack import focus_scores, focus_stack, focus_stack_plain


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _plain(stack: np.ndarray, z_count=None) -> np.ndarray:
    zc = None if z_count is None else [z_count]
    return _np(focus_stack_plain(torch.from_numpy(stack)[None], zc)[0])


def assert_near_tie_equal(out, ref, stack, z_count=None, max_share=1e-4, floor=0.0):
    """The near-tie rule for float32 and wide uint16 input."""
    diff = out != ref
    assert diff.mean() <= max_share, f"{diff.sum()} of {diff.size} pixels differ"
    if not diff.any():
        return
    z = stack.shape[0] if z_count is None else z_count
    scores = focus_scores(torch.from_numpy(stack[:z].astype(np.float32))).numpy()
    for r, c in np.argwhere(diff):
        s_out = scores[:, r, c][stack[:z, r, c] == out[r, c]].max()
        s_ref = scores[:, r, c][stack[:z, r, c] == ref[r, c]].max()
        assert abs(s_out - s_ref) <= 1e-5 * max(s_out, s_ref, floor), (r, c, s_out, s_ref)


@pytest.mark.parametrize("shape", [(5, 100, 150), (3, 64, 64), (8, 33, 257)])
def test_plain_matches_pallas_and_xla(shape):
    stack = (np.random.RandomState(0).rand(*shape) * 255).astype(np.float32)
    out = _plain(stack)
    pallas = np.asarray(proj_focus_stacking_pallas(jnp.asarray(stack), tile=64, interpret=True))
    xla = np.asarray(jzproj._focus_stack_zhw(jnp.asarray(stack)))
    assert out.dtype == np.float32 and out.shape == shape[1:]
    np.testing.assert_array_equal(out, pallas)
    np.testing.assert_array_equal(out, xla)


def test_plain_uint16_roundtrip():
    stack = np.random.RandomState(0).randint(0, 65535, size=(4, 40, 40)).astype(np.uint16)
    out = _plain(stack)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(
        out, np.asarray(proj_focus_stacking_pallas(jnp.asarray(stack), tile=64, interpret=True)))
    np.testing.assert_array_equal(out, np.asarray(jzproj._focus_stack_zhw(jnp.asarray(stack))))


@pytest.mark.parametrize("shape", [(8, 64, 96), (3, 5, 5), (3, 2, 3), (12, 33, 130)])
def test_uint8_exact_with_ties(shape):
    """The last slice is the first plus one grey level: the same scores
    (the Laplacian of a constant is zero, exactly so in integers) on other
    values, so equal best scores are common and the rule shows: the first
    slice of the largest score wins in all three."""
    stack = np.random.RandomState(1).randint(0, 255, size=shape).astype(np.uint8)
    stack[-1] = stack[0] + 1
    out = _plain(stack)
    scores = np.sort(focus_scores(torch.from_numpy(stack)).numpy(), axis=0)
    assert (scores[-1] == scores[-2]).mean() > 0.01
    np.testing.assert_array_equal(out, np.asarray(jzproj._focus_stack_zhw(jnp.asarray(stack))))
    np.testing.assert_array_equal(
        out, np.asarray(proj_focus_stacking_pallas(jnp.asarray(stack), tile=64, interpret=True)))


@pytest.mark.parametrize("h", range(1, 7))
@pytest.mark.parametrize("w", range(1, 7))
def test_images_smaller_than_the_support(h, w):
    """The border keeps reflecting (period 2(n-1); an axis of length 1
    repeats its pixel) as ``jnp.pad(mode="reflect")`` does. uint8, so exact."""
    stack = np.random.RandomState(10 * h + w).randint(0, 256, size=(4, h, w)).astype(np.uint8)
    np.testing.assert_array_equal(_plain(stack), np.asarray(jzproj._focus_stack_zhw(jnp.asarray(stack))))
    f32 = stack.astype(np.float32) * np.float32(1.37)
    assert_near_tie_equal(_plain(f32), np.asarray(jzproj._focus_stack_zhw(jnp.asarray(f32))), f32,
                          max_share=1.0, floor=128 * float(f32.max()))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_ragged_z_matches_proj_masked(dtype):
    rng = np.random.RandomState(2)
    stacks = (rng.rand(4, 6, 37, 53) * (4000 if dtype == np.uint16 else 255)).astype(dtype)
    z_counts = [6, 4, 1, 3]
    for s, z in zip(stacks, z_counts):
        s[z:] = 0
    batch = zproj.proj_masked_batch(torch.from_numpy(stacks), z_counts, "fs")
    assert batch.dtype == torch.float32 and tuple(batch.shape) == (4, 37, 53)
    for b, z in enumerate(z_counts):
        ref = np.asarray(jzproj.proj_masked(jnp.asarray(stacks[b]), z, "fs"))
        one = zproj.proj_masked(torch.from_numpy(stacks[b]), z, "fs").numpy()
        np.testing.assert_array_equal(one, batch[b].numpy())
        if dtype == np.uint8:
            np.testing.assert_array_equal(one, ref)
        else:
            assert_near_tie_equal(one, ref, stacks[b].astype(np.float32), z)
        # the padding never wins, whatever it holds
        noisy = stacks[b].copy()
        noisy[z:] = (rng.rand(6 - z, 37, 53) * 255).astype(dtype)
        np.testing.assert_array_equal(zproj.proj_masked(torch.from_numpy(noisy), z, "fs").numpy(), one)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("kernel_size", [3, 5, 7])
def test_proj_focus_stacking_dispatch(axis, kernel_size):
    """Any axis; kernel size 5 through the focus-stack module, other sizes
    through the conv2d composition. uint8, so exact."""
    stack = np.random.RandomState(3).randint(0, 256, size=(9, 11, 13)).astype(np.uint8)
    ref = np.asarray(jzproj.proj_focus_stacking(jnp.asarray(stack), axis, kernel_size))
    out = zproj.proj_focus_stacking(torch.from_numpy(stack), axis, kernel_size)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref)


def test_other_dtypes_go_through_float32():
    stack = np.random.RandomState(4).randint(0, 30000, size=(3, 16, 16)).astype(np.int32)
    out = zproj.proj_focus_stacking(torch.from_numpy(stack))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jzproj._focus_stack_zhw(jnp.asarray(stack))))


def test_wrapper_checks_its_input():
    x = torch.zeros((2, 3, 8, 8), dtype=torch.uint8)
    assert focus_stack(x).shape == (2, 8, 8)  # a CPU tensor takes the plain version
    with pytest.raises(ValueError, match="B, Z, H, W"):
        focus_stack(x[0])
    with pytest.raises(TypeError, match="uint8, uint16 or float32"):
        focus_stack(x.double())
    for bad in ([3], [0, 1], [1, 4], [1, 2, 3]):
        with pytest.raises(ValueError, match="z_counts"):
            focus_stack(x, bad)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_full_depth_equals_explicit_depths(dtype):
    """``None`` is the full depth of every stack: the same projection as
    ``[Z] * B`` given as host values or as an int32 tensor."""
    stacks = torch.from_numpy((np.random.RandomState(5).rand(3, 4, 21, 34) * 200).astype(dtype))
    full = focus_stack(stacks, None)
    assert torch.equal(full.float(), focus_stack(stacks, [4] * 3).float())
    assert torch.equal(full.float(), focus_stack(stacks, torch.full((3,), 4, dtype=torch.int32)).float())
    assert torch.equal(full.float(), focus_stack(stacks).float())


def test_depths_as_a_tensor():
    """An int32 tensor of depths gives what the same host values give; a
    tensor of another type, length or device is refused, and a CPU tensor's
    values are range-checked like host values."""
    stacks = torch.from_numpy(np.random.RandomState(6).randint(0, 256, size=(3, 5, 17, 23)).astype(np.uint8))
    ragged = [5, 2, 1]
    assert torch.equal(focus_stack(stacks, torch.tensor(ragged, dtype=torch.int32)), focus_stack(stacks, ragged))
    assert torch.equal(focus_stack(stacks, np.asarray(ragged, np.int64)), focus_stack(stacks, ragged))
    for dtype in (torch.int64, torch.float32, torch.uint8):
        with pytest.raises(TypeError, match="int32"):
            focus_stack(stacks, torch.tensor(ragged, dtype=dtype))
    for bad in ([5, 2], [5, 2, 1, 1], [[5, 2, 1]]):
        with pytest.raises(ValueError, match="z_counts"):
            focus_stack(stacks, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(ValueError, match="z_counts"):
        focus_stack(stacks, torch.tensor(ragged, dtype=torch.int32, device="meta"))
    for bad in ([0, 2, 1], [6, 2, 1], [-1, 2, 1]):
        with pytest.raises(ValueError, match="z_counts"):
            focus_stack(stacks, torch.tensor(bad, dtype=torch.int32))


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_projection_of_one_stack_uploads_no_depths(kernel_size, monkeypatch):
    """``proj_focus_stacking`` asks for the full depth with ``None``, so the
    wrapper has no depths to check or upload, whatever the kernel size."""
    seen = []
    real = zproj.focus_stack

    def spy(stacks, z_counts=None):
        seen.append(z_counts)
        return real(stacks, z_counts)

    monkeypatch.setattr(zproj, "focus_stack", spy)
    stack = np.random.RandomState(7).randint(0, 256, size=(4, 12, 14)).astype(np.uint8)
    out = zproj.proj_focus_stacking(torch.from_numpy(stack), 0, kernel_size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jzproj.proj_focus_stacking(jnp.asarray(stack), 0, kernel_size)))
    assert seen == ([None] if kernel_size == 5 else [])


@pytest.mark.parametrize("z_counts, handed", [(None, None), ([4, 4, 4], None), (np.array([4, 4, 4]), None),
                                              ([4, 2, 4], [4, 2, 4]), ([4, 4], [4, 4])])
def test_a_chunk_at_full_depth_uploads_no_depths(z_counts, handed, monkeypatch):
    """``plate_zproj_masked`` and ``proj_masked_batch`` hand the wrapper
    ``None`` when every stack of the chunk has its full depth, and the
    depths as given when one is shorter or their number is wrong (which the
    wrapper then refuses)."""
    from tmat_torch.parallel.plate import plate_zproj_masked

    seen = []
    real = zproj.focus_stack

    def spy(stacks, z_counts=None):
        seen.append(z_counts)
        return real(stacks, z_counts)

    monkeypatch.setattr(zproj, "focus_stack", spy)
    stacks = torch.from_numpy(np.random.RandomState(8).randint(0, 256, size=(3, 4, 15, 18)).astype(np.uint8))
    if handed is not None and len(handed) != 3:
        with pytest.raises(ValueError, match="z_counts"):
            plate_zproj_masked(stacks, z_counts, "fs")
        assert seen == [handed]
        return
    out = plate_zproj_masked(stacks, z_counts, "fs")
    assert seen == [handed]
    want = focus_stack_plain(stacks, [4] * 3 if z_counts is None else list(z_counts)).float()
    assert torch.equal(out, want)
    for method in ("max", "min", "avg", "med"):  # None is the full depth for these too
        full = zproj.proj_masked_batch(stacks, None, method)
        assert torch.equal(full, zproj.proj_masked_batch(stacks, [4] * 3, method))
