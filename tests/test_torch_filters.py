"""The port's separable filters against the JAX package, on the same numpy
inputs. Tolerance: 1e-5 absolute in float32 on inputs in [0, 1] (the two
convolutions sum their taps in another order); the kernels are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.ops import filters as jf
from tmat_torch.ops import filters as tf

ATOL = 1e-5
SHAPES = [(23, 31), (2, 3, 16, 9), (3, 1, 1), (2, 2), (1, 7)]


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("case", [("gauss", 1, 0.0), ("gauss", 3, 0.0), ("gauss", 5, 0.0), ("gauss", 7, 0.0),
                                  ("gauss", 9, 0.0), ("gauss", 5, 1.3), ("deriv", 2, 5), ("deriv", 0, 5),
                                  ("deriv", 1, 3), ("deriv", 2, 7), ("g1d", 1.0, 4.0), ("g1d", 2.5, 3.0)])
def test_kernels_equal(case):
    kind, a, b = case
    fn = {"gauss": "cv2_gaussian_kernel", "deriv": "cv2_deriv_kernel", "g1d": "gaussian_kernel_1d"}[kind]
    ref, out = getattr(jf, fn)(a, b), getattr(tf, fn)(a, b)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("mode", ["reflect", "mirror", "nearest", "symmetric", "constant"])
@pytest.mark.parametrize("shape", SHAPES)
def test_sepconv2d(mode, shape):
    """Every border mode, with a kernel longer than the small images, so
    that the border is reflected more than once."""
    if mode == "symmetric" or min(shape[-2:]) > 3:
        ky, kx = np.array([1, 4, 6, 4, 1], np.float32) / 16, np.array([0.2, 0.5, 0.3], np.float32)
    else:
        ky = kx = np.array([0.25, 0.5, 0.25], np.float32)
    x = _img(shape, 1)
    ref = np.asarray(jf.sepconv2d(jnp.asarray(x), ky, kx, mode))
    out = tf.sepconv2d(torch.tensor(x), ky, kx, mode).numpy()
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(23, 31), (4, 20, 20), (3, 5, 5), (2, 2, 3)])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_blur_and_laplacian(shape, ksize):
    x = _img(shape, 2)
    ref = np.asarray(jf.gaussian_blur_cv2(jnp.asarray(x), ksize))
    out = tf.gaussian_blur_cv2(torch.tensor(x), ksize).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the Laplacian's taps sum to 2 * 4**(ksize-1) in magnitude: relative to that
    ref = np.asarray(jf.laplacian_cv2(jnp.asarray(x), ksize))
    out = tf.laplacian_cv2(torch.tensor(x), ksize).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL * 2 * 4 ** (ksize - 1), rtol=0)


@pytest.mark.parametrize("mode", ["nearest", "constant", "reflect"])
@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
def test_gaussian(mode, sigma):
    x = _img((3, 19, 27), 3)
    ref = np.asarray(jf.gaussian(jnp.asarray(x), sigma, mode))
    out = tf.gaussian(torch.tensor(x), sigma, mode).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
def test_reflect_index_is_numpy_reflect(n):
    """The periodic REFLECT_101 index that the focus kernel computes."""
    ref = np.pad(np.arange(n), (4, 6), mode="reflect")
    np.testing.assert_array_equal(tf.reflect_index(-4, n + 6, n), ref)
