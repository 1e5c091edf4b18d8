"""The port's raster ops against the JAX package, one parametrised test per
op, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.ops import distance as jdist, morphology as jmorph, rescale as jrescale
from tmat_tpu.ops import resize as jresize, threshold as jthresh, zproj as jzproj
from tmat_tpu.parallel.plate import packbits_device, unpackbits_device
from tmat_tpu.topo.transforms import _median_filter_disk2_batch
from tmat_torch.ops import distance, morphology, rescale, resize, threshold, zproj
from tmat_torch.parallel.plate import packbits, unpackbits
from tmat_torch.topo.transforms import median_filter_disk2_batch


@pytest.mark.parametrize("method", ["lanczos", "linear", "nearest"])
@pytest.mark.parametrize("src,dst", [((37, 53), (20, 29)), ((20, 29), (37, 53)), ((64, 64), (40, 40)),
                                     ((33, 17), (33, 41)), ((128, 96), (80, 60))])
def test_resize(method, src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    x = rng.rand(2, *src).astype(np.float32)
    ref = np.asarray(jresize.resize(jnp.asarray(x), dst, method))
    out = resize.resize(torch.tensor(x), dst, method).numpy()
    assert out.shape == ref.shape == (2, *dst)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # integer inputs are rounded and clipped to their type
    xi = (x * 255).astype(np.uint8)
    refi = np.asarray(jresize.resize(jnp.asarray(xi), dst, method))
    outi = resize.resize(torch.tensor(xi), dst, method).numpy()
    assert outi.dtype == np.uint8
    assert np.abs(outi.astype(int) - refi.astype(int)).max() <= 1
    assert np.mean(outi == refi) > 0.999


@pytest.mark.parametrize("case", ["random", "constant", "negative"])
def test_rescale_intensity(case):
    rng = np.random.RandomState(0)
    x = {"random": rng.rand(31, 17) * 40 + 3, "constant": np.full((8, 9), 7.0),
         "negative": rng.randn(20, 20) * 5}[case].astype(np.float32)
    ref = np.asarray(jrescale.rescale_intensity(jnp.asarray(x), out_range=(0, 1)))
    out = rescale.rescale_intensity(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-7, rtol=0)
    batch = rescale.rescale_intensity(torch.tensor(np.stack([x, 2 * x])), dims=(-2, -1)).numpy()
    np.testing.assert_allclose(batch[0], ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("method", ["max", "min", "avg", "med"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_zproj(method, dtype):
    """Host and masked device projections, ragged Z: exact."""
    rng = np.random.RandomState(1)
    stack = rng.randint(0, 250, (5, 19, 23)).astype(dtype)
    for z in (1, 2, 3, 5):
        ref_host = np.asarray(jzproj.proj_host(stack[:z], method))
        out_host = zproj.proj_host(stack[:z], method)
        assert out_host.dtype == ref_host.dtype
        np.testing.assert_array_equal(out_host, ref_host)
        padded = stack.copy()
        padded[z:] = 0
        ref = np.asarray(jzproj.proj_masked(jnp.asarray(padded), z, method))
        out = zproj.proj_masked(torch.tensor(padded.astype(np.int32)), z, method).numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, out_host.astype(np.float32))


def _gmm_images(rng):
    h = w = 48
    rr, cc = np.mgrid[0:h, 0:w]
    imgs = []
    for i in range(3):
        img = rng.rand(h, w) * 0.2 + 0.05 * i
        img[np.abs(rr - 10 - 7 * i) < 3 + i] += 0.6
        img[np.abs(cc - 30) < 2] += 0.3 * (i + 1)
        imgs.append(img)
    imgs.append(rng.rand(h, w))  # unimodal
    return np.clip(np.stack(imgs), 0, 1).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sd_coef", [0.0, -2.0, 1.5])
def test_gmm_threshold(masked, sd_coef):
    """Batched EM with a per-image stop: each threshold within 1e-5 of the
    single-image JAX fit, and the thresholded images equal."""
    rng = np.random.RandomState(2)
    imgs = _gmm_images(rng)
    masks = (rng.rand(*imgs.shape) > 0.3).astype(np.float32) if masked else None
    weights = None if masks is None else torch.tensor(masks > 0).reshape(len(imgs), -1)
    t_out = threshold.gmm_foreground_threshold(torch.tensor(imgs).reshape(len(imgs), -1), sd_coef, weights)
    out = threshold.exec_threshold(torch.tensor(imgs), None if masks is None else torch.tensor(masks), sd_coef)
    for i, img in enumerate(imgs):
        m = None if masks is None else jnp.asarray(masks[i])
        t_ref = float(jthresh.gmm_foreground_threshold(jnp.asarray(img), sd_coef, None if m is None else m > 0))
        assert abs(float(t_out[i]) - t_ref) <= 1e-5, (i, float(t_out[i]), t_ref)
        ref = np.asarray(jthresh.exec_threshold(jnp.asarray(img), m, sd_coef))
        np.testing.assert_array_equal(out[i].numpy() > 0, ref > 0)


def _blobs(rng, shape=(3, 41, 37)):
    x = rng.rand(*shape)
    from scipy import ndimage

    return ndimage.uniform_filter(x, size=(1, 5, 5)) > 0.5


@pytest.mark.parametrize("op", ["median", "skeletonize", "packbits", "edt"])
def test_raster_ops_exact(op):
    rng = np.random.RandomState(4)
    masks = _blobs(rng)
    if op == "median":
        x = (rng.rand(3, 41, 37) > 0.5).astype(np.float32)
        ref = np.asarray(_median_filter_disk2_batch(jnp.asarray(x)))
        out = median_filter_disk2_batch(torch.tensor(x)).numpy()
    elif op == "skeletonize":
        ref = np.stack([np.asarray(jmorph.skeletonize(jnp.asarray(m))) for m in masks])
        out = morphology.skeletonize(torch.tensor(masks)).numpy()
        assert out.any()
    elif op == "packbits":
        ref = np.asarray(packbits_device(jnp.asarray(masks)))
        out = packbits(torch.tensor(masks)).numpy()
        np.testing.assert_array_equal(out, np.packbits(masks, axis=-1))
        back = unpackbits(torch.tensor(out), masks.shape[-1]).numpy()
        np.testing.assert_array_equal(back, np.asarray(unpackbits_device(jnp.asarray(ref), masks.shape[-1])))
        np.testing.assert_array_equal(back, masks)
    else:
        masks[1] = True  # a mask without background: the 1e9 sentinel path
        ref = np.asarray(jdist.edt_batch(jnp.asarray(masks)))
        out = distance.edt_batch(torch.tensor(masks), row_chunk=8).numpy()
        np.testing.assert_array_equal(out ** 2, ref ** 2)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
