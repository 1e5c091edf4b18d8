"""The port's raster ops against the JAX package, one parametrised test per
op, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.ops import distance as jdist, morphology as jmorph, rescale as jrescale
from tmat_tpu.ops import resize as jresize, threshold as jthresh, zproj as jzproj
from tmat_tpu.parallel.plate import packbits_device, unpackbits_device
from tmat_tpu.topo.transforms import _median_filter_disk2_batch, median_filter_batch as jax_median_batch
from tmat_torch.ops import distance, focus_stack, morphology, rescale, resize, threshold, zproj
from tmat_torch.parallel import plate
from tmat_torch.parallel.plate import packbits, unpackbits
from tmat_torch.topo.transforms import median_filter_batch, median_filter_disk2_batch


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


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", ["lanczos", "lanczos3", "lanczos4", "cubic", "linear", "bilinear",
                                    "nearest"])
@pytest.mark.parametrize("src,dst", [((37, 53), (20, 29)), ((64, 64), (17, 40)), ((20, 29), (37, 53))],
                         ids=["down", "down_4x", "up"])
def test_resize_antialias(method, antialias, src, dst):
    """Every method with and without antialiasing, downsampling and
    upsampling: within 1e-5 of ``jax.image.resize``. Without antialiasing a
    downsampling kernel keeps its width, so the two settings differ there."""
    x = np.random.RandomState(sum(dst)).rand(2, *src).astype(np.float32)
    ref = np.asarray(jresize.resize(jnp.asarray(x), dst, method, antialias))
    out = resize.resize(torch.tensor(x), dst, method, antialias).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    other = resize.resize(torch.tensor(x), dst, method, not antialias).numpy()
    assert np.array_equal(other, out) == (method == "nearest" or dst[0] > src[0])


def test_resize_weight_cache_keeps_antialiased_weights():
    """The flag is part of the cache's key: a call without antialiasing
    leaves the default's weights as they were."""
    before = resize.weight_matrix(1024, 640, "lanczos").copy()
    sharp = resize.weight_matrix(1024, 640, "lanczos", False)
    assert not np.array_equal(sharp, before)
    np.testing.assert_array_equal(resize.weight_matrix(1024, 640, "lanczos"), before)


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


@pytest.mark.parametrize("in_range", [(0.0, 1.0), (2.0, 30.0), (-3, 50), (5.0, 5.0)])
def test_rescale_intensity_in_range(in_range):
    """Clip to ``in_range``, then map onto ``out_range``; an empty range maps
    to out_min. Within 1e-6 of the JAX function."""
    x = (np.random.RandomState(1).rand(2, 19, 23) * 40 - 5).astype(np.float32)
    for out_range in ((0, 1), (0, 255), (-1, 1)):
        ref = np.asarray(jrescale.rescale_intensity(jnp.asarray(x), out_range, in_range))
        out = rescale.rescale_intensity(torch.tensor(x), out_range, in_range).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6 * max(map(abs, out_range)), rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_apply_mask_and_bin_thresh(dtype):
    """Both exact, in the image's dtype."""
    rng = np.random.RandomState(3)
    img = (rng.rand(17, 21) * 200).astype(dtype)
    mask = (rng.rand(17, 21) > 0.4).astype(np.uint8)
    ref = np.asarray(jrescale.apply_mask(jnp.asarray(img), jnp.asarray(mask)))
    out = rescale.apply_mask(torch.tensor(img), torch.tensor(mask)).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    for img_max, thresh in ((255.0, 0.0), (1.0, 100.0), (7, 50.5)):
        ref = np.asarray(jrescale.bin_thresh(jnp.asarray(img), img_max, thresh))
        out = rescale.bin_thresh(torch.tensor(img), img_max, thresh).numpy()
        assert out.dtype == ref.dtype == img.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("method", ["max", "min", "avg", "med", "fs"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_zproj(method, dtype):
    """Host and masked device projections, ragged Z: exact. The whole-stack
    projections of ``PROJ_METHODS`` too. ``fs`` has no host projection."""
    rng = np.random.RandomState(1)
    stack = rng.randint(0, 250, (5, 19, 23)).astype(dtype)
    whole = zproj.PROJ_METHODS[method](torch.from_numpy(stack))
    ref_whole = np.asarray(jzproj.PROJ_METHODS[method](jnp.asarray(stack)))
    assert whole.numpy().dtype == ref_whole.dtype
    np.testing.assert_array_equal(whole.numpy(), ref_whole)
    for z in (1, 2, 3, 5):
        if method == "fs":
            padded = stack.copy()
            padded[z:] = 0
            ref = np.asarray(jzproj.proj_masked(jnp.asarray(padded), z, method))
            out = zproj.proj_masked(torch.from_numpy(padded), z, method).numpy()
            np.testing.assert_array_equal(out, ref)
            with pytest.raises(ValueError, match="fs"):
                zproj.proj_host(stack[:z], method)
            continue
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


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_proj_focus_stacking_batch(dtype):
    """A (B, Z, H, W) plate at full depth against the JAX function (XLA's
    form), in the stacks' dtype: uint8 equal; wider types differ at most at
    |Laplacian| near-ties (``focus_stack.compare_with_plain``'s rule, with
    the JAX result in the plain version's place)."""
    rng = np.random.RandomState(7)
    top = {"uint8": 255, "uint16": 4095, "float32": 255}[dtype]
    stacks = (rng.rand(3, 5, 37, 41) * top).astype(dtype)
    ref = np.asarray(jzproj.proj_focus_stacking_batch(jnp.asarray(stacks)))
    out = zproj.proj_focus_stacking_batch(torch.from_numpy(stacks))
    assert out.numpy().dtype == ref.dtype == stacks.dtype
    x = torch.from_numpy(stacks).float()
    scores = focus_stack.focus_scores(x)

    def chosen(values):  # the best score among the slices that hold the chosen value
        return torch.where(x == values[:, None], scores, float("-inf")).amax(dim=1)

    differ = out.numpy() != ref
    if dtype == "uint8":
        assert not differ.any()
    best = scores.amax(1)
    near = (best - torch.minimum(chosen(out.float()), chosen(torch.tensor(ref).float()))) <= 1e-4 * best
    assert differ.mean() <= 1e-3 and near.numpy()[differ].all()
    with pytest.raises(ValueError, match="B, Z, H, W"):
        zproj.proj_focus_stacking_batch(torch.from_numpy(stacks[0]))


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


@pytest.mark.parametrize("op", ["median", "median_batch", "skeletonize", "skeletonize_2d", "packbits",
                                "packbits_device", "edt", "edt_2d", "dilation", "closing"])
def test_raster_ops_exact(op):
    rng = np.random.RandomState(4)
    masks = _blobs(rng)
    if op in ("median", "median_batch"):
        x = (rng.rand(3, 41, 37) > 0.5).astype(np.float32)
        ref = np.asarray(_median_filter_disk2_batch(jnp.asarray(x)))
        if op == "median_batch":  # the JAX package's name for the batched median
            ref = np.asarray(jax_median_batch(x))
        out = (median_filter_batch if op == "median_batch" else median_filter_disk2_batch)(torch.tensor(x)).numpy()
    elif op == "skeletonize":
        ref = np.stack([np.asarray(jmorph.skeletonize(jnp.asarray(m))) for m in masks])
        out = morphology.skeletonize(torch.tensor(masks)).numpy()
        assert out.any()
    elif op == "skeletonize_2d":  # one (H, W) mask, as the JAX function takes it
        ref = np.asarray(jmorph.skeletonize(jnp.asarray(masks[0])))
        out = morphology.skeletonize(torch.tensor(masks[0])).numpy()
        assert out.shape == masks[0].shape and out.any()
    elif op in ("packbits", "packbits_device"):
        pack, unpack = ((plate.packbits_device, plate.unpackbits_device) if op == "packbits_device"
                        else (packbits, unpackbits))
        ref = np.asarray(packbits_device(jnp.asarray(masks)))
        out = pack(torch.tensor(masks)).numpy()
        np.testing.assert_array_equal(out, np.packbits(masks, axis=-1))
        back = unpack(torch.tensor(out), masks.shape[-1]).numpy()
        np.testing.assert_array_equal(back, np.asarray(unpackbits_device(jnp.asarray(ref), masks.shape[-1])))
        np.testing.assert_array_equal(back, masks)
    elif op in ("dilation", "closing"):  # the JAX package's names for the binary ops
        fp = jmorph.disk(2)
        ref = np.asarray(getattr(jmorph, op)(jnp.asarray(masks[0]), fp))
        out = getattr(morphology, op)(torch.tensor(masks[0]), fp).numpy()
        assert out.any() and not out.all()
    elif op == "edt_2d":  # one 2-D mask, and one with no background (the 1e9 sentinel)
        for m in (masks[0], np.ones_like(masks[0])):
            ref = np.asarray(jdist.edt(jnp.asarray(m), row_chunk=8))
            out = distance.edt(torch.tensor(m), row_chunk=8).numpy()
            np.testing.assert_array_equal(out, ref)
    else:
        masks[1] = True  # a mask without background: the 1e9 sentinel path
        ref = np.asarray(jdist.edt_batch(jnp.asarray(masks)))
        out = distance.edt_batch(torch.tensor(masks), row_chunk=8).numpy()
        np.testing.assert_array_equal(out ** 2, ref ** 2)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
