"""The port's well-mask chain against the JAX package on the same numpy
inputs. Otsu and binary morphology are exact as booleans, and so is Canny
on grey images. The superellipse search is given the JAX package's own
unit draws (``jax.random.uniform(PRNGKey(seed))``), and then its
parameters agree to 1e-6 and every mask downstream is equal, on the wells
of ``WELLS``.

Where it is not exact, and why. Canny of a *binary* mask has exact ties:
across an axis-aligned edge the two rows beside it have the same gradient
magnitude, both are local maxima in exact arithmetic, and the last bit of
the Gaussian smoothing (XLA and PyTorch sum the taps in other orders)
decides which survive, in either package. The edge maps then agree within
one pixel, not bit for bit, the hull can move by a pixel, and the
perimeter count that picks the exponent (n = 2 or 8) moves with it. The
240-pixel wells of ``tests/test_wellmask.py`` (``TIE_WELLS``) resample to
200 pixels with long such edges: they are held by intersection over union.
The port's default draws are JAX's (``core/prng.py``), array-equal for
every seed tested, so its default masks equal the JAX package's on
``WELLS`` too, and the tie-heavy wells keep their IoU bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmat_tpu.ops import canny as jcanny, morphology as jmorph, threshold as jthresh, wellmask as jwell
from tmat_tpu.ops.resize import downsample_max_dim_shape as j_downsample_shape
from tmat_tpu.tools.compute_branches import make_well_mask as j_make_well_mask
from tmat_torch.ops import canny, morphology, threshold, wellmask
from tmat_torch.ops.resize import downsample_max_dim_shape


def synthetic_well(shape=(240, 240), kind="circle", bright_inside=True, seed=1):
    """The wells of tests/test_wellmask.py."""
    rng = np.random.RandomState(seed)
    h, w = shape
    rows, cols = np.mgrid[0:h, 0:w]
    cy, cx = h / 2, w / 2
    if kind == "circle":
        inside = (rows - cy) ** 2 + (cols - cx) ** 2 <= (0.42 * h) ** 2
    else:  # squircle
        inside = (np.abs((rows - cy) / (0.44 * h)) ** 8 + np.abs((cols - cx) / (0.44 * w)) ** 8) <= 1
    img = np.where(inside, 180.0, 40.0) if bright_inside else np.where(inside, 40.0, 180.0)
    img += rng.normal(0, 4, shape)
    return np.clip(img, 0, 255).astype(np.float32), inside


WELLS = {
    "circle150": dict(shape=(150, 150), kind="circle"),
    "squircle150": dict(shape=(150, 150), kind="squircle"),
    "wide": dict(shape=(180, 260), kind="squircle"),
    "large": dict(shape=(300, 280), kind="circle"),
    "dark": dict(shape=(220, 260), kind="circle", bright_inside=False),
    "ellipse_fit": dict(shape=(400, 400), kind="circle", seed=2),  # n = 2
}
# (well, least IoU with the JAX mask): tie-heavy after the resample to 200 px;
# the squircle sits at the perimeter/area threshold and the exponents differ
TIE_WELLS = {
    "circle": (dict(kind="circle"), 0.95),
    "dark_circle": (dict(kind="circle", bright_inside=False), 0.95),
    "squircle": (dict(kind="squircle"), 0.75),
}


def jax_draws(seed=0, num_iters=25000):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (num_iters, 6), jnp.float32))


def iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("case", ["bimodal", "uniform", "two_values", "constant", "negative"])
def test_otsu_threshold(case):
    rng = np.random.RandomState(0)
    x = {
        "bimodal": np.where(rng.rand(64, 64) > 0.6, 180, 40) + rng.normal(0, 9, (64, 64)),
        "uniform": rng.rand(50, 70) * 255,
        "two_values": np.where(rng.rand(40, 40) > 0.5, 10.0, 200.0),
        "constant": np.full((16, 16), 7.0),
        "negative": rng.randn(64, 64) * 3 - 5,
    }[case].astype(np.float32)
    ref = float(jthresh.otsu_threshold(jnp.asarray(x)))
    out = float(threshold.otsu_threshold(torch.tensor(x)))
    assert abs(out - ref) <= 1e-6 * max(1.0, abs(ref))
    np.testing.assert_array_equal(x >= out, x >= ref)


@pytest.mark.parametrize("op", ["binary_erosion", "binary_dilation", "binary_closing", "binary_opening"])
@pytest.mark.parametrize("footprint", ["disk1", "disk5", "square3", "square4"])
def test_binary_morphology(op, footprint):
    fp_j = {"disk1": jmorph.disk(1), "disk5": jmorph.disk(5), "square3": jmorph.square(3),
            "square4": jmorph.square(4)}[footprint]
    fp_t = {"disk1": morphology.disk(1), "disk5": morphology.disk(5), "square3": morphology.square(3),
            "square4": morphology.square(4)}[footprint]
    np.testing.assert_array_equal(np.asarray(fp_j), fp_t)
    rng = np.random.RandomState(3)
    from scipy import ndimage

    x = ndimage.uniform_filter(rng.rand(2, 47, 39), size=(1, 7, 7)) > 0.5
    x[0, :3] = True  # the border matters: erosion pads with True, dilation with False
    x[1, 10:35, 5:30] = True  # and something that survives a disk(5)
    ref = np.stack([np.asarray(getattr(jmorph, op)(jnp.asarray(m), fp_j)) for m in x])
    out = getattr(morphology, op)(torch.tensor(x), fp_t).numpy()
    assert out.dtype == bool and out.any()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", ["disk", "noisy", "blurred", "blank", "sigma0"])
def test_canny(case):
    rng = np.random.RandomState(4)
    rr, cc = np.mgrid[0:90, 0:110]
    disk = ((rr - 45) ** 2 + (cc - 50) ** 2 < 30 ** 2).astype(np.float32)
    img = {"disk": disk, "noisy": disk + 0.2 * rng.rand(90, 110), "blank": np.zeros((90, 110)),
           "blurred": np.asarray(jnp.asarray(disk)) * 0.6 + 0.1 * rng.rand(90, 110), "sigma0": disk}[case]
    img = img.astype(np.float32)
    kw = {"sigma": 0.0} if case == "sigma0" else {}
    ref = np.asarray(jcanny.canny(jnp.asarray(img), **kw))
    out = canny.canny(torch.tensor(img), **kw).numpy()
    assert out.dtype == bool
    assert ref.any() or case == "blank"
    if case == "disk":
        # a binary image with a Gaussian: exact ties (module docstring), so
        # each edge pixel has one of the other map within one pixel
        from scipy import ndimage

        near = np.ones((3, 3), bool)
        assert not (out & ~ndimage.binary_dilation(ref, near)).any()
        assert not (ref & ~ndimage.binary_dilation(out, near)).any()
        assert (out != ref).mean() < 0.005
    else:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", list(WELLS))
def test_auto_threshold_well(name):
    img, inside = synthetic_well(**WELLS[name])
    ref = np.asarray(jwell.auto_threshold_well(jnp.asarray(img)))
    out = wellmask.auto_threshold_well(torch.tensor(img)).numpy()
    # the blur's last bit can move a pixel across a grey level before Otsu
    assert (out != ref).mean() <= 1e-4
    assert iou(out, inside) > 0.8


@pytest.mark.parametrize("n", [2, 8, 3])
@pytest.mark.parametrize("shape", [(50, 60), (200, 200), (1, 5), (333, 127)])
def test_gen_superellipse_mask(n, shape):
    params = (0.07, 0.9, 1.03, 0.95, 0.05, -0.1)
    ref = np.asarray(jwell.gen_superellipse_mask(*params, n, shape))
    out = wellmask.gen_superellipse_mask(*params, n, shape).numpy()
    assert out.shape == shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [2, 8, 3])
def test_superellipse_search_with_jax_draws(n):
    """The search on the JAX package's draws: equal parameters to 1e-6."""
    rng = np.random.RandomState(5)
    ang = rng.rand(40) * 2 * np.pi
    x, y = 0.7 * np.cos(ang) + 0.03, 0.66 * np.sin(ang) - 0.02
    for seed in (0, 3):
        ref = jwell.get_superellipse_hull(x, y, n, seed=seed)
        out = wellmask.get_superellipse_hull(x, y, n, draws=jax_draws(seed))
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    # no candidate encloses points this far out
    with pytest.raises(RuntimeError, match="No feasible superellipse"):
        wellmask.get_superellipse_hull(3 * x, 3 * y, n, draws=jax_draws(0))
    with pytest.raises(RuntimeError, match="No feasible superellipse"):
        jwell.get_superellipse_hull(3 * x, 3 * y, n)


def test_default_draws_are_seeded_on_the_cpu():
    a, b = wellmask.unit_draws(3), wellmask.unit_draws(3)
    assert a.shape == (25000, 6) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert (a != wellmask.unit_draws(4)).any() and 0 <= a.min() and a.max() < 1


@pytest.mark.parametrize("name", list(WELLS))
def test_generate_well_mask_with_jax_draws(name):
    img, inside = synthetic_well(**WELLS[name])
    ref = jwell.generate_well_mask(img, mask_val=255, return_superellipse_params=True, seed=0)
    out = wellmask.generate_well_mask(img, mask_val=255, return_superellipse_params=True,
                                      draws=jax_draws(0))
    assert isinstance(ref, tuple) and isinstance(out, tuple)
    np.testing.assert_allclose(out[1:], ref[1:], atol=1e-6, rtol=0)
    assert out[0].dtype == np.uint8 and out[0].max() == 255
    np.testing.assert_array_equal(out[0], ref[0])
    assert iou(out[0] > 0, inside) > 0.7
    assert out[-1] == ref[-1] == (2 if name == "ellipse_fit" else 8)


@pytest.mark.parametrize("name", list(TIE_WELLS))
def test_generate_well_mask_on_tie_heavy_wells(name):
    kw, least = TIE_WELLS[name]
    img, inside = synthetic_well(**kw)
    ref = jwell.generate_well_mask(img, mask_val=255, seed=0) > 0
    out = wellmask.generate_well_mask(img, mask_val=255, draws=jax_draws(0)) > 0
    print(name, "IoU with the JAX mask, same draws", iou(out, ref))
    assert iou(out, ref) > least, iou(out, ref)
    assert iou(out, inside) > 0.7


@pytest.mark.parametrize("name", list(WELLS))
def test_make_well_mask_with_jax_draws(name):
    img, _ = synthetic_well(**WELLS[name])
    ref_mask, ref_shrunken = j_make_well_mask(img, seed=0)
    mask, shrunken = wellmask.make_well_mask(img, draws=jax_draws(0))
    assert mask.dtype == bool and shrunken.dtype == bool
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(shrunken, ref_shrunken)
    assert shrunken.sum() < mask.sum()


@pytest.mark.parametrize("name", list(WELLS))
def test_default_draws_fit_a_similar_mask(name):
    """The same stream of candidates for the same seed: the two packages'
    default masks are equal (they overlapped at IoU 0.874-0.934 while the
    port drew from a ``torch.Generator``), and the port's is repeatable."""
    img, _ = synthetic_well(**WELLS[name])
    ref = jwell.generate_well_mask(img, mask_val=255, return_superellipse_params=True, seed=0)
    out = wellmask.generate_well_mask(img, mask_val=255, return_superellipse_params=True, seed=0)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1:], ref[1:], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[0], wellmask.generate_well_mask(img, mask_val=255, seed=0))


@pytest.mark.parametrize("seed", [0, 1, 3, 42, 12345, 2**31 - 1, -1])
def test_unit_draws_equal_jax(seed):
    out = wellmask.unit_draws(seed)
    assert out.dtype == np.float32 and out.shape == (25000, 6)
    assert np.array_equal(out, jax_draws(seed))
    assert np.array_equal(wellmask.unit_draws(seed, 100), jax_draws(seed, 100))


@pytest.mark.parametrize("n", [2, 8])
def test_default_superellipse_search_equals_jax(n):
    rng = np.random.RandomState(5)
    ang = rng.rand(40) * 2 * np.pi
    x, y = 0.7 * np.cos(ang) + 0.03, 0.66 * np.sin(ang) - 0.02
    for seed in (0, 3):
        ref = jwell.get_superellipse_hull(x, y, n, seed=seed)
        np.testing.assert_allclose(wellmask.get_superellipse_hull(x, y, n, seed=seed), ref,
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(WELLS))
def test_default_make_well_mask_equals_jax(name):
    img, _ = synthetic_well(**WELLS[name])
    ref_mask, ref_shrunken = j_make_well_mask(img, seed=0)
    mask, shrunken = wellmask.make_well_mask(img)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(shrunken, ref_shrunken)


@pytest.mark.parametrize("name", list(TIE_WELLS))
def test_default_draws_on_tie_heavy_wells(name):
    """The tie-heavy wells with the default draws: the same bound as with
    the JAX draws passed in (``test_generate_well_mask_on_tie_heavy_wells``)."""
    kw, least = TIE_WELLS[name]
    img, inside = synthetic_well(**kw)
    ref = jwell.generate_well_mask(img, mask_val=255, seed=0) > 0
    out = wellmask.generate_well_mask(img, mask_val=255, seed=0) > 0
    assert iou(out, ref) > least, iou(out, ref)
    assert iou(out, inside) > 0.7


@pytest.mark.parametrize("case", ["blank_circle", "hull", "low_coverage"])
def test_fallbacks(case, capsys, monkeypatch):
    if case == "blank_circle":
        # no border points at all: the centred circle
        img = np.zeros((100, 100), np.float32)
        ref, out = jwell.generate_well_mask(img, mask_val=7), wellmask.generate_well_mask(img, mask_val=7)
        np.testing.assert_array_equal(out, ref)
        m_ref, s_ref = j_make_well_mask(img)
        m, s = wellmask.make_well_mask(img)
        np.testing.assert_array_equal(m, m_ref)
        np.testing.assert_array_equal(s, s_ref)
        assert m.all() and "coverage is too low" in capsys.readouterr().out
    elif case == "hull":
        # no candidate encloses the hull (the port: every draw at the small
        # end of the bounds; JAX: the search made to fail), so the convex
        # hull itself is the mask
        img, _ = synthetic_well(**WELLS["squircle150"])
        zeros = np.zeros((25000, 6), np.float32)

        def no_fit(*args, **kwargs):
            raise RuntimeError("No feasible superellipse found for hull points")

        monkeypatch.setattr(jwell, "get_superellipse_hull", no_fit)
        ref = jwell.generate_well_mask(img, return_superellipse_params=True)
        out = wellmask.generate_well_mask(img, return_superellipse_params=True, draws=zeros)
        assert not isinstance(ref, tuple) and not isinstance(out, tuple)
        assert capsys.readouterr().out.count("Falling back to convex hull") == 2
        # the hull's raster shows the one-pixel moves of the Canny ties
        assert iou(out > 0, ref > 0) > 0.99
        m_ref, s_ref = j_make_well_mask(img)
        m, s = wellmask.make_well_mask(img, draws=zeros)
        assert iou(m, m_ref) > 0.99 and iou(s, s_ref) > 0.99  # s: the disk(5) erosion of the hull
        assert s.sum() < m.sum()
        np.testing.assert_array_equal(
            s, morphology.binary_erosion(torch.tensor(m), morphology.disk(5)).numpy())
    else:
        rr, cc = np.mgrid[0:200, 0:200]
        img = np.where((rr - 100) ** 2 + (cc - 100) ** 2 < 40 ** 2, 180.0, 40.0).astype(np.float32)
        m_ref, s_ref = j_make_well_mask(img)
        m, s = wellmask.make_well_mask(img, draws=jax_draws(0))
        assert m.all() and s.all() and m_ref.all() and s_ref.all()


@pytest.mark.parametrize("shape,max_dim", [((1024, 768), 512), ((300, 301), 200), ((96, 96), 512)])
def test_downsample_max_dim_shape(shape, max_dim):
    assert downsample_max_dim_shape(shape, max_dim) == tuple(j_downsample_shape(shape, max_dim))
