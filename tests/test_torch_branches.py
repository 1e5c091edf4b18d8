"""The branches tool's modules in the port against the JAX package, on the
same seeded numpy inputs, on the CPU.

Held to: ``resize`` lanczos4/cubic atol 1e-5; the new filters and
``sato`` atol 1e-5 of the largest value; ``medial_axis`` skeleton and
EDT exact; ``label`` exact and ``region_properties`` rtol 1e-9;
``filter_branch_seg_mask`` (default disk(2) footprint) and
``remove_small_islands`` exact; ``_region_expansion`` exact, against the
JAX function and against the slice-scatter formulation; ``MorseGraph``
barcodes exact against the JAX package's and against the native engine.
"""

import os
import subprocess
from itertools import product
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from tmat_tpu.ops import filters as jfilters, morphology as jmorph, resize as jresize, sato as jsato
from tmat_tpu.ops import blur as jblur
from tmat_tpu.tools import compute_branches as jcb
from tmat_tpu.topo import dmtgraph as jdmt, labeling_native as jln, morse_native as jmn
from tmat_tpu.topo import regionprops as jrp, transforms as jtf
from tmat_tpu.topo.morse import MorseGraph as JaxMorseGraph
from tmat_torch.ops import blur, filters, morphology, sato
from tmat_torch.ops.resize import resize
from tmat_torch.tools import compute_branches as cb
from tmat_torch.topo import labeling_native, regionprops as rp, transforms as tf
from tmat_torch.topo.morse import MorseGraph
from tmat_torch.topo.morse_native import morse_barcode_native, morse_stats_native


def build_jax_engines() -> None:
    """Build the JAX package's three native engines where no library newer
    than its source is there, each into a temporary file renamed into place.

    The JAX package's own build writes the library in place, so a worker
    that loads it while another writes it falls back to NumPy for good (and
    its disk(2) filter then writes into a read-only array; ROADMAP.md Queue
    3). tests/test_labeling_native.py runs that build while it is collected,
    in every xdist worker at once, before this file is collected. No test
    runs before all workers have collected, so once this build and
    ``reset_jax_engines`` have run, the libraries that the tests load are
    whole."""
    csrc = Path(jln.__file__).resolve().parent / "csrc"
    for name in ("labeling", "dmtgraph", "morse"):
        src, lib = csrc / f"{name}.cpp", csrc / f"_{name}.so"
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-funroll-loops", "-std=c++17",
               "-shared", "-fPIC", str(src), "-o", str(tmp)]
        if subprocess.run(cmd, capture_output=True).returncode != 0:
            cmd.remove("-march=native")
            subprocess.run(cmd, capture_output=True, check=True)
        os.replace(tmp, lib)


def reset_jax_engines() -> None:
    """Forget what the JAX package's three bindings remember of earlier loads.

    Each binding caches its library, or its failure to build or load it,
    for the life of the process. A worker whose collection of
    tests/test_labeling_native.py loaded a library that another worker was
    still writing in place keeps that failure, and would fall back to NumPy
    after complete libraries are in place. Reset, the next call loads the
    library anew."""
    for module in (jln, jdmt, jmn):
        with module._LOCK:
            module._BUILD_FAILED = False
            module._LIB = None


build_jax_engines()
reset_jax_engines()


@pytest.fixture(scope="module", autouse=True)
def jax_native_engine():
    """The JAX package's labeling engine, loaded (the tests compare with it)."""
    assert jln.available(), "the JAX package's labeling engine does not load"


def test_reset_brings_back_a_failed_jax_engine(monkeypatch):
    """A cached failure (what a half-written library leaves) is forgotten."""
    monkeypatch.setattr(jln, "_BUILD_FAILED", True)
    monkeypatch.setattr(jln, "_LIB", None)
    assert not jln.available()
    reset_jax_engines()
    assert jln.available() and jln._LIB is not None


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return np.asarray(x)


@pytest.mark.parametrize("method", ["lanczos4", "cubic"])
@pytest.mark.parametrize("shape,out", [((3, 64, 80), (40, 50)), ((96, 96), (60, 60)),
                                       ((40, 44), (71, 90)), ((50, 50), (50, 31))])
def test_resize_methods(method, shape, out):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32) * 255
    ref = _j(jresize.resize(jnp.asarray(x), out, method))
    got = resize(_t(x), out, method).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * 255, rtol=0)


def test_resize_lanczos4_uint8_rounds_as_jax():
    x = np.random.RandomState(1).randint(0, 256, (64, 64)).astype(np.uint8)
    ref = _j(jresize.resize(jnp.asarray(x), (40, 40), "lanczos4"))
    got = resize(_t(x), (40, 40), "lanczos4").numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


FILTER_CASES = {
    "sobel_h": (lambda f, x: f.sobel_h(x), (2, 30, 34)),
    "sobel_v": (lambda f, x: f.sobel_v(x), (30, 34)),
    "unsharp_mask": (lambda f, x: f.unsharp_mask(x, 2.0, 1.5), (2, 40, 36)),
    "conv1d_axis0_nearest": (lambda f, x: f.conv1d_axis(x, [0.2, 0.5, 0.3], 0, "nearest"), (5, 20, 22)),
    "conv1d_axis1_reflect": (lambda f, x: f.conv1d_axis(x, [0.1, 0.2, 0.4, 0.2, 0.1], 1, "reflect"),
                             (5, 20, 22)),
    "conv1d_axis2_symmetric": (lambda f, x: f.conv1d_axis(x, [1.0, -2.0, 1.0, 0.5], 2, "symmetric"),
                               (5, 20, 22)),
    "conv1d_axis2_constant": (lambda f, x: f.conv1d_axis(x, [0.25, 0.5, 0.25], 2, "constant"),
                              (5, 20, 22)),
    "gaussian_nd": (lambda f, x: f.gaussian_nd(x, 1.5), (6, 32, 30)),
    "gaussian_nd_2d": (lambda f, x: f.gaussian_nd(x, 2.0, mode="reflect"), (32, 30)),
    "unsharp_mask_nd": (lambda f, x: f.unsharp_mask_nd(x, 2.0, 2.0), (7, 48, 40)),
    "median3x3": (lambda f, x: f.median3x3(x), (3, 25, 27)),
}


@pytest.mark.parametrize("name", sorted(FILTER_CASES))
def test_filters_match_jax(name):
    fn, shape = FILTER_CASES[name]
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    ref = _j(fn(jfilters, jnp.asarray(x)))
    got = fn(filters, _t(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1e-6), rtol=0)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("sigma", [1.0, 2.0, 7.0, 15.0])
def test_gaussian_deriv_kernel_equal(order, sigma):
    np.testing.assert_array_equal(sato.gaussian_deriv_kernel(sigma, order),
                                  jsato.gaussian_deriv_kernel(sigma, order))


# the shapes and scales of tests/test_sato.py, and the tool's ten scales
SATO_CASES = [
    ("ridge", (64, 64), (1, 2, 3), False),
    ("black_ridges", (64, 64), (1, 2), True),
    ("narrow", (96, 96), (1,), False),
    ("wide", (96, 96), (8,), False),
    ("batched", (3, 48, 48), (1, 3), False),
    ("default_sigmas", (2, 70, 64), sato.DEFAULT_SIGMAS, False),
]


@pytest.mark.parametrize("case", SATO_CASES, ids=lambda c: c[0])
def test_sato_matches_jax(case):
    _, shape, sigmas, black = case
    rng = np.random.RandomState(3)
    x = rng.rand(*shape).astype(np.float32) * 0.1
    x[..., shape[-2] // 2, :] += 1.0
    x[..., :, shape[-1] // 3] += 0.7
    ref = _j(jsato.sato(jnp.asarray(x), sigmas=tuple(sigmas), black_ridges=black))
    got = sato.sato(_t(x), sigmas=tuple(sigmas), black_ridges=black).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def _masks(seed, shape=(3, 48, 52)):
    rng = np.random.RandomState(seed)
    return ndimage.uniform_filter(rng.rand(*shape), size=(1, 5, 5)) > 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_medial_axis_exact(seed):
    masks = _masks(seed)
    skel, dist = morphology.medial_axis(_t(masks), return_distance=True)
    for m, s, d in zip(masks, skel.numpy(), dist.numpy()):
        js, jd = jmorph.medial_axis(jnp.asarray(m), return_distance=True)
        np.testing.assert_array_equal(s, _j(js))
        np.testing.assert_array_equal(d, _j(jd))
        assert s.any()
    np.testing.assert_array_equal(morphology.medial_axis(_t(masks[0])).numpy(),
                                  _j(jmorph.medial_axis(jnp.asarray(masks[0]))))


def test_euclidean_distance_transform_and_circle():
    m = _masks(2)[0]
    got = morphology.euclidean_distance_transform(m)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jmorph.euclidean_distance_transform(m))
    for args in [((10, 12), 7.5, (30, 25)), ((0, 0), 3, (8, 9)), ((20, 5), 11, (24, 40), 255)]:
        np.testing.assert_array_equal(morphology.gen_circ_mask(*args), jmorph.gen_circ_mask(*args))


@pytest.mark.parametrize("which", ["blur", "dt_blur", "sdt_blur"])
def test_blur_helpers(which):
    rng = np.random.RandomState(4)
    img = (ndimage.uniform_filter(rng.rand(40, 36), 5) > 0.5).astype(np.uint8) * 200
    if which == "blur":
        x = rng.rand(40, 36).astype(np.float32) * 200
        got = blur.blur(_t(x), 3).numpy()
        ref = _j(jblur.blur(jnp.asarray(x), 3))
        assert got.dtype == ref.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        assert (got == ref).mean() > 0.99
        return
    got = getattr(blur, which)(img, 2)
    ref = getattr(jblur, which)(img, 2)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), atol=1, rtol=0)
    assert (got == ref).mean() > 0.99


def _label_masks():
    rng = np.random.RandomState(5)
    m = ndimage.uniform_filter(rng.rand(60, 70), 4) > 0.55
    line = np.zeros((40, 40), bool)
    line[10, 2:38] = True
    line[5:35, 20] = True
    line[30:33, 5:8] = True
    return [m, line, rng.rand(33, 31) > 0.8, np.zeros((9, 9), bool)]


@pytest.mark.parametrize("connectivity", [1, 2])
def test_label_exact(connectivity):
    for m in _label_masks():
        labels, n = rp.label(m, connectivity)
        jl, jn = jrp.label(m, connectivity)
        assert n == jn
        np.testing.assert_array_equal(labels, jl)
        ref, rn = ndimage.label(m, ndimage.generate_binary_structure(2, connectivity))
        assert rn == n
        np.testing.assert_array_equal(labels, ref)


def test_region_properties_match_jax():
    props = ("area", "perimeter", "eccentricity", "equivalent_diameter_area")
    for m in _label_masks()[:3]:
        labels, n = rp.label(m)
        got = rp.region_properties(labels, n, props)
        ref = jrp.region_properties(labels, n, props)
        for key in props:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=0)
        # the perimeter of each region alone (NumPy), as the engine counts it
        for i in range(min(n, 12)):
            assert rp.perimeter(labels == i + 1) == pytest.approx(got["perimeter"][i], rel=1e-9)
            assert rp.perimeter(labels == i + 1) == jrp.perimeter(labels == i + 1)
        subset = rp.region_properties(labels, n, ("eccentricity",))
        assert list(subset) == ["eccentricity"]
    assert rp.eccentricity_from_moments(4.0, 1.0, 0.5) == jrp.eccentricity_from_moments(4.0, 1.0, 0.5)


def test_regionprops_image_and_remove_small_objects():
    m = _label_masks()[0]
    for prop in ("area", "eccentricity"):
        np.testing.assert_allclose(rp.regionprops_image(m, prop), jrp.regionprops_image(m, prop),
                                   rtol=1e-9, atol=0)
    labels, _ = rp.label(m)
    for size in (1, 5, 30):
        np.testing.assert_array_equal(rp.remove_small_objects(labels, size),
                                      jrp.remove_small_objects(labels, size))
    with pytest.raises(TypeError):
        rp.remove_small_objects(labels.astype(float), 5)


def test_remove_small_islands_match_jax():
    mask = np.ones((32, 32), np.uint8)
    mask[10, 10] = 0
    mask[:5, :] = 0
    mask[0, 0] = 1
    rng = np.random.RandomState(6)
    noisy = (ndimage.uniform_filter(rng.rand(50, 50), 3) > 0.5).astype(np.uint8)
    for m, kw in [(mask, dict(min_area0=4, min_area1=4)), (noisy, {}),
                  (noisy, dict(min_area0=3, min_area1=20, connectivity0=2, connectivity1=2))]:
        np.testing.assert_array_equal(tf.remove_small_islands(m, **kw), jtf.remove_small_islands(m, **kw))
    with pytest.raises(ValueError):
        tf.remove_small_islands(mask * 2)


def _topo_masks():
    """The masks of tests/test_topo.py's filter tests, and noisy vessel masks."""
    blob = np.zeros((64, 64), np.uint8)
    rr, cc = np.mgrid[0:64, 0:64]
    blob[(rr - 16) ** 2 + (cc - 48) ** 2 <= 36] = 1
    blob[40:43, 4:60] = 1
    blob[10:41, 20:23] = 1
    bar = np.zeros((32, 32), np.uint8)
    bar[16:19, 4:28] = 1
    out = [blob, bar]
    rows, cols = np.mgrid[0:80, 0:90]
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        m = np.zeros((80, 90), bool)
        for _ in range(4):
            r0, slope = rng.uniform(10, 70), rng.uniform(-1, 1)
            m |= np.abs(rows - r0 - slope * (cols - 45)) < 1.8
        m |= rng.rand(80, 90) > 0.97
        out.append(m.astype(np.uint8))
    return out


@pytest.mark.parametrize("remove_isolated", [True, False])
def test_filter_branch_seg_mask_default_footprint(remove_isolated):
    for i, m in enumerate(_topo_masks()):
        ref = jtf.filter_branch_seg_mask(m.copy(), remove_isolated=remove_isolated)
        got = tf.filter_branch_seg_mask(m.copy(), remove_isolated=remove_isolated)
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        if i == 0:  # the circular blob goes, the forked structure stays
            assert got[16, 48] == 0 and got[41, 30] == 1
    bar = _topo_masks()[1]
    assert tf.filter_branch_seg_mask(bar, None, remove_isolated=False).sum() > 0
    assert tf.filter_branch_seg_mask(bar, None, remove_isolated=True).sum() == 0
    np.testing.assert_array_equal(tf.filter_branch_seg_mask(bar, None, True),
                                  jtf.filter_branch_seg_mask(bar, None, True))


def test_filter_branch_seg_mask_guards_and_footprints():
    m = _topo_masks()[2]
    with pytest.raises(ValueError, match="footprint=None"):
        tf.filter_branch_seg_mask(m, precomputed_skeleton=m)
    for fp in (jmorph.disk(1), jmorph.square(3), jmorph.square(2)):
        np.testing.assert_array_equal(tf.filter_branch_seg_mask(m, fp), jtf.filter_branch_seg_mask(m, fp))
    img = np.random.RandomState(7).rand(24, 24).astype(np.float32)
    for fp in (jmorph.disk(2), jmorph.square(2)):
        np.testing.assert_array_equal(tf.median_filter_footprint(_t(img), fp).numpy(),
                                      jtf.median_filter_footprint(img, fp))


def _scatter_reference(mask, vessels, iters=10):
    """The slice-scatter formulation of the region expansion."""
    sl = {-1: slice(1, None), 0: slice(None, None), 1: slice(None, -1)}
    mask = mask.astype(bool)
    for _ in range(iters):
        lo = np.zeros_like(mask)
        hi = np.zeros_like(mask)
        for r, c in (p for p in product((-1, 0, 1), repeat=2) if p != (0, 0)):
            src, dst = (sl[r], sl[c]), (sl[-r], sl[-c])
            lt = vessels[dst] < vessels[src]
            lo[dst] = np.where(mask[src] & lt, True, lo[dst])
            hi[dst] = np.where(mask[src] & ~lt, True, hi[dst])
        mask = mask | ((vessels > 0.01) & hi & ~lo)
    return mask


@pytest.mark.parametrize("trial", range(3))
def test_region_expansion_exact(trial):
    rng = np.random.RandomState(10 + trial)
    vessels = rng.rand(40, 44).astype(np.float32)
    vessels[rng.rand(40, 44) > 0.9] = 0.005
    vessels[5:9, 5:9] = 0.5  # ties
    seed = rng.rand(40, 44) > 0.9
    got = cb._region_expansion(_t(seed), _t(vessels), iters=10).numpy()
    np.testing.assert_array_equal(got, _j(jcb._region_expansion(jnp.asarray(seed), jnp.asarray(vessels),
                                                                iters=10)))
    np.testing.assert_array_equal(got, _scatter_reference(seed, vessels))
    assert got.sum() > seed.sum()


def _vessel_image(h=96, w=96, seed=0):
    """A Y-shaped bright structure and a ring on a noisy background."""
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w).astype(np.float32) * 5
    img[h // 2, 4:-4] += 200
    img[10 : h // 2, 20] += 180
    img[h // 2 : h - 10, 60] += 160
    rr, cc = np.mgrid[0:h, 0:w]
    img[np.abs(np.hypot(rr - 30, cc - 70) - 15) < 1] += 120
    return ndimage.gaussian_filter(img, 1.2)


MORSE_KWARGS = [
    dict(thresholds=(5, 10), smoothing_window=5, min_branch_length=5),
    dict(thresholds=(2, 8), smoothing_window=3, min_branch_length=3, max_branch_length=40,
         remove_isolated_branches=True),
    dict(thresholds=(1, 4), smoothing_window=8, min_branch_length=6, pruning_mask="edge"),
]


@pytest.mark.parametrize("k", range(len(MORSE_KWARGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_morse_graph_matches_jax_and_native(k, seed):
    img = _vessel_image(seed=seed)
    kwargs = dict(MORSE_KWARGS[k])
    if kwargs.get("pruning_mask") == "edge":
        pm = np.zeros(img.shape, bool)
        pm[:, :8] = True
        kwargs["pruning_mask"] = pm
    g = MorseGraph(img, **kwargs)
    jg = JaxMorseGraph(img, **kwargs)
    assert g.barcode == jg.barcode and len(g.barcode) >= 1
    assert g.get_total_branch_length() == jg.get_total_branch_length()
    assert g.get_average_branch_length() == jg.get_average_branch_length()
    assert list(g._G.nodes) == list(jg._G.nodes)
    np.testing.assert_array_equal(np.asarray(g.barcode, float).reshape(-1, 2),
                                  morse_barcode_native(img, **kwargs))
    assert morse_stats_native(img, **kwargs) == (
        len(g.barcode), g.get_total_branch_length(), g.get_average_branch_length())


def test_morse_graph_empty_and_plots(tmp_path):
    flat = MorseGraph(np.zeros((32, 32), np.float32))
    assert flat.barcode == [] and flat.get_total_branch_length() == 0.0
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = MorseGraph(_vessel_image(), thresholds=(5, 10), smoothing_window=5, min_branch_length=5)
    jg = JaxMorseGraph(_vessel_image(), thresholds=(5, 10), smoothing_window=5, min_branch_length=5)
    for obj in (g, jg):
        obj.plot_colored_barcode(scaling_factor=2.0, ax=plt.figure().gca())
        obj.plot_colored_tree(scaling_factor=2.0, ax=plt.figure().gca())
    plt.close("all")
    assert g._barcode_and_colors == jg._barcode_and_colors
    assert len(g._edges_and_colors) == len(jg._edges_and_colors)
    for (e, c), (je, jc) in zip(g._edges_and_colors, jg._edges_and_colors):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(je))
        assert c == jc


def test_ecc_diameter_filter_and_sweep_tags():
    skel = np.zeros((40, 40), np.uint8)
    skel[5, 5:30] = 1  # a line: kept
    skel[20:22, 20:22] = 1  # a square: dropped
    skel[30, 30] = 1  # a dot: dropped
    got = cb._ecc_diameter_filter(skel)
    np.testing.assert_array_equal(got, jcb._ecc_diameter_filter(skel))
    assert got[5, 10] == 1 and got[20, 20] == 0 and got[30, 30] == 0
    np.testing.assert_array_equal(cb._ecc_diameter_filter(np.zeros((8, 8), np.uint8)), 0)
    assert cb.sweep_configs(5, 10) == [("", {"thresh1": 5, "thresh2": 10})]
    assert [t for t, _ in cb.sweep_configs([2.0, 8.0], [5.0])] == ["_CONFIG_thresh1_2.0",
                                                                    "_CONFIG_thresh1_8.0"]
    assert [t for t, _ in cb.sweep_configs([2, 10], [5, 15])] == [
        "_CONFIG_thresh1_02_thresh2_05", "_CONFIG_thresh1_02_thresh2_15",
        "_CONFIG_thresh1_10_thresh2_05", "_CONFIG_thresh1_10_thresh2_15"]
    assert [t for t, _ in cb.sweep_configs([0.5, 12.25], 3)] == ["_CONFIG_thresh1_00.50",
                                                                 "_CONFIG_thresh1_12.25"]


def test_labeling_native_refuses_bad_inputs():
    with pytest.raises(ValueError):
        labeling_native.label_native(np.zeros((2, 3, 4)), 2)
    with pytest.raises(ValueError):
        labeling_native.label_native(np.zeros((4, 4)), 3)
    labels, n = labeling_native.label_native(np.ones((5, 6)), 1)
    assert n == 1 and labels.dtype == np.int32
