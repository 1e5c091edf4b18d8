"""The port's host tail (native component filter, native Morse engine)
against the JAX package's on the same inputs: equal masks and equal
(n, total, avg) branch statistics."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage

from tmat_tpu.ops.morphology import skeletonize
from tmat_tpu.tools import plate_pipeline as jpp
from tmat_tpu.topo.transforms import filter_branch_seg_mask as jax_filter
from tmat_torch.tools import plate_pipeline as tpp
from tmat_torch.topo.transforms import filter_branch_seg_mask


def _vessel_mask(seed, hw=96):
    """Branching lines, a filled disk (too circular) and specks."""
    rng = np.random.RandomState(seed)
    m = np.zeros((hw, hw), bool)
    rr, cc = np.mgrid[0:hw, 0:hw]
    for _ in range(4):
        r0, slope = rng.uniform(10, hw - 10), rng.uniform(-1, 1)
        m |= np.abs(rr - r0 - slope * (cc - hw / 2)) < rng.uniform(1, 2.5)
    m |= (rr - 20) ** 2 + (cc - 70) ** 2 < 64
    m |= rng.rand(hw, hw) > 0.995
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("remove_isolated", [True, False])
def test_filter_branch_seg_mask(seed, remove_isolated):
    mask = _vessel_mask(seed)
    skel = np.asarray(skeletonize(jnp.asarray(mask)))
    ref = jax_filter(mask.astype(np.uint8), footprint=None, remove_isolated=remove_isolated,
                     precomputed_skeleton=skel)
    out = filter_branch_seg_mask(mask.astype(np.uint8), skel, remove_isolated)
    assert out.dtype == ref.dtype == np.uint8
    assert 0 < out.sum() < mask.sum()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("config", [
    {"image_width_microns": 800.0},
    {"image_width_microns": 1200.0, "graph_thresh_1": 2, "graph_thresh_2": 8,
     "min_branch_length": 6, "remove_isolated_branches": True},
])
def test_analyze_well_graph(seed, config):
    mask = _vessel_mask(seed, hw=128)
    pred = ndimage.gaussian_filter(mask.astype(np.float32), 1.5)
    pred += 0.01 * np.random.RandomState(seed).rand(*pred.shape).astype(np.float32)
    ref = jpp._analyze_well_graph(pred, config, 128)
    out = tpp._analyze_well_graph(pred, config, 128)
    assert ref[0] > 0
    assert out == ref


def test_analyze_well_graph_constant_raster():
    assert tpp._analyze_well_graph(np.full((64, 64), 0.25, np.float32),
                                   {"image_width_microns": 800.0}, 64) == (0, 0.0, 0.0)
