"""The plain reference against the program at small sizes on the CPU (both
in float32), and the reference's independence: it imports nothing of the
program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import resnet as ref_resnet
from perfbench.reference import segment, segment_fs_well, topology
from perfbench.reference.flax_msgpack import read_flax

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("path", sorted((REPO / "perfbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"tmat_torch", "tmat_tpu", "jax", "jaxlib", "flax", "optax"}, names


def test_flax_reader_matches_the_programs():
    from tmat_torch.models.params_io import load_variables

    ckpt = REPO / "model_training" / "binary_segmentation" / "checkpoints" / "checkpoint_1.msgpack"
    a, b = read_flax(ckpt), load_variables(ckpt)
    flat_a = {k: v for k, v in _flat(a)}
    flat_b = {k: v for k, v in _flat(b)}
    assert flat_a.keys() == flat_b.keys()
    assert all(np.array_equal(flat_a[k], flat_b[k]) for k in flat_a)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_unet_matches_the_programs(tmp_path):
    from tmat_torch.models.layers import flax_variables
    from tmat_torch.models.params_io import from_flax_variables, save_params
    from tmat_torch.models.unet import UNetXception, build_unet_xception

    m = build_unet_xception(1, (32, 32), 1, (8, 16, 32, 64), seed=5, device="cpu")
    # BatchNorm statistics away from 0 / 1, so that the folding is held too
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith(".mean"):
                t.copy_(torch.randn_like(t) * 0.1)
            elif name.endswith(".var"):
                t.copy_(torch.rand_like(t) + 0.5)
    save_params(tmp_path / "u.msgpack", flax_variables(m))
    tree = read_flax(tmp_path / "u.msgpack")
    prog = UNetXception(from_flax_variables(tree, (8, 16, 32, 64)), torch.float32).eval()
    ref = segment.UNetRef(tree, (8, 16, 32, 64)).to_device("cpu")
    x = torch.rand(3, 32, 32, 1)
    assert (prog(x) - ref.predict(x)).abs().max().item() < 1e-5


def test_resize_and_stretch_match_the_programs():
    from tmat_torch.ops.rescale import rescale_intensity
    from tmat_torch.ops.resize import resize

    img = torch.rand(100, 100, dtype=torch.float64) * 255
    for shape, kind, method in (((64, 64), "lanczos3", "lanczos"), ((40, 40), "linear", "linear")):
        a = segment.resize2d(img, shape, kind)
        b = resize(img.float(), shape, method).double()
        assert (a - b).abs().max().item() < 1e-3
    assert (segment.stretch(img) - rescale_intensity(img.float()).double()).abs().max().item() < 1e-6


def test_gmm_area_matches_the_programs():
    from tmat_torch.parallel.plate import plate_threshold

    rng = np.random.RandomState(3)
    proj = np.clip(rng.normal(40, 8, (128, 128)), 0, 255)
    proj[30:60, 10:120] = np.clip(rng.normal(170, 15, (30, 110)), 0, 255)
    proj = np.round(proj)
    lo, hi = segment.area_band(torch.from_numpy(proj))
    area = 100 * float(plate_threshold(torch.from_numpy(proj[None]).float(), 0.0, device="cpu").float().mean())
    assert lo - 1e-9 <= area <= hi + 1e-9


def test_tiling_and_blend_match_the_programs():
    """The reference's patches are the program's, and its float64 blend of
    given patch outputs agrees with the program's float32 one."""
    from tmat_torch.ops.tiled import tile_patches, tiled_core

    img = torch.rand(40, 40)
    a = segment.tile(img, 32, 8)
    b = tile_patches(img[..., None], 32, 2, 8)
    assert torch.equal(a, b)
    outs = torch.rand(a.shape[0], 32, 32, 1)
    blended = tiled_core(img, lambda batch: outs, 32, 2, 1, 8)
    assert (segment.blend(outs, 40, 40, 32, 8) - blended.double()).abs().max().item() < 1e-5


def test_one_ensemble_member_matches_the_programs(tmp_path):
    from tmat_torch.models.layers import flax_variables
    from tmat_torch.models.params_io import save_params
    from tmat_torch.models.preprocess import host_resize, prep_tail
    from tmat_torch.models.resnet import build_trainable_resnet50_tl
    from tmat_torch.tools.compute_inv_depth import load_ensemble

    m = build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=2, device="cpu")
    v = flax_variables(m)
    v["params"]["head"]["kernel"] = (np.random.RandomState(0).randn(256, 1) * 0.01).astype(np.float32)
    save_params(tmp_path / "m.msgpack", v)
    member = load_ensemble([tmp_path / "m.msgpack"], (32, 32, 3), "conv2_block3_out", torch.float32, "cpu")[0]
    ref = ref_resnet.ResNetRef(read_flax(tmp_path / "m.msgpack"), "conv2_block3_out", "cpu")
    stack = np.random.RandomState(1).randint(0, 256, (3, 64, 64)).astype(np.uint8)
    x_prog = prep_tail(torch.from_numpy(host_resize(stack, (32, 32))))
    x_ref = ref_resnet.prep(stack, (32, 32), "cpu")
    assert (x_prog - x_ref).abs().max().item() <= 1.0 + 1e-3  # a rounding of the resize to uint8
    with torch.no_grad():
        p_prog = member(x_ref)[:, 0]
    assert (p_prog - ref(x_ref)).abs().max().item() < 1e-5


def _vessel_map(seed: int, size: int) -> np.ndarray:
    """A probability map of a vessel network and a few round blobs, with
    noise, (size, size) float64."""
    from scipy import ndimage

    from perfbench.inputs import vessels

    rng = vessels.seeded(seed, 9)
    mask = vessels.vessel_mask(rng, size, 12)
    yy, xx = np.mgrid[:size, :size]
    for cy, cx in rng.randint(10, size - 10, (4, 2)):
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= 16
    mask = mask.astype(np.float64)
    logit = ndimage.gaussian_filter(mask, 1.5) * 8 - 3 + rng.randn(size, size) * 0.8
    return 1 / (1 + np.exp(-logit))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_host_tail_matches_the_programs(seed):
    """The reference's component filter and Morse branches, written anew in
    float64, against the program's C++ engines on the same input: the
    filter exactly, the branch count exactly, the lengths to rounding."""
    from scipy import ndimage

    from tmat_torch.topo.labeling_native import branch_filter_native
    from tmat_torch.topo.morse_native import morse_stats_native

    preds = _vessel_map(seed, 320)
    seg = (preds > 0.5).astype(np.uint8)
    filtered = ndimage.median_filter(seg, footprint=segment._disk2(), mode="nearest") > 0
    skel = segment.zhang_suen(torch.from_numpy(filtered)).numpy()
    kept = topology.component_filter(filtered, skel)
    assert np.array_equal(kept, branch_filter_native(filtered.astype(np.uint8), skel.astype(np.uint8), True) > 0)
    assert 0 < kept.sum() < filtered.sum()  # some components go, some stay
    dist = ndimage.distance_transform_edt(kept)
    cdt = ndimage.distance_transform_edt(~(skel & kept))
    weighted = preds * np.where(dist > 0, dist / np.maximum(dist + cdt, 1e-12), 0.0)
    img = ((weighted - weighted.min()) * (255 / np.ptp(weighted))).astype(np.float32)
    n, total, avg = topology.branch_stats(img.astype(np.float64), (5, 10), 4, 4)
    n_prog, total_prog, avg_prog = morse_stats_native(img, thresholds=(5, 10), smoothing_window=4,
                                                      min_branch_length=4)
    assert n == n_prog > 10
    assert abs(total - total_prog) <= 1e-6 * total_prog
    assert abs(avg - avg_prog) <= 1e-6 * avg_prog


def test_component_filter_drops_round_and_forkless_components():
    mask = np.zeros((40, 40), bool)
    yy, xx = np.mgrid[:40, :40]
    mask |= (yy - 10) ** 2 + (xx - 10) ** 2 <= 25  # a disc: round
    mask[30, 5:35] = True  # a bar: no fork
    mask[20:23, 20:38] = True  # a fork: a bar with a branch
    mask[10:20, 29:31] = True
    skel = segment.zhang_suen(torch.from_numpy(mask)).numpy()
    kept = topology.component_filter(mask, skel)
    assert not kept[10, 10] and not kept[30, 20] and kept[21, 25]
    assert topology.component_filter(mask, skel, remove_isolated=False)[30, 20]


def test_unit_draws_match_the_programs():
    """The well search's draws, JAX's uniform written in numpy, bit for bit."""
    from tmat_torch.ops.wellmask import unit_draws

    for seed in (0, 7, 2**33 + 5):
        assert np.array_equal(segment_fs_well.unit_draws(seed, (300, 6)), unit_draws(seed, 300))


def _fs_well(seed: int, size: int, k: int = 0):
    """A disc well of the plate_fs_well recipe at ``size`` px, 4 slices,
    under dihedral transform ``k``."""
    import json

    from perfbench.harness import load_module
    from perfbench.inputs.vessels import seeded

    traffic = json.loads((REPO / "perfbench" / "traffic" / "plate_fs_well.json").read_text())
    traffic.update(size=size, z=4)
    traffic["well"].update(rim_sigma=size / 170, sharp_below=3)
    gen = load_module(REPO / "perfbench" / "traffic" / "plate_fs_well.py")
    return gen.d4(torch.from_numpy(gen.fs_well(seeded(seed, 1), traffic, 8)), k)


@pytest.mark.parametrize("seed", [1, 2])
def test_focus_projection_matches_the_programs(seed):
    """Over each well's own depth, the padding left out: the same source
    pixel wherever the program's float32 scores are not a near-tie."""
    from tmat_torch.ops.focus_stack import focus_stack_plain

    well = _fs_well(seed, 128)
    for depth in (4, 3):
        prog = focus_stack_plain(well[None], [depth])[0].double()
        ref = segment_fs_well.focus_project(well[:depth].numpy())
        assert (prog != ref).sum().item() <= 2
    # the padding counts once the depth is ignored: the projections differ
    noisy = well.clone()
    noisy[3] = torch.randint(0, 256, noisy[3].shape, generator=torch.Generator().manual_seed(seed),
                             dtype=torch.uint8)
    assert (segment_fs_well.focus_project(noisy.numpy()) != segment_fs_well.focus_project(well[:3].numpy())
            ).float().mean() > 0.3


@pytest.mark.parametrize("seed,k", [(1, 0), (2, 3), (3, 5)])
def test_well_fit_allows_the_programs_mask(seed, k):
    """The program's well mask and shrunken mask are one of the masks that
    the reference's fit allows (exact ties of its edges resolved either
    way), and the fit is held to the image: a moved well is another mask."""
    from tmat_torch.ops.resize import resize
    from tmat_torch.ops.wellmask import make_well_mask

    well = _fs_well(seed, 400, k)
    img = resize(well.max(dim=0).values.float(), (256, 256), "lanczos").numpy()
    fit = segment_fs_well.fit_well(img.astype(np.float64), seed=0)
    assert fit.exponents and fit.candidates
    prog = make_well_mask(img, seed=0)
    assert 0.4 < prog[0].mean() < 1  # the mask is used, not dropped
    assert segment_fs_well.mask_gap(fit, prog)[0] == 0
    moved = make_well_mask(np.roll(img, 12, axis=1), seed=0)
    assert segment_fs_well.mask_gap(fit, moved)[0] > 0.005


@pytest.mark.parametrize("ratio,allowed", [(0.020, {2}), (0.0262, {2, 8}), (0.0280, {2, 8}),
                                           (0.0300, {8})])
def test_exponents_near_the_cut_admit_both(ratio, allowed):
    """The hull's perimeter over its area decides the exponent only away
    from the cut; within EXP_TOL of it, both are allowed."""
    assert segment_fs_well.exponents(ratio) == allowed


def test_proj_gap_is_the_share_of_pixels_that_differ():
    """The nearest of the program's projections is judged pixel by pixel;
    a well with none reads 1."""
    ref = torch.arange(64, dtype=torch.float64).reshape(8, 8)
    off = ref.float().clone()
    off[0, :4] += 1
    other = torch.zeros(8, 8)
    assert segment_fs_well.proj_gap(ref, [other, ref.float()]) == 0
    assert segment_fs_well.proj_gap(ref, [other, off]) == 4 / 64
    assert segment_fs_well.proj_gap(ref, []) == 1


@pytest.mark.parametrize("seed", [1, 2])
def test_pruned_tail_matches_the_programs(seed):
    """The reference's Morse branches with a pruning mask against the
    program's C++ engine: the count exactly, the lengths to rounding."""
    from tmat_torch.topo.morse_native import morse_stats_native

    preds = _vessel_map(seed, 320)
    img = ((preds - preds.min()) * (255 / np.ptp(preds))).astype(np.float32)
    yy, xx = np.mgrid[:320, :320]
    pruning = (yy - 150) ** 2 + (xx - 175) ** 2 > 120**2
    for mask in (pruning, pruning.T.copy()):
        n, total, _ = topology.branch_stats(img.astype(np.float64), (5, 10), 4, 4, mask)
        n_prog, total_prog, _ = morse_stats_native(img, thresholds=(5, 10), smoothing_window=4,
                                                   min_branch_length=4, pruning_mask=mask)
        assert n == n_prog > 10
        assert abs(total - total_prog) <= 1e-6 * total_prog
