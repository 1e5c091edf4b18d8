"""The port's plate pipeline against the JAX package's, end to end.

A tiny segmentor (filters 8-16, patch 32, ds_ratio 0.625) from numpy-seeded
variables is saved with ``tmat_tpu``'s ``save_params`` and loaded by both
packages. A 3-well, 96x96, ragged-Z plate (Z = 3/2/3) made with the
``bench.py::_synthetic_plate`` recipe goes through both ``run_plate``s and
through the port's CLI, with the host projections (max, avg) and with
focus stacking (``fs``: the Z-padded stacks go to the device with their
depths). Tolerances: area within one pixel, stage-1 predictions within
1e-4, filtered masks equal, branch counts equal and lengths within 1e-6
relative.

The plate building blocks (``plate_zproj``, ``plate_threshold``,
``plate_segment``) are held against the JAX package's on a one-device
mesh, the last with an identity model and with a UNet of filters 8-16-32.

With ``detect_well`` a second plate, whose wells are bright discs on a
dark frame, goes through both, with the port's own unit draws (JAX's) and
with the JAX package's passed in (``unit_draws`` patched); the well masks
and all that follows are held to the same tolerances.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tmat_tpu.models.params_io import save_params
from tmat_tpu.models.unet import UNetXceptionPatchSegmentor as JaxSegmentor, build_unet_xception
from tmat_tpu.parallel import plate as jplate
from tmat_tpu.parallel.mesh import make_mesh
from tmat_tpu.parallel.plate import plate_stage1 as jax_stage1
from tmat_tpu.tools import plate_pipeline as jpp
from tmat_tpu.topo.transforms import filter_branch_seg_mask as jax_filter
from tmat_torch.models.unet import UNetXceptionPatchSegmentor
from tmat_torch.ops import wellmask
from tmat_torch.ops.zproj import proj_host
from tmat_torch.ops.threshold import exec_threshold
from tmat_torch.parallel import plate as tplate
from tmat_torch.parallel.plate import plate_stage1
from tmat_torch.tools import plate_pipeline as tpp
from tmat_torch.topo.transforms import filter_branch_seg_mask

HW, Z_COUNTS, PATCH, FILTERS, DS = 96, (3, 2, 3), 32, (8, 16), 0.625
CONFIG = {"image_width_microns": 800.0}
SD_COEF = -1.0
AREA_TOL = 100.0 / (HW * HW)


def _synthetic_plate(n_wells, n_z, hw, rng):
    """bench.py's vessel-like plate recipe at a small size (uint8)."""
    rr, cc = np.mgrid[0:hw, 0:hw]
    plate = rng.rand(n_wells, n_z, hw, hw).astype(np.float32) * 10
    for i in range(n_wells):
        ring = np.abs(np.sqrt((rr - hw / 2) ** 2 + (cc - hw / 2) ** 2) - (hw / 3 + 10 * i)) < 4
        plate[i, n_z // 2][ring] += 180
        plate[i, n_z // 2, hw // 2 - 2 : hw // 2 + 2, 10:-10] += 150
    return np.clip(plate, 0, 255).astype(np.uint8)


def _well_plate(plate):
    """The plate with each well a bright disc on a dark frame."""
    hw = plate.shape[-1]
    rr, cc = np.mgrid[0:hw, 0:hw]
    out = plate.astype(np.float32)
    for i in range(len(out)):
        inside = (rr - hw / 2 - i) ** 2 + (cc - hw / 2 + i) ** 2 <= (0.48 * hw) ** 2
        out[i] = np.where(inside, out[i] * 0.5 + 110, out[i] * 0.2)
    return np.clip(out, 0, 255).astype(np.uint8)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's default unit draws replaced by the JAX package's."""
    monkeypatch.setattr(
        wellmask, "unit_draws",
        lambda seed, num_iters=25000: np.asarray(
            jax.random.uniform(jax.random.PRNGKey(seed), (num_iters, 6), jnp.float32)))


def _variables(seed=25, filters=FILTERS):
    """Numpy-seeded Flax variables; the head is scaled up so predictions
    saturate away from 0.5 and the thresholded masks are well defined."""
    _, shapes = build_unet_xception(1, (PATCH, PATCH), channels=1, filter_counts=filters, init="zeros")
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
            if path[-2].key == f"Conv_{2 * len(filters)}":  # the head
                v *= 40
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = 0.1 * rng.randn(*a.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("plate")
    ckpt = root / "ckpt.msgpack"
    save_params(ckpt, _variables())
    plate = _synthetic_plate(len(Z_COUNTS), max(Z_COUNTS), HW, np.random.RandomState(0))
    for i, z in enumerate(Z_COUNTS):
        plate[i, z:] = 0
    jax_seg = JaxSegmentor(PATCH, ckpt, FILTERS, ds_ratio=DS, dtype=jnp.float32)
    seg = UNetXceptionPatchSegmentor(PATCH, ckpt, FILTERS, ds_ratio=DS, dtype=torch.float32, device="cpu")
    return {"root": root, "ckpt": ckpt, "plate": plate, "well_plate": _well_plate(plate),
            "jax_seg": jax_seg, "seg": seg}


@pytest.mark.parametrize("method", ["max", "avg", "fs"])
def test_stage1_matches_jax(setup, method):
    """Areas, predictions and the host-filtered masks of stage 1; ``fs``
    projects the ragged stacks on the device, the others arrive projected."""
    plate, target = setup["plate"], (60, 60)
    pre = method != "fs"
    wells = np.stack([proj_host(s[:z], method) for s, z in zip(plate, Z_COUNTS)]) if pre else plate
    n_dev = len(jax.devices())
    padded = np.zeros((n_dev, *wells.shape[1:]), wells.dtype)
    padded[: len(wells)] = wells
    zcs = np.ones(n_dev, np.int32)
    zcs[: len(wells)] = Z_COUNTS
    j_area, j_pred, j_f, j_s = (np.asarray(a) for a in jax_stage1(
        make_mesh(axis_names=("data",)), jnp.asarray(padded), setup["jax_seg"]._pred_fn, PATCH, 2,
        target, SD_COEF, proj_method=method, z_counts=zcs, pre_projected=pre))
    area, pred, f_pk, s_pk = (a.numpy() for a in plate_stage1(
        torch.tensor(wells), setup["seg"]._pred_fn, PATCH, 2, target, SD_COEF,
        proj_method=method, z_counts=list(Z_COUNTS), pre_projected=pre))
    n = len(wells)
    j_pred = j_pred[:n]
    np.testing.assert_allclose(pred, j_pred, atol=1e-4, rtol=0)
    # fs: one prediction lies 8e-5 from 0.5, so hold the distance to ten times the two's difference
    margin = 1e-4 if pre else 10 * np.abs(pred - j_pred).max()
    assert np.abs(j_pred - 0.5).min() > margin, "a prediction near 0.5 makes mask equality vacuous"
    np.testing.assert_allclose(area * 100, j_area[:n] * 100, atol=AREA_TOL, rtol=0)
    np.testing.assert_array_equal(f_pk, j_f[:n])
    np.testing.assert_array_equal(s_pk, j_s[:n])
    w = target[1]
    for j in range(n):
        f = np.unpackbits(f_pk[j], axis=-1)[..., :w].astype(np.uint8)
        s = np.unpackbits(s_pk[j], axis=-1)[..., :w].astype(bool)
        assert 0 < f.sum() < f.size
        np.testing.assert_array_equal(filter_branch_seg_mask(f, footprint=None, precomputed_skeleton=s),
                                      jax_filter(f, footprint=None, precomputed_skeleton=s))


ONE_DEVICE = make_mesh((1,), ("data",))


@pytest.mark.parametrize("method", ["max", "min", "avg", "med", "fs"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_plate_zproj_matches_jax(setup, method, dtype):
    """The five projections of a (B, Z, H, W) plate at full depth, in JAX's
    dtypes: integer stacks exact; float32 ones exact but for ``avg``, whose
    float32 sums run in another order (1e-6 relative). Each equals
    ``plate_zproj_masked`` at full depth, in float32."""
    stacks = setup["plate"].astype(dtype)
    if dtype == "float32":
        stacks = stacks + np.random.RandomState(3).rand(*stacks.shape).astype(np.float32)
    ref = np.asarray(jplate.plate_zproj(ONE_DEVICE, jnp.asarray(stacks), method))
    out = tplate.plate_zproj(torch.from_numpy(stacks), method, device="cpu").numpy()
    assert out.dtype == ref.dtype and out.shape == (len(stacks), HW, HW)
    if dtype == "float32" and method == "avg":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(out, ref)
    masked = tplate.plate_zproj_masked(torch.from_numpy(stacks), None, method).numpy()
    np.testing.assert_allclose(out.astype(np.float32), masked, rtol=1e-6 if method == "avg" else 0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sd_coef", [SD_COEF, 0.0])
def test_plate_threshold_matches_jax(setup, masked, sd_coef):
    """Rescale, mask, GMM threshold and binarise: uint8 equal to JAX's,
    without masks (JAX passes ones) and with them. Without masks the GMM's
    weights are ones either way, so ``exec_threshold`` with ``None``, as
    ``plate_stage1`` passed it before, gives the same bits."""
    imgs = np.stack([proj_host(s, "max") for s in setup["plate"]]).astype(np.float32)
    masks = None
    if masked:
        rr, cc = np.mgrid[0:HW, 0:HW]
        masks = np.stack([((rr - 48) ** 2 + (cc - 44 - 4 * i) ** 2 < 40 ** 2) for i in range(len(imgs))])
        masks = masks.astype(np.float32)
    ref = np.asarray(jplate.plate_threshold(ONE_DEVICE, jnp.asarray(imgs), sd_coef,
                                            None if masks is None else jnp.asarray(masks)))
    out = tplate.plate_threshold(imgs, sd_coef, masks, device="cpu").numpy()
    assert out.dtype == ref.dtype == np.uint8 and 0 < ref.mean() < 0.5
    np.testing.assert_array_equal(out, ref)
    if not masked:
        scaled = tplate.rescale_intensity(torch.tensor(imgs), dims=(-2, -1))
        assert torch.equal(exec_threshold(scaled, None, sd_coef),
                           exec_threshold(scaled, torch.ones_like(scaled), sd_coef))


@pytest.fixture(scope="module")
def unet_8_32(setup):
    """A UNet of filters 8-16-32, patch 32, in both packages (float32)."""
    ckpt = setup["root"] / "unet_8_32.msgpack"
    save_params(ckpt, _variables(7, (8, 16, 32)))
    return (JaxSegmentor(PATCH, ckpt, (8, 16, 32), ds_ratio=1.0, dtype=jnp.float32)._pred_fn,
            UNetXceptionPatchSegmentor(PATCH, ckpt, (8, 16, 32), ds_ratio=1.0, dtype=torch.float32,
                                       device="cpu")._pred_fn)


@pytest.mark.parametrize("model", ["identity", "unet"])
def test_plate_segment_matches_jax(unet_8_32, model):
    """Tiled segmentation of a plate of two 40 x 44 wells (16 patches each,
    TTA 8): with an identity model the blend gives the wells back exactly
    as JAX's does (1e-6); with the 8-16-32 UNet, within 1e-4 of JAX's
    ``plate_segment``, as stage 1's predictions."""
    imgs = np.random.RandomState(11).rand(2, 40, 44).astype(np.float32)
    jax_pred, pred = ((lambda b: b), (lambda b: b)) if model == "identity" else unet_8_32
    ref = np.asarray(jplate.plate_segment(ONE_DEVICE, jnp.asarray(imgs), jax_pred, PATCH, 2))
    out = tplate.plate_segment(imgs, pred, PATCH, 2, device="cpu").numpy()
    assert out.shape == ref.shape == imgs.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6 if model == "identity" else 1e-4, rtol=0)
    if model == "identity":
        np.testing.assert_allclose(out, imgs, atol=1e-6, rtol=0)
    else:
        assert np.ptp(ref) > 0.3, "a flat prediction makes the comparison vacuous"


def _assert_results_close(out, ref):
    assert out["well_id"] == ref["well_id"]
    np.testing.assert_allclose(out["area_pct"], ref["area_pct"], atol=AREA_TOL, rtol=0)
    assert 0 < min(ref["area_pct"]) and max(ref["area_pct"]) < 100
    assert list(map(int, out["total_branches"])) == list(ref["total_branches"])
    assert sum(ref["total_branches"]) > 0
    for key in ("total_branch_length_um", "avg_branch_length_um"):
        np.testing.assert_allclose(np.asarray(out[key], float), ref[key], rtol=1e-6, atol=0)


_JAX_RESULTS = {}


def _jax_results(setup, method, detect_well=False):
    if (method, detect_well) not in _JAX_RESULTS:
        plate = setup["well_plate" if detect_well else "plate"]
        ref = jpp.run_plate(plate, ["W0", "W1", "W2"], setup["jax_seg"], CONFIG, sd_coef=SD_COEF,
                            detect_well=detect_well, proj_method=method, z_counts=list(Z_COUNTS))
        ref.pop("_timer")
        _JAX_RESULTS[method, detect_well] = ref
    return _JAX_RESULTS[method, detect_well]


@pytest.mark.parametrize("method", ["max", "avg", "fs"])
def test_run_plate_matches_jax(setup, method):
    ref = _jax_results(setup, method)
    out = tpp.run_plate(setup["plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, sd_coef=SD_COEF,
                        proj_method=method, z_counts=list(Z_COUNTS), device="cpu")
    timer = out.pop("_timer")
    assert {"device_stage1", "post_stage2", "morse_graphs"} <= set(timer.totals)
    _assert_results_close(out, ref)


@pytest.mark.parametrize("method", ["max", "fs"])
def test_run_plate_detect_well_matches_jax(setup, method, jax_draws, monkeypatch):
    """Ragged depth and well detection: the masks are fitted on the
    projection that stage 1 analyses, the area is of the well, and the
    shrunken masks prune the Morse graphs."""
    ref = _jax_results(setup, method, detect_well=True)
    fitted, fit = [], tpp.make_well_mask
    monkeypatch.setattr(tpp, "make_well_mask", lambda *a, **k: fitted.append(fit(*a, **k)) or fitted[-1])
    out = tpp.run_plate(setup["well_plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, sd_coef=SD_COEF,
                        detect_well=True, proj_method=method, z_counts=list(Z_COUNTS), device="cpu")
    assert "well_mask" in out.pop("_timer").totals
    _assert_results_close(out, ref)
    assert len(fitted) == 3 and all(0.4 <= m.mean() < 1 and s.sum() < m.sum() for m, s in fitted)


@pytest.mark.parametrize("method", ["max", "fs"])
def test_run_plate_detect_well_default_draws_matches_jax(setup, method):
    """Well detection with the port's own unit draws, nothing patched: the
    same results as the JAX plate."""
    ref = _jax_results(setup, method, detect_well=True)
    out = tpp.run_plate(setup["well_plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, sd_coef=SD_COEF,
                        detect_well=True, proj_method=method, z_counts=list(Z_COUNTS), device="cpu")
    out.pop("_timer")
    _assert_results_close(out, ref)


def _write_plate(setup, key="plate"):
    in_dir = setup["root"] / f"tiffs_{key}"
    if not in_dir.is_dir():
        in_dir.mkdir()
        for i, z in enumerate(Z_COUNTS):
            frames = [Image.fromarray(s) for s in setup[key][i, :z]]
            frames[0].save(in_dir / f"W{i}.tif", save_all=True, append_images=frames[1:])
    cfg = setup["root"] / "cfg.json"
    cfg.write_text(json.dumps({"patch_size": PATCH, "checkpoint_file": str(setup["ckpt"]),
                               "filter_counts": list(FILTERS), "ds_ratio": DS, "dtype": "float32"}))
    return in_dir, cfg


def _read_results(out_dir):
    with open(out_dir / "plate_results.csv", newline="") as f:
        rows = list(csv.reader(f))
    out = {k: [r[i] for r in rows[1:]] for i, k in enumerate(rows[0])}
    out["area_pct"] = [float(v) for v in out["area_pct"]]
    return rows[0], out


def test_cli_matches_jax(setup, tmp_path):
    in_dir, cfg = _write_plate(setup)
    out_dir = tmp_path / "out"
    tpp.main(argv=[str(in_dir), str(out_dir), "--image-width-microns", "800", "--model-cfg", str(cfg),
                   "--sd-coef", str(SD_COEF)], device="cpu")
    header, out = _read_results(out_dir)
    ref = _jax_results(setup, "max")
    assert header == [k for k in ref]
    _assert_results_close(out, ref)


@pytest.mark.parametrize("flag", [["-m", "fs"], ["-w"]])
def test_cli_refuses_unported_options(setup, tmp_path, flag, jax_draws):
    """``-m fs`` and ``-w`` were refused before they were ported; now the
    CLI with each of them writes what the JAX CLI writes (the name is kept
    for the record of test runs)."""
    in_dir, cfg = _write_plate(setup, "well_plate" if flag == ["-w"] else "plate")
    argv = ["--image-width-microns", "800", "--model-cfg", str(cfg), "--sd-coef", str(SD_COEF), *flag]
    jpp.main(argv=[str(in_dir), str(tmp_path / "jax"), *argv])
    tpp.main(argv=[str(in_dir), str(tmp_path / "torch"), *argv], device="cpu")
    header, out = _read_results(tmp_path / "torch")
    ref_header, ref = _read_results(tmp_path / "jax")
    assert header == ref_header
    ref = {k: [float(x) for x in v] if k != "well_id" else v for k, v in ref.items()}
    ref["total_branches"] = [int(x) for x in ref["total_branches"]]
    _assert_results_close(out, ref)
    with pytest.raises(ValueError, match="Unknown projection method"):
        tpp.run_plate(setup["plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, device="cpu",
                      proj_method="sharpest")


def test_cli_refuses_mixed_size_wells(setup, tmp_path):
    in_dir = tmp_path / "mixed"
    in_dir.mkdir()
    Image.fromarray(setup["plate"][0, 1]).save(in_dir / "A.tif")
    Image.fromarray(setup["plate"][0, 1, :64, :64]).save(in_dir / "B.tif")
    with pytest.raises(SystemExit) as exc:
        tpp.main(argv=[str(in_dir), str(tmp_path / "out"), "--image-width-microns", "800",
                       "--model-cfg", str(_write_plate(setup)[1])], device="cpu")
    assert exc.value.code == 1
