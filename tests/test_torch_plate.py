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
from tmat_tpu.parallel.mesh import make_mesh
from tmat_tpu.parallel.plate import plate_stage1 as jax_stage1
from tmat_tpu.tools import plate_pipeline as jpp
from tmat_tpu.topo.transforms import filter_branch_seg_mask as jax_filter
from tmat_torch.models.unet import UNetXceptionPatchSegmentor
from tmat_torch.ops import wellmask
from tmat_torch.ops.zproj import proj_host
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


def _variables(seed=25):
    """Numpy-seeded Flax variables; the head is scaled up so predictions
    saturate away from 0.5 and the thresholded masks are well defined."""
    _, shapes = build_unet_xception(1, (PATCH, PATCH), channels=1, filter_counts=FILTERS, init="zeros")
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*a.shape) / np.sqrt(np.prod(a.shape[:-1]))
            if path[-2].key == "Conv_4":  # the head
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
