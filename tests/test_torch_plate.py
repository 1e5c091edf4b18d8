"""The port's plate pipeline against the JAX package's, end to end.

A tiny segmentor (filters 8-16, patch 32, ds_ratio 0.625) from numpy-seeded
variables is saved with ``tmat_tpu``'s ``save_params`` and loaded by both
packages. A 3-well, 96x96, ragged-Z plate (Z = 3/2/3) made with the
``bench.py::_synthetic_plate`` recipe goes through both ``run_plate``s and
through the port's CLI. Tolerances: area within one pixel, stage-1
predictions within 1e-4, filtered masks equal, branch counts equal and
lengths within 1e-6 relative.
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
    return {"root": root, "ckpt": ckpt, "plate": plate, "jax_seg": jax_seg, "seg": seg}


@pytest.mark.parametrize("method", ["max", "avg"])
def test_stage1_matches_jax(setup, method):
    """Areas, predictions and the host-filtered masks of stage 1."""
    plate, target = setup["plate"], (60, 60)
    projs = np.stack([proj_host(s[:z], method) for s, z in zip(plate, Z_COUNTS)])
    n_dev = len(jax.devices())
    padded = np.zeros((n_dev, HW, HW), projs.dtype)
    padded[: len(projs)] = projs
    j_area, j_pred, j_f, j_s = (np.asarray(a) for a in jax_stage1(
        make_mesh(axis_names=("data",)), jnp.asarray(padded), setup["jax_seg"]._pred_fn, PATCH, 2,
        target, SD_COEF, proj_method=method, pre_projected=True))
    area, pred, f_pk, s_pk = (a.numpy() for a in plate_stage1(
        torch.tensor(projs), setup["seg"]._pred_fn, PATCH, 2, target, SD_COEF,
        proj_method=method, pre_projected=True))
    n = len(projs)
    j_pred = j_pred[:n]
    assert np.abs(j_pred - 0.5).min() > 1e-4, "a prediction near 0.5 makes mask equality vacuous"
    np.testing.assert_allclose(pred, j_pred, atol=1e-4, rtol=0)
    np.testing.assert_allclose(area * 100, j_area[:n] * 100, atol=AREA_TOL, rtol=0)
    np.testing.assert_array_equal(f_pk, j_f[:n])
    np.testing.assert_array_equal(s_pk, j_s[:n])
    w = target[1]
    for j in range(n):
        f = np.unpackbits(f_pk[j], axis=-1)[..., :w].astype(np.uint8)
        s = np.unpackbits(s_pk[j], axis=-1)[..., :w].astype(bool)
        assert 0 < f.sum() < f.size
        np.testing.assert_array_equal(filter_branch_seg_mask(f, s),
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


def _jax_results(setup, method):
    if method not in _JAX_RESULTS:
        ref = jpp.run_plate(setup["plate"], ["W0", "W1", "W2"], setup["jax_seg"], CONFIG,
                            sd_coef=SD_COEF, proj_method=method, z_counts=list(Z_COUNTS))
        ref.pop("_timer")
        _JAX_RESULTS[method] = ref
    return _JAX_RESULTS[method]


@pytest.mark.parametrize("method", ["max", "avg"])
def test_run_plate_matches_jax(setup, method):
    ref = _jax_results(setup, method)
    out = tpp.run_plate(setup["plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, sd_coef=SD_COEF,
                        proj_method=method, z_counts=list(Z_COUNTS), device="cpu")
    timer = out.pop("_timer")
    assert {"device_stage1", "post_stage2", "morse_graphs"} <= set(timer.totals)
    _assert_results_close(out, ref)


def _write_plate(setup):
    in_dir = setup["root"] / "tiffs"
    if not in_dir.is_dir():
        in_dir.mkdir()
        for i, z in enumerate(Z_COUNTS):
            frames = [Image.fromarray(s) for s in setup["plate"][i, :z]]
            frames[0].save(in_dir / f"W{i}.tif", save_all=True, append_images=frames[1:])
    cfg = setup["root"] / "cfg.json"
    cfg.write_text(json.dumps({"patch_size": PATCH, "checkpoint_file": str(setup["ckpt"]),
                               "filter_counts": list(FILTERS), "ds_ratio": DS, "dtype": "float32"}))
    return in_dir, cfg


def test_cli_matches_jax(setup, tmp_path):
    in_dir, cfg = _write_plate(setup)
    out_dir = tmp_path / "out"
    tpp.main(argv=[str(in_dir), str(out_dir), "--image-width-microns", "800", "--model-cfg", str(cfg),
                   "--sd-coef", str(SD_COEF)], device="cpu")
    with open(out_dir / "plate_results.csv", newline="") as f:
        rows = list(csv.reader(f))
    ref = _jax_results(setup, "max")
    assert rows[0] == [k for k in ref]
    out = {k: [r[i] for r in rows[1:]] for i, k in enumerate(rows[0])}
    out["area_pct"] = [float(v) for v in out["area_pct"]]
    _assert_results_close(out, ref)


@pytest.mark.parametrize("flag", [["-m", "fs"], ["-w"]])
def test_cli_refuses_unported_options(setup, tmp_path, flag, capsys):
    in_dir, cfg = _write_plate(setup)
    with pytest.raises(SystemExit) as exc:
        tpp.main(argv=[str(in_dir), str(tmp_path / "out"), "--image-width-microns", "800",
                       "--model-cfg", str(cfg), *flag], device="cpu")
    assert exc.value.code == 2
    assert "ROADMAP.md" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpp.run_plate(setup["plate"], ["W0", "W1", "W2"], setup["seg"], CONFIG, device="cpu",
                      proj_method="fs" if flag[0] == "-m" else "max", detect_well=flag[0] == "-w")


def test_cli_refuses_mixed_size_wells(setup, tmp_path):
    in_dir = tmp_path / "mixed"
    in_dir.mkdir()
    Image.fromarray(setup["plate"][0, 1]).save(in_dir / "A.tif")
    Image.fromarray(setup["plate"][0, 1, :64, :64]).save(in_dir / "B.tif")
    with pytest.raises(SystemExit) as exc:
        tpp.main(argv=[str(in_dir), str(tmp_path / "out"), "--image-width-microns", "800",
                       "--model-cfg", str(_write_plate(setup)[1])], device="cpu")
    assert exc.value.code == 1
