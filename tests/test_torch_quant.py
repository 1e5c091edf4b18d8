"""The port's opt-in int8 segmentor (``tmat_torch/models/quant.py``) against
the JAX package's (``tmat_tpu/models/quant.py``), on the CPU.

A small UNet (filters 8-64, 64 px, random weights and BatchNorm statistics
from a numpy seed) goes through both packages. Tolerances:

- ``extract_folded``, ``default_calibration_batch``: equal arrays;
- calibration scales: within 1e-5 relative, or 1e-5 of the tag's largest
  scale (the convs sum in another order, and a channel whose activations
  come from cancelling sums carries a larger relative error: 2.5e-5 at one
  of the 1008 scales here); the percentile is JAX's float32 linear
  interpolation;
- ``quantize_folded`` / ``quantize_mixed`` given the same scales: the int8
  weights and float32 multipliers bit-equal;
- ``forward_folded``: within 1e-5, its statistics within 1e-5 relative;
- ``forward_quant`` in float32: every int32 sum is exact in both, an int8
  activation may differ by one step where an epilogue lands on a rounding
  tie, so probabilities within 1e-3 and masks at IoU >= 0.995;
- ``forward_mixed`` in float32: the port's down blocks sum in another
  order, which can move a requantised input across a rounding boundary:
  probabilities within 0.02, masks at IoU >= 0.995;
- the shipped checkpoint (96 px, batch 2, the shipped sidecar's scales):
  the port's mixed bfloat16 forward against JAX's at IoU >= 0.99 (JAX
  rounds at every conv, the port's down blocks at Pallas's points), and
  both against float32 at IoU >= 0.96 (the floor of ``tests/test_quant.py``).

The production geometry (patch 320, calibration batch 16 against the
shipped sidecar) is ``slow``; ``test_calibration_scales_match_jax`` is its
small twin.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import pytest
import torch

from tmat_tpu.core import aot_cache
from tmat_tpu.models import quant as JQ
from tmat_tpu.models.unet import build_unet_xception as jax_unet
from tmat_torch.core import defs
from tmat_torch.models import quant as Q
from tmat_torch.models.params_io import load_variables, save_params
from tmat_torch.models.unet import UNetXceptionPatchSegmentor, get_unet_patch_segmentor_from_cfg

FC = (8, 16, 32, 64)
SIZE = 64
SHIPPED_FC = (64, 128, 256, 512)
SHIPPED = Path(defs.PKG_MODEL_DIR) / "binary_segmentation" / "checkpoints" / "checkpoint_1.msgpack"


def _small_variables(seed=3):
    """Flax variables of the small UNet: kernels N(0, 1/fan-in), small
    biases, BN scales and variances in [0.5, 1.5], means near 0."""
    _, shapes = jax_unet(1, (SIZE, SIZE), filter_counts=FC, init="zeros")
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*a.shape) * np.sqrt(1.0 / np.prod(a.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, a.shape)
        else:
            v = 0.05 * rng.randn(*a.shape)
        return np.asarray(v, np.float32)

    return tu.tree_map_with_path(fill, shapes)


def _vessel_batch(size, n, seed=11):
    from tmat_tpu.models.synthetic import synth_vessel_image

    rng = np.random.RandomState(seed)
    imgs = []
    for _ in range(n):
        img, _ = synth_vessel_image(rng, size=size)
        img = img.astype(np.float32)
        imgs.append(((img - img.min()) / max(img.max() - img.min(), 1e-6))[..., None])
    return np.stack(imgs)


def _iou(a, b):
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


@pytest.fixture(scope="module")
def small():
    v = _small_variables()
    folded_j, folded_p = JQ.extract_folded(v, FC), Q.extract_folded(v, FC)
    calib = JQ.default_calibration_batch(SIZE, n=4)
    return {"v": v, "fj": folded_j, "fp": folded_p, "x": _vessel_batch(SIZE, 3),
            "scales_j": JQ.calibrate(folded_j, calib), "scales_p": Q.calibrate(folded_p, calib, "cpu")}


def _tags(folded):
    return [t for t in folded if not t.startswith("_")]


def test_extract_folded_equal(small):
    fj, fp = small["fj"], small["fp"]
    assert list(fj) == list(fp) and fj["_n"] == fp["_n"] == {"down": 3, "up": 4}
    for tag in _tags(fj):
        for key in ("w", "b"):
            if fj[tag][key] is None:
                assert fp[tag][key] is None
            else:
                np.testing.assert_array_equal(fp[tag][key], fj[tag][key], err_msg=tag)
        assert (fp[tag]["kind"], fp[tag]["stride"]) == (fj[tag]["kind"], fj[tag]["stride"])


@pytest.mark.parametrize("patch,n,seed", [(SIZE, 4, 7), (40, 3, 1)])
def test_default_calibration_batch_equal(patch, n, seed):
    np.testing.assert_array_equal(Q.default_calibration_batch(patch, n, seed),
                                  JQ.default_calibration_batch(patch, n, seed))


def test_calibration_scales_match_jax(small):
    sj, sp = small["scales_j"], small["scales_p"]
    assert set(sp) == set(sj) and len(sj) == 3 * 8 + 4 * 6 + 2
    for tag in sj:
        assert sp[tag].dtype == np.float32 and sp[tag].shape == sj[tag].shape
        np.testing.assert_allclose(sp[tag], sj[tag], rtol=1e-5, atol=1e-5 * sj[tag].max(), err_msg=tag)


def test_percentile_is_jax_linear_interpolation():
    rng = np.random.RandomState(0)
    for n in (1, 7, 5000):
        a = rng.rand(n, 3).astype(np.float32)
        np.testing.assert_allclose(Q._percentile(torch.tensor(a), 99.95).numpy(),
                                   np.asarray(jnp.percentile(a, 99.95, axis=0)), rtol=1e-6)


def test_calibration_turns_tf32_off_and_restores_it(small, monkeypatch):
    seen = []
    real = Q.forward_folded

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a, **k)

    monkeypatch.setattr(Q, "forward_folded", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    Q.calibrate(small["fp"], small["x"][:1], "cpu")
    assert seen == [False] and torch.backends.cudnn.allow_tf32 is True


def _assert_qparams_equal(qj, qp):
    assert set(qp) == set(qj)
    for tag, sj in qj.items():
        if not isinstance(sj, dict):
            np.testing.assert_array_equal(qp[tag], sj, err_msg=tag)
            continue
        assert set(qp[tag]) == set(sj), tag
        for key, a in sj.items():
            b = qp[tag][key]
            if isinstance(a, np.ndarray):
                assert b.dtype == a.dtype, (tag, key)
                np.testing.assert_array_equal(b, a, err_msg=f"{tag}.{key}")
            else:
                assert b == a, (tag, key)


@pytest.mark.parametrize("kwargs", [{}, {"quantize_depthwise": False}, {"float_tail": False},
                                    {"f32_tags": ("d1.pw2", "u0.t1")}])
def test_quantize_folded_bit_equal(small, kwargs):
    _assert_qparams_equal(JQ.quantize_folded(small["fj"], small["scales_j"], **kwargs),
                          Q.quantize_folded(small["fp"], small["scales_j"], **kwargs))


def test_quantize_mixed_bit_equal(small):
    _assert_qparams_equal(JQ.quantize_mixed(small["fj"], small["scales_j"]),
                          Q.quantize_mixed(small["fp"], small["scales_j"]))


def test_forward_folded_matches_jax(small):
    x = small["x"]
    yj, sj = JQ.forward_folded(small["fj"], jnp.asarray(x), collect=True)
    yp, sp = Q.forward_folded(small["fp"], torch.tensor(x), collect=True)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-5, rtol=0)
    assert set(sp) == set(sj)
    for tag in sj:
        np.testing.assert_allclose(sp[tag].numpy(), np.asarray(sj[tag]), rtol=1e-5, atol=1e-7, err_msg=tag)


@pytest.mark.parametrize("kwargs", [{}, {"quantize_depthwise": False}, {"float_tail": False}])
def test_forward_quant_matches_jax(small, kwargs):
    x = small["x"]
    qj = JQ.quantize_folded(small["fj"], small["scales_j"], **kwargs)
    qp = Q.quantize_folded(small["fp"], small["scales_j"], **kwargs)
    yj = np.asarray(JQ.forward_quant(qj, jnp.asarray(x), float_dtype=jnp.float32))
    yp = Q.forward_quant(qp, torch.tensor(x), float_dtype=torch.float32).numpy()
    assert yp.shape == yj.shape == x.shape and np.isfinite(yp).all()
    assert 0.05 < (yj > 0.5).mean() < 0.95, "vacuous: a constant mask"
    assert np.abs(yp - yj).max() <= 1e-3
    assert _iou(yp > 0.5, yj > 0.5) >= 0.995


def test_forward_mixed_matches_jax(small):
    x = small["x"]
    qj = JQ.quantize_mixed(small["fj"], small["scales_j"])
    qp = Q.quantize_mixed(small["fp"], small["scales_j"])
    yj = np.asarray(JQ.forward_mixed(qj, jnp.asarray(x), float_dtype=jnp.float32))
    yp = Q.forward_mixed(qp, torch.tensor(x), float_dtype=torch.float32).numpy()
    assert 0.05 < (yj > 0.5).mean() < 0.95, "vacuous: a constant mask"
    assert np.abs(yp - yj).max() <= 0.02
    assert _iou(yp > 0.5, yj > 0.5) >= 0.995
    # the mixed module is the port's UNet forward with six int8 up convs
    model = Q.MixedUNetXception(qp, torch.float32)
    assert model.int8_tags == set(Q.DEFAULT_MIXED_TAGS) and model.up0_k1 is None
    with pytest.raises(ValueError, match="up convs only"):
        Q.MixedUNetXception(Q.quantize_mixed(small["fp"], small["scales_j"], tags=("d0.pw1",)))


def test_make_quant_pred_fn_modes(small):
    """Both modes from explicit scales: the same forwards as above."""
    x = torch.tensor(small["x"])
    fn, scales = Q.make_quant_pred_fn(small["v"], FC, scales=small["scales_j"], float_dtype=torch.float32,
                                      mode="int8", device="cpu")
    assert scales is small["scales_j"]
    ref = Q.forward_quant(Q.quantize_folded(small["fp"], small["scales_j"]), x, torch.float32)
    assert torch.equal(fn(x), ref)
    model, _ = Q.make_quant_pred_fn(small["v"], FC, scales=small["scales_j"], float_dtype=torch.float32,
                                    device="cpu")
    assert isinstance(model, Q.MixedUNetXception)
    assert torch.equal(model(x), Q.forward_mixed(Q.quantize_mixed(small["fp"], small["scales_j"]), x,
                                                 torch.float32))
    with pytest.raises(ValueError, match="mode"):
        Q.make_quant_pred_fn(small["v"], FC, scales=small["scales_j"], mode="fp8", device="cpu")


def test_shipped_checkpoint_mixed_bf16():
    """The shipped segmentor with the shipped sidecar's scales, at 96 px."""
    scales = Q.load_scales_for(SHIPPED)
    assert scales is not None, "the shipped sidecar does not match the shipped checkpoint"
    v = load_variables(SHIPPED)
    x = _vessel_batch(96, 2, seed=5)
    fp = Q.extract_folded(v, SHIPPED_FC)
    ref = Q.forward_folded(fp, torch.tensor(x)).numpy() > 0.5
    yp = Q.forward_mixed(Q.quantize_mixed(fp, scales), torch.tensor(x), torch.bfloat16).float().numpy()
    fj = JQ.extract_folded(v, SHIPPED_FC)
    yj = np.asarray(JQ.forward_mixed(JQ.quantize_mixed(fj, scales), jnp.asarray(x), jnp.bfloat16), np.float32)
    assert ref.mean() > 0.05, "vacuous: no vessels predicted"
    assert _iou(yp > 0.5, yj > 0.5) >= 0.99
    assert _iou(yp > 0.5, ref) >= 0.96 and _iou(yj > 0.5, ref) >= 0.96


# --------------------------------------------------------------------------
# the sidecar and the segmentor's flag
# --------------------------------------------------------------------------


def test_fingerprint_and_sidecars_cross_packages(tmp_path):
    assert Q.ckpt_fingerprint(SHIPPED) == aot_cache.ckpt_fingerprint(SHIPPED)
    small_file = tmp_path / "small.msgpack"
    small_file.write_bytes(bytes(range(256)) * 300)  # under 128 KiB: read whole
    assert Q.ckpt_fingerprint(small_file) == aot_cache.ckpt_fingerprint(small_file)
    scales = {"entry": np.asarray([0.01], np.float32), "d0.dw1": np.linspace(1e-3, 2e-2, 8).astype(np.float32)}
    for save, load in ((JQ.save_scales_for, Q.load_scales_for), (Q.save_scales_for, JQ.load_scales_for)):
        Q.scales_path_for(small_file).unlink(missing_ok=True)
        save(small_file, scales)
        back = load(small_file)
        assert set(back) == set(scales)
        for k in scales:
            np.testing.assert_array_equal(back[k], scales[k])
    text = Q.scales_path_for(small_file).read_text()
    JQ.save_scales_for(small_file, scales)
    assert Q.scales_path_for(small_file).read_text() == text  # the same file from either package
    small_file.write_bytes(small_file.read_bytes() + b"\0")
    assert Q.load_scales_for(small_file) is None and JQ.load_scales_for(small_file) is None
    assert Q.load_scales(tmp_path / "missing.json") is None


@pytest.fixture
def tiny_ckpt(tmp_path):
    ckpt = tmp_path / "ckpt.msgpack"
    save_params(ckpt, _small_variables(seed=4))
    return ckpt


@pytest.fixture
def count_calibrations(monkeypatch):
    calls = {"n": 0}
    real = Q.calibrate

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(Q, "calibrate", counting)
    return calls


def test_segmentor_calibrates_saves_reuses_and_invalidates(tiny_ckpt, count_calibrations):
    def make():
        return UNetXceptionPatchSegmentor(32, tiny_ckpt, FC, ds_ratio=1.0, quantize=True, device="cpu", tta=1)

    seg = make()
    assert seg.quantized and count_calibrations["n"] == 1 and seg.dtype == torch.float32
    assert isinstance(seg.model, Q.MixedUNetXception)
    sidecar = Q.scales_path_for(tiny_ckpt)
    assert sidecar.is_file()
    doc = json.loads(sidecar.read_text())
    assert doc["_ckpt"] == aot_cache.ckpt_fingerprint(tiny_ckpt)
    assert JQ.load_scales_for(tiny_ckpt) is not None  # the JAX package takes the port's sidecar
    make()
    assert count_calibrations["n"] == 1  # reused
    pred = seg.predict(_vessel_batch(40, 1)[0, :, :, 0])
    assert pred.shape[:2] == (40, 40) and np.isfinite(pred).all()
    save_params(tiny_ckpt, tu.tree_map(lambda a: a * 1.01, load_variables(tiny_ckpt)))  # retrained
    make()
    assert count_calibrations["n"] == 2
    # an unwritable sidecar place is no error
    sidecar.unlink()
    sidecar.mkdir()
    make()
    assert count_calibrations["n"] == 3


def test_segmentor_takes_the_jax_sidecar(tiny_ckpt, count_calibrations):
    scales = Q.calibrate(Q.extract_folded(load_variables(tiny_ckpt), FC), Q.default_calibration_batch(32, 4),
                         "cpu")
    JQ.save_scales_for(tiny_ckpt, scales)
    n = count_calibrations["n"]
    seg = UNetXceptionPatchSegmentor(32, tiny_ckpt, FC, quantize=True, device="cpu")
    assert seg.quantized and count_calibrations["n"] == n


@pytest.mark.parametrize("cfg_value,env,expected", [(True, None, True), (None, "1", True), (None, None, False),
                                                    (False, "1", False), (None, "0", False)])
def test_config_key_and_environment(tmp_path, monkeypatch, tiny_ckpt, cfg_value, env, expected):
    """``"quantize"`` in a model config wins; unset, ``TMAT_TPU_INT8=1``."""
    shutil.copy(tiny_ckpt, tmp_path / "c.msgpack")
    Q.save_scales_for(tmp_path / "c.msgpack", Q.calibrate(
        Q.extract_folded(load_variables(tiny_ckpt), FC), Q.default_calibration_batch(32, 2), "cpu"))
    cfg = {"checkpoint_file": str(tmp_path / "c.msgpack"), "patch_size": 32, "filter_counts": list(FC),
           "ds_ratio": 1.0, "tta": 1}
    if cfg_value is not None:
        cfg["quantize"] = cfg_value
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    if env is None:
        monkeypatch.delenv("TMAT_TPU_INT8", raising=False)
    else:
        monkeypatch.setenv("TMAT_TPU_INT8", env)
    seg = get_unet_patch_segmentor_from_cfg(str(tmp_path / "cfg.json"), device="cpu")
    assert seg.quantized is expected
    assert isinstance(seg.model, Q.MixedUNetXception) is expected


@pytest.mark.slow
def test_production_calibration_matches_the_shipped_sidecar():
    """Patch 320, the default 16-image batch, on the CPU: every scale
    within 1e-3 relative of the shipped sidecar (calibrated by JAX)."""
    shipped = Q.load_scales_for(SHIPPED)
    mine = Q.calibrate(Q.extract_folded(load_variables(SHIPPED), SHIPPED_FC), Q.default_calibration_batch(320),
                       "cpu")
    assert set(mine) == set(shipped)
    for tag in shipped:
        np.testing.assert_allclose(mine[tag], shipped[tag], rtol=1e-3, err_msg=tag)
