"""The port's tools striped over two processes (gloo, on the CPU).

Mirrors ``tests/test_distributed_tools.py``: two processes of one job
(torchrun's environment over localhost, ``parallel/validation.py``) on a
shared temporary directory write CSVs byte-equal to a one-process run of
the same tool, each per-image file exactly once, and one unreadable
input fails every process. The one-process references run in this
process with ``device="cpu"``. The zproj-to-area chain, the branches
sweep and inv_depth are ``slow``, as their JAX counterparts are; zproj
alone stays in the fast set.
"""

import json

import numpy as np
import pytest
from PIL import Image

from tmat_torch.parallel.validation import InfraFailure, run_with_retry


def _make_imgs(d, n=5):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        img = (rng.rand(48, 48) * 60).astype(np.uint8)
        img[10:30, 10:30] = 240
        Image.fromarray(img).save(d / f"img{i}.tif")


def _run_tool(tmp_path, module, argv, timeout=300):
    """``tmat_torch.tools.<module>.main(argv, device="cpu")`` in each of two processes."""
    code = (f"from tmat_torch.tools import {module} as t\n"
            f"t.main(argv={[str(a) for a in argv]!r}, device='cpu')\n")
    return run_with_retry(["-c", code], 2, extra_env={"TMAT_TPU_BASE_DIR": str(tmp_path / "base")},
                          timeout=timeout)


def test_two_process_cell_area_matches_one_process(tmp_path):
    from tmat_torch.tools import compute_cell_area

    in_dir, one, two = tmp_path / "in", tmp_path / "one", tmp_path / "two"
    _make_imgs(in_dir, n=5)
    compute_cell_area.main(argv=[str(in_dir), str(one), "-w"], device="cpu")
    _run_tool(tmp_path, "compute_cell_area", [in_dir, two, "-w"])

    assert (two / "calculations" / "cell_area.csv").read_bytes() == \
        (one / "calculations" / "cell_area.csv").read_bytes()
    assert len(list((two / "calculations").glob("*.csv"))) == 1
    pngs = sorted(p.name for p in (one / "thresholded").glob("*.png"))
    assert sorted(p.name for p in (two / "thresholded").glob("*.png")) == pngs and len(pngs) == 10
    for name in pngs:
        assert (two / "thresholded" / name).read_bytes() == (one / "thresholded" / name).read_bytes()


def test_two_process_cell_area_bad_file_fails_every_process(tmp_path):
    in_dir, out = tmp_path / "in", tmp_path / "out"
    _make_imgs(in_dir, n=4)
    (in_dir / "img1.tif").write_bytes(b"not a tiff at all")
    with pytest.raises(RuntimeError) as exc_info:
        # a peer left waiting would meet the timeout and raise InfraFailure instead
        _run_tool(tmp_path, "compute_cell_area", [in_dir, out], timeout=120)
    assert not isinstance(exc_info.value, InfraFailure), exc_info.value
    assert "rc=1" in str(exc_info.value)
    assert not (out / "calculations" / "cell_area.csv").exists()


_PLATE = """
from tmat_torch.parallel.validation import identity_segmentor
from tmat_torch.tools import plate_pipeline as t
t.get_unet_patch_segmentor_from_cfg = lambda cfg, device=None: identity_segmentor(device=device)
t.main(argv={argv!r}, device="cpu")
"""


def test_two_process_plate_matches_one_process(tmp_path, monkeypatch):
    """process_plate on the identity segmentor: five demo wells as slice
    sequences, striped 3 + 2."""
    from tmat_torch.parallel import validation
    from tmat_torch.tools import plate_pipeline

    plate, ids = validation.make_demo_plate(5)
    in_dir = tmp_path / "in"
    for stack, wid in zip(plate, ids):
        (in_dir / wid).mkdir(parents=True)
        for z, sl in enumerate(stack):
            Image.fromarray(sl).save(in_dir / wid / f"{wid}_z{z}.tif")
    argv = [str(in_dir), None, "--image-width-microns", "800", "--sd-coef", "-1", "--model-cfg", "unused"]
    monkeypatch.setattr(plate_pipeline, "get_unet_patch_segmentor_from_cfg",
                        lambda cfg, device=None: validation.identity_segmentor(device=device))
    plate_pipeline.main(argv=[a if a else str(tmp_path / "one") for a in argv], device="cpu")
    code = _PLATE.format(argv=[a if a else str(tmp_path / "two") for a in argv])
    outs = run_with_retry(["-c", code], 2, extra_env={"TMAT_TPU_BASE_DIR": str(tmp_path / "base")},
                          timeout=300)

    ref = (tmp_path / "one" / "plate_results.csv").read_bytes()
    assert (tmp_path / "two" / "plate_results.csv").read_bytes() == ref
    assert ref.decode().count("\n") == 6  # a header and five wells
    assert ["3 wells in" in outs[0], "2 wells in" in outs[1]] == [True, True]


def _zproj_inputs(in_dir, n=3):
    rng = np.random.RandomState(1)
    for i in range(n):
        stack_dir = in_dir / f"well{i}"
        stack_dir.mkdir(parents=True)
        for z in range(3):
            img = (rng.rand(40, 40) * 50).astype(np.uint8)
            img[8:24, 8:24] = 200 + z * 10
            Image.fromarray(img).save(stack_dir / f"s_z{z}.tif")


def test_two_process_zproj_matches_one_process(tmp_path):
    """Striped focus-stacked projections, each written once, byte-equal."""
    from tmat_torch.tools import compute_zproj

    in_dir, one, two = tmp_path / "in", tmp_path / "one", tmp_path / "two"
    _zproj_inputs(in_dir)
    compute_zproj.main(argv=[str(in_dir), str(one), "-m", "fs"], device="cpu")
    _run_tool(tmp_path, "compute_zproj", [in_dir, two, "-m", "fs"])
    tifs = sorted(p.name for p in one.iterdir())
    assert sorted(p.name for p in two.iterdir()) == tifs and len(tifs) == 3
    for name in tifs:
        assert (two / name).read_bytes() == (one / name).read_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("method", ["max", "fs"])
def test_two_process_zproj_area_chain_matches_one_process(tmp_path, method):
    """Striped projections, the barrier before the chained area tool lists
    the shared output directory, then the striped area pass."""
    from tmat_torch.tools import compute_zproj

    in_dir, one, two = tmp_path / "in", tmp_path / "one", tmp_path / "two"
    _zproj_inputs(in_dir)
    compute_zproj.main(argv=[str(in_dir), str(one), "-m", method, "--area"], device="cpu")
    _run_tool(tmp_path, "compute_zproj", [in_dir, two, "-m", method, "--area"])

    tifs = sorted(p.name for p in one.glob("*.tif*"))
    assert sorted(p.name for p in two.glob("*.tif*")) == tifs and len(tifs) == 3
    for name in tifs:
        assert (two / name).read_bytes() == (one / name).read_bytes()
    assert (two / "calculations" / "cell_area.csv").read_bytes() == \
        (one / "calculations" / "cell_area.csv").read_bytes()


@pytest.mark.slow
def test_two_process_branches_sweep_matches_one_process(tmp_path):
    """A threshold sweep with --no-vis: the rows of both sweep CSVs go to
    the primary in discovery order; config.json is written once."""
    from scipy import ndimage

    from tmat_tpu.models.params_io import save_params
    from tmat_tpu.models.unet import build_unet_xception
    from tmat_torch.tools import compute_branches

    patch = 32
    ckpt = tmp_path / "ckpt.msgpack"
    _, variables = build_unet_xception(1, (patch, patch), channels=1, filter_counts=(8, 16))
    save_params(ckpt, variables)
    model_cfg = tmp_path / "segmentor.json"
    model_cfg.write_text(json.dumps({"patch_size": patch, "checkpoint_file": str(ckpt),
                                     "filter_counts": [8, 16], "ds_ratio": 1.0, "channels": 1}))
    rng = np.random.RandomState(4)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rr, cc = np.mgrid[0:96, 0:96]
    for i in range(3):
        img = rng.rand(96, 96).astype(np.float32) * 10
        img[np.abs(np.sqrt((rr - 48.0) ** 2 + (cc - 48.0) ** 2) - 30) < 3] += 180
        img[48, 18:78] += 150
        img = ndimage.gaussian_filter(img, 1.0)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(in_dir / f"well{i}.tif")
    tail = ["--image-width-microns", "1000", "--model-cfg-path", str(model_cfg),
            "--graph-thresh-1", "2", "8", "--no-vis"]
    one, two = tmp_path / "one", tmp_path / "two"
    compute_branches.main(argv=[str(in_dir), str(one), *tail], device="cpu")
    _run_tool(tmp_path, "compute_branches", [in_dir, two, *tail], timeout=600)

    ref = {p.name: p.read_bytes() for p in one.glob("branching_analysis*.csv")}
    assert len(ref) == 2
    assert {p.name: p.read_bytes() for p in two.glob("branching_analysis*.csv")} == ref
    assert len(list(two.glob("config*.json"))) == 1
    assert (two / "config.json").read_bytes() == (one / "config.json").read_bytes()


@pytest.mark.slow
def test_two_process_inv_depth_matches_one_process(tmp_path, monkeypatch):
    """A tiny two-member ensemble with random heads; three stacks striped
    2 + 1."""
    from test_tool_inv_depth import _setup_model_dir
    from tmat_tpu.models.params_io import load_params, save_params
    from tmat_tpu.models.resnet import build_resnet50_tl
    from tmat_torch.core import defs
    from tmat_torch.tools import compute_inv_depth

    base = tmp_path / "base"
    mt = _setup_model_dir(base, n_models=2, inp=32)
    _, template = build_resnet50_tl(1, (32, 32, 3), base_last_layer="conv4_block6_out", init="zeros")
    head_rng = np.random.RandomState(11)
    for i in range(2):
        path = mt / "best_ensemble" / f"best_finetune_weights_{i}.msgpack"
        variables = load_params(path, template)
        variables["params"]["head"]["kernel"] = (head_rng.randn(1024, 1) * 0.5).astype(np.float32)
        save_params(path, variables)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"n_pred_models": 2}))
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        frames = [Image.fromarray((rng.rand(40, 40) * 255).astype(np.uint8)) for _ in range(2 + i)]
        frames[0].save(in_dir / f"stack{i}.tif", save_all=True, append_images=frames[1:])

    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", mt)
    one, two = tmp_path / "one", tmp_path / "two"
    compute_inv_depth.main(argv=[str(in_dir), str(one), "-c", str(cfg)], device="cpu")
    _run_tool(tmp_path, "compute_inv_depth", [in_dir, two, "-c", cfg])

    csv_name = "invasion_depth_predictions.csv"
    ref = (one / csv_name).read_bytes()
    assert (two / csv_name).read_bytes() == ref
    assert ref.decode().count("\n") == 1 + 2 + 3 + 4
    assert len(set(ref.decode().split(",")[4::2])) > 1  # the heads are not all 0.5
