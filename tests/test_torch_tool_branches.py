"""The port's ``compute_branches`` against the JAX tool, both run on the
same temp directory of inputs (the port with ``device="cpu"``).

Held to: the same file names, UTF-16 ``branching_analysis*.csv`` files and
``config.json`` byte-equal, and every visualization PNG within one grey
level (the PNGs truncate a float stretch; barcode and Morse-tree plots are
byte-equal), on the 2-D path with the tiny UNet of
tests/test_tool_branches.py and on the 3-D Sato path (with a
``--graph-thresh-1 2 8`` sweep); the port's ``--no-vis`` CSVs against the
same JAX runs. The
shipped checkpoint and ``-w`` are in test_torch_tool_branches_2d.py.
"""

import csv
import filecmp
import json
import os

import numpy as np
import pytest
from PIL import Image

from test_tool_branches import _setup_unet, _vessel_network_img
from test_torch_branches import jax_native_engine  # noqa: F401  (autouse)
from tmat_tpu.core import defs as jdefs
from tmat_tpu.tools import compute_branches as jcb
from tmat_torch.core import defs as tdefs
from tmat_torch.tools import args as su, compute_branches as cb

CONFIG = str(jdefs.default_config_path("default_branching_computation.json"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_outputs(out, ref):
    assert _files(out) == _files(ref) and _files(ref)
    for rel in _files(ref):
        if rel.endswith(".png") and not filecmp.cmp(out / rel, ref / rel, shallow=False):
            a = np.asarray(Image.open(out / rel)).astype(int)
            b = np.asarray(Image.open(ref / rel)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, f"{rel} differs"
            assert "barcode" not in rel and "morse_tree" not in rel, f"{rel} differs"
        else:
            assert filecmp.cmp(out / rel, ref / rel, shallow=False), f"{rel} differs"


def _rows(path):
    with open(path, encoding="utf-16") as f:
        return list(csv.reader(f))


def _run_both(tmp_path, in_dir, extra, no_vis_too=False):
    """Both tools on ``in_dir``; the port's outputs against the JAX tool's.
    With ``no_vis_too`` the port also runs with ``--no-vis`` (native Morse
    engine), whose CSVs must equal the JAX tool's default run's (the JAX
    package's own tests hold its two modes equal)."""
    args = [*extra, "-c", CONFIG]
    jcb.main(argv=[str(in_dir), str(tmp_path / "jax"), *args])
    cb.main(argv=[str(in_dir), str(tmp_path / "torch"), *args], device="cpu")
    _assert_same_outputs(tmp_path / "torch", tmp_path / "jax")
    if no_vis_too:
        out = tmp_path / "torch_no_vis"
        cb.main(argv=[str(in_dir), str(out), *args, "--no-vis"], device="cpu")
        csvs = [f for f in _files(tmp_path / "jax") if f.endswith(".csv")]
        assert sorted(_files(out)) == sorted(csvs + ["config.json"])
        for name in csvs:
            assert filecmp.cmp(out / name, tmp_path / "jax" / name, shallow=False), f"{name} differs"
        cfg = json.loads((out / "config.json").read_text())
        assert cfg.pop("save_vis") is False
        ref = json.loads((tmp_path / "jax" / "config.json").read_text())
        assert ref.pop("save_vis") is True and cfg == ref
    return tmp_path / "torch"


@pytest.fixture
def tiny_unet(tmp_path, monkeypatch):
    mt = _setup_unet(tmp_path)
    monkeypatch.setattr(jdefs, "MODEL_TRAINING_DIR", mt)
    monkeypatch.setattr(tdefs, "MODEL_TRAINING_DIR", mt)
    return mt


def _well_image(tmp_path, name="wellA", h=128, w=128):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    Image.fromarray(_vessel_network_img(h, w)).save(in_dir / f"{name}.tif")
    return in_dir


def test_main_2d_tiny_unet(tmp_path, tiny_unet):
    out = _run_both(tmp_path, _well_image(tmp_path), ["--image-width-microns", "1000"], no_vis_too=True)
    assert _rows(out / "branching_analysis.csv")[0][0] == "Image"
    assert (out / "visualizations" / "wellA" / "prediction.png").is_file()


def _write_stack(tmp_path, scales=(0.6, 1.0, 0.8)):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    base = _vessel_network_img(96, 96)
    frames = [Image.fromarray((base * s).astype(np.uint8)) for s in scales]
    frames[0].save(in_dir / "stackA.tif", save_all=True, append_images=frames[1:])
    return in_dir


def test_main_3d_sweep(tmp_path, tiny_unet):
    out = _run_both(tmp_path, _write_stack(tmp_path), [
        "--image-width-microns", "800", "--graph-thresh-1", "2", "8", "--graph-thresh-2", "5"],
        no_vis_too=True)
    names = sorted(p for p in os.listdir(out) if p.endswith(".csv"))
    assert names == ["branching_analysis_CONFIG_thresh1_2.0.csv", "branching_analysis_CONFIG_thresh1_8.0.csv"]
    for name in names:
        rows = _rows(out / name)
        assert len(rows) == 2 and int(rows[1][1]) >= 1 and float(rows[1][2]) > 0


def test_main_3d_single_config_and_flags(tmp_path, tiny_unet):
    """One config, a max branch length, isolated branches removed, a
    smoothing window: still byte-equal; a second run writes ``-2`` files."""
    in_dir = _write_stack(tmp_path, (1.0, 0.7))
    extra = ["--image-width-microns", "700", "--max-branch-length", "150",
             "--remove-isolated-branches", "--graph-smoothing-window", "6", "--min-branch-length", "5"]
    out = _run_both(tmp_path, in_dir, extra)
    cb.main(argv=[str(in_dir), str(out), *extra, "-c", CONFIG], device="cpu")
    assert _rows(out / "branching_analysis-2.csv") == _rows(out / "branching_analysis.csv")
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["remove_isolated_branches"] is True and cfg["max_branch_length"] == 150.0
    assert (out / "config-2.json").is_file()


def test_parse_branching_args_match_jax():
    from tmat_tpu.tools import args as jargs

    defaults = {"default_config_path": CONFIG}
    for argv in (["in", "out"], ["in", "out", "-w", "--image-width-microns", "900", "--graph-thresh-1",
                                 "1", "2", "--graph-thresh-2", "3", "--min-branch-length", "4",
                                 "--max-branch-length", "50", "--remove-isolated-branches",
                                 "--graph-smoothing-window", "7", "--model-cfg-path", "m.json",
                                 "--no-vis", "--tta", "4", "-c", "c.json", "--time", "1", "--channel", "0"]):
        assert vars(su.parse_branching_args(defaults, argv)) == vars(jargs.parse_branching_args(defaults, argv))
    assert su.parse_branching_args(defaults, ["in", "out"]).remove_isolated_branches is None
    with pytest.raises(SystemExit):
        su.parse_branching_args(defaults, ["in", "out", "--tta", "3"])


def test_main_errors(tmp_path, tiny_unet):
    with pytest.raises(SystemExit) as e:
        cb.main(argv=[str(tmp_path / "missing"), str(tmp_path / "out"), "-c", CONFIG], device="cpu")
    assert e.value.code == 1
    with pytest.raises(SystemExit) as e:
        cb.main(argv=[str(tmp_path), str(tmp_path / "out"), "--model-cfg-path",
                      str(tmp_path / "none.json"), "-c", CONFIG], device="cpu")
    assert e.value.code == 1
    in_dir = _well_image(tmp_path)
    with pytest.raises(SystemExit) as e:  # no width given and none in the metadata
        cb.main(argv=[str(in_dir), str(tmp_path / "out2"), "-c", CONFIG], device="cpu")
    assert e.value.code == 1


def test_append_csv_row_collision_contract(tmp_path):
    """Rows append to a CSV this run created; a CSV of an earlier run gets
    the first free ``-N`` sibling, as in the JAX tool."""
    for mod, sub in ((jcb, "jax"), (cb, "torch")):
        out = tmp_path / sub
        out.mkdir()
        created, created2, created3 = set(), set(), set()
        mod.append_csv_row(out, "", ["a", 1, 2.0, 3.0], created)
        mod.append_csv_row(out, "", ["b", 4, 5.0, 6.0], created)
        mod.append_csv_row(out, "", ["c", 7, 8.0, 9.0], created2)
        mod.append_csv_row(out, "", ["d", 0, 0.0, 0.0], created3)
        mod.append_csv_row(out, "", ["e", 1, 1.0, 1.0], created2)
        mod.append_csv_row(out, "_CONFIG_thresh1_05", ["f", 1, 1.0, 1.0], created)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax") == [
        "branching_analysis-2.csv", "branching_analysis-3.csv", "branching_analysis.csv",
        "branching_analysis_CONFIG_thresh1_05.csv"]
    _assert_same_outputs(tmp_path / "torch", tmp_path / "jax")
    assert [r[0] for r in _rows(tmp_path / "torch" / "branching_analysis-2.csv")] == ["Image", "c", "e"]


def test_analyze_branches_is_file_free(tmp_path, tiny_unet):
    """The core on arrays: rows per sweep tag and the rasters, no file."""
    from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg

    seg = get_unet_patch_segmentor_from_cfg(
        str(tiny_unet / "binary_segmentation" / "configs" / "unet_patch_segmentor_1.json"), device="cpu")
    config = {"image_width_microns": 800.0, "graph_thresh_1": [2.0, 8.0], "graph_thresh_2": 5}
    stack = np.stack([(_vessel_network_img(96, 96) * s).astype(np.uint8) for s in (0.6, 1.0, 0.8)])
    before = set(os.listdir(tmp_path))
    res = cb.analyze_branches(stack, seg, config, device="cpu")
    assert [t for t, _ in res.rows] == ["_CONFIG_thresh1_2.0", "_CONFIG_thresh1_8.0"]
    assert list(res.rasters) == ["original_image.png", "vesselness_image.png"]
    assert set(res.graphs) == {"_CONFIG_thresh1_2.0", "_CONFIG_thresh1_8.0"} and res.dsamp_res == (384, 384)
    no_vis = cb.analyze_branches(stack, seg, {**config, "save_vis": False}, device="cpu")
    assert no_vis.rows == res.rows and not no_vis.rasters and not no_vis.graphs
    two_d = cb.analyze_branches(_vessel_network_img(), seg, {"image_width_microns": 1000.0}, device="cpu")
    assert list(two_d.rasters) == ["original_image.png", "prediction.png", "segmentation_mask.png",
                                   "distance_transform.png"]
    assert set(os.listdir(tmp_path)) == before
    with pytest.raises(ValueError, match="image_width_microns"):
        cb.analyze_branches(stack, seg, {}, device="cpu")
