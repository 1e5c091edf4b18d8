"""The port's front doors: ``tmat_torch.cli``, ``configure`` and ``gui``.

Mirrors ``tests/test_cli.py``, ``tests/test_configure.py`` and
``tests/test_gui_drive.py`` with ``device="cpu"``: every subcommand reaches
the port's tool, ``configure`` creates, relocates and records the base
directory as the JAX package's does (``package.cfg`` and the base dirs
redirected into ``tmp_path``), and each GUI tab builds the namespace the
JAX GUI builds and runs the port's tool.
"""

import argparse
import configparser
import csv
import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from tmat_tpu import gui as jgui
from tmat_torch import cli, configure as cfg_mod, gui
from tmat_torch.core import defs

TOOLS = {"compute_zproj": "compute_zproj", "compute_cell_area": "compute_cell_area",
         "compute_inv_depth": "compute_inv_depth", "compute_branches": "compute_branches",
         "process_plate": "plate_pipeline"}


@pytest.fixture
def base(tmp_path, monkeypatch):
    """The base dirs and package.cfg under tmp_path; the shipped models."""
    monkeypatch.setattr(defs, "BASE_DIR", tmp_path / "base")
    monkeypatch.setattr(defs, "SCRIPT_CONFIG_DIR", tmp_path / "base" / "config")
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", tmp_path / "base" / "model_training")
    monkeypatch.setattr(defs, "PKG_CFG_PATH", tmp_path / "package.cfg")
    return tmp_path


def _slices(in_dir, rng, n=3, size=16, name="w"):
    in_dir.mkdir()
    stack = rng.randint(0, 255, (n, size, size)).astype(np.uint8)
    for z, s in enumerate(stack):
        Image.fromarray(s).save(in_dir / f"{name}_z{z}.tif")
    return stack


# ---------------------------------------------------------------- cli


def test_help_exits_zero(capsys):
    assert cli.main(["-h"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in ["configure", *TOOLS])
    assert "warmup" not in out and "tmat-torch" in out


def test_module_help_exits_zero():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "tmat_torch.cli", "-h"], capture_output=True,
                         text=True, timeout=120, cwd=defs.REPO_DIR)
    assert out.returncode == 0 and "compute_inv_depth" in out.stdout


def test_unknown_subcommand(capsys):
    assert cli.main(["frobnicate"]) == 1
    assert "Unknown subcommand" in capsys.readouterr().out


@pytest.mark.parametrize("command", list(TOOLS))
def test_each_subcommand_reaches_the_port_tool(command, base, monkeypatch):
    import importlib

    module = importlib.import_module(f"tmat_torch.tools.{TOOLS[command]}")
    calls = []
    monkeypatch.setattr(module, "main", lambda argv, device: calls.append((argv, device)))
    assert cli.main([command, "IN", "OUT", "--flag"], device="cpu") == 0
    assert calls == [(["IN", "OUT", "--flag"], "cpu")]
    # the missing base dirs were configured first, nothing recorded for a session override
    assert (base / "base" / "config").is_dir() and (base / "base" / "model_training").is_dir()


@pytest.mark.parametrize("command,flag", [("compute_zproj", "--area"), ("compute_cell_area", "--sd-coef"),
                                          ("compute_inv_depth", "--config"),
                                          ("compute_branches", "--image-width-microns"),
                                          ("process_plate", "--image-width-microns")])
def test_subcommand_help_dispatches(command, flag, base, capsys):
    assert cli.main([command, "-h"], device="cpu") == 0
    assert flag in capsys.readouterr().out


def test_dispatch_zproj(base, rng):
    stack = _slices(base / "in", rng)
    code = cli.main(["compute_zproj", str(base / "in"), str(base / "out"), "-m", "max"], device="cpu")
    assert code == 0
    np.testing.assert_array_equal(np.asarray(Image.open(base / "out" / "w_max.tif")), stack.max(0))


def test_dispatch_cell_area(base, rng):
    _slices(base / "in", rng, n=1, size=64)
    os.rename(base / "in" / "w_z0.tif", base / "in" / "w.tif")
    assert cli.main(["compute_cell_area", str(base / "in"), str(base / "out")], device="cpu") == 0
    with open(base / "out" / "calculations" / "cell_area.csv") as f:
        assert [r["image_id"] for r in csv.DictReader(f)] == ["w"]


def test_tool_error_propagates(tmp_path):
    assert cli.main(["compute_cell_area", str(tmp_path / "missing"), str(tmp_path)], device="cpu") == 1
    assert cli.main(["compute_inv_depth", str(tmp_path / "missing"), str(tmp_path)], device="cpu") == 1


def test_dispatch_inv_depth_with_the_shipped_ensemble(base):
    from tmat_torch.models.synthetic import synth_invasion_image

    rng = np.random.RandomState(5)
    stack = [synth_invasion_image(rng, 256, invaded=False), synth_invasion_image(rng, 256, invaded=True)]
    (base / "in").mkdir()
    frames = [Image.fromarray(s) for s in stack]
    frames[0].save(base / "in" / "well1.tif", save_all=True, append_images=frames[1:])
    assert cli.main(["compute_inv_depth", str(base / "in"), str(base / "out")], device="cpu") == 0
    with open(base / "out" / "invasion_depth_predictions.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["Z Slice ID"] for r in rows] == ["well1_z0", "well1_z1"]
    assert [r["Invasion Prediction (0=no 1=yes)"] for r in rows] == ["0", "1"]


def test_process_plate_runs_tiny_plate(base, rng):
    from tmat_tpu.models.params_io import save_params
    from tmat_tpu.models.unet import build_unet_xception

    seg = base / "base" / "model_training" / "binary_segmentation"
    (seg / "configs").mkdir(parents=True)
    (seg / "checkpoints").mkdir()
    _, variables = build_unet_xception(1, (32, 32), channels=1, filter_counts=(8, 16))
    save_params(seg / "checkpoints" / "checkpoint_1.msgpack", variables)
    cfg_path = seg / "configs" / "unet_patch_segmentor_1.json"
    cfg_path.write_text(json.dumps({"patch_size": 32, "checkpoint_file": "checkpoint_1.msgpack",
                                    "filter_counts": [8, 16], "ds_ratio": 1.0, "channels": 1}))
    in_dir = base / "plate"
    in_dir.mkdir()
    for well in ("A01", "B02"):
        for z in range(2):
            Image.fromarray((rng.rand(96, 96) * 255).astype(np.uint8)).save(in_dir / f"{well}_z{z}.tif")
    code = cli.main(["process_plate", str(in_dir), str(base / "out"), "--image-width-microns", "1000",
                     "--model-cfg", str(cfg_path)], device="cpu")
    assert code == 0
    text = (base / "out" / "plate_results.csv").read_text()
    assert "A01" in text and "B02" in text


def test_interactive_menu(base, monkeypatch, capsys):
    answers = iter(["nope", "1", "compute_zproj", "-h"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli.main([], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Invalid command option: nope" in out and "Usage: tmat-torch" in out
    assert "--method" in out  # the tool's own help, from the arguments typed
    monkeypatch.setattr("builtins.input", lambda prompt="": "q")
    assert cli.main([]) == 0


def test_configure_subcommand(base):
    assert cli.main(["configure", str(base / "chosen")]) == 0
    assert (base / "chosen" / "config").is_dir()
    assert _recorded(base).endswith("chosen")


# ---------------------------------------------------------------- configure


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(defs, "PKG_CFG_PATH", tmp_path / "package.cfg")
    monkeypatch.setattr(defs, "BASE_DIR", tmp_path / "default_base")
    return tmp_path


def _recorded(tmp_path):
    parser = configparser.ConfigParser()
    parser.read(tmp_path / "package.cfg")
    return parser[defs.PKG_NAME]["base_dir"]


def test_configure_creates_fresh_base(isolated):
    target = isolated / "base_a"
    assert cfg_mod.configure(str(target)) == target
    assert all((target / d).is_dir() for d in ("config", "model_training", "output"))
    assert (target / "config" / "default_invasion_depth_computation.json").is_file()
    assert _recorded(isolated).endswith("base_a")
    # the file the JAX package and the port's defs both read
    parser = configparser.ConfigParser()
    parser.read(isolated / "package.cfg")
    assert parser["metadata"]["name"] == "tmat_tpu" and defs.PKG_NAME == "tmat_tpu"


def test_reconfigure_moves_existing_base(isolated):
    old = cfg_mod.configure(str(isolated / "base_a"))
    (old / "model_training" / "user_artifact.txt").write_text("keep me")
    new = cfg_mod.configure(str(isolated / "base_b"))
    assert not old.exists()
    assert (new / "model_training" / "user_artifact.txt").read_text() == "keep me"
    assert _recorded(isolated).endswith("base_b")


def test_reconfigure_existing_target_writes_in_place(isolated):
    old = cfg_mod.configure(str(isolated / "base_a"))
    (isolated / "base_b").mkdir()
    cfg_mod.configure(str(isolated / "base_b"))
    assert old.exists() and (isolated / "base_b" / "config").is_dir()


def test_unrecorded_env_dir_is_never_moved(isolated, monkeypatch):
    env_dir = isolated / "precious_checkout"
    env_dir.mkdir()
    (env_dir / "important.py").write_text("x = 1")
    monkeypatch.setattr(defs, "BASE_DIR", env_dir)
    cfg_mod.configure(str(isolated / "base_new"))
    assert (env_dir / "important.py").is_file()


def test_missing_parent_exits(isolated):
    with pytest.raises(SystemExit):
        cfg_mod.configure(str(isolated / "no" / "such" / "parent" / "base"))


def test_env_override_auto_configure_not_persisted(isolated, monkeypatch):
    env_dir = isolated / "session_base"
    monkeypatch.setenv("TMAT_TPU_BASE_DIR", str(env_dir))
    monkeypatch.setattr(defs, "BASE_DIR", env_dir)
    assert cfg_mod.configure() == env_dir
    assert (env_dir / "config").is_dir() and (env_dir / "model_training").is_dir()
    assert not (isolated / "package.cfg").exists()
    cfg_mod.configure(str(isolated / "chosen_base"))
    assert _recorded(isolated).endswith("chosen_base")


def test_env_override_never_relocates_recorded_base(isolated, monkeypatch):
    recorded = cfg_mod.configure(str(isolated / "real_base"))
    marker = recorded / "model_training" / "user_artifact.txt"
    marker.write_text("keep me")
    env_dir = isolated / "ephemeral" / "session_base"
    env_dir.parent.mkdir()
    monkeypatch.setenv("TMAT_TPU_BASE_DIR", str(env_dir))
    monkeypatch.setattr(defs, "BASE_DIR", env_dir)
    assert cfg_mod.configure() == env_dir
    assert (env_dir / "config").is_dir()
    assert marker.read_text() == "keep me" and _recorded(isolated).endswith("real_base")


def test_port_defs_read_what_configure_records(isolated, monkeypatch):
    """The port's defs read the recorded base dir back."""
    target = cfg_mod.configure(str(isolated / "recorded"))
    monkeypatch.delenv("TMAT_TPU_BASE_DIR", raising=False)
    monkeypatch.setattr(defs, "PKG_CFG_PATH", isolated / "package.cfg")
    assert defs._read_user_base_dir() == target.resolve()


# ---------------------------------------------------------------- gui


class FakeVar:
    """Duck-typed tk.Variable: the only surface TabController touches."""

    def __init__(self, value=""):
        self._value = value

    def get(self):
        return self._value

    def set(self, value):
        self._value = value


def _tab(title):
    return next(t for t in gui.TABS if t.title == title)


def _vars_for(tab, **overrides):
    variables = {}
    for f in tab.fields:
        default = bool(f.default) if f.kind == "bool" else ("" if f.default is None else str(f.default))
        variables[f.name] = FakeVar(overrides.get(f.name, default))
    return variables


def test_tabs_match_the_jax_gui():
    def spec(tabs):
        return [(t.title, t.tool, [dataclasses.astuple(f) for f in t.fields]) for t in tabs]

    assert spec(gui.TABS) == spec(jgui.TABS)
    assert {t.tool for t in gui.TABS} == set(TOOLS.values())


@pytest.mark.parametrize("title", [t.title for t in jgui.TABS])
def test_every_tab_builds_the_jax_namespace(title):
    values = {"in_root": "/a", "out_root": "/b", "channel": "1", "time": "", "image_width_microns": "800",
              "graph_thresh_1": "2 8", "detect_well": True, "tta": "4", "sd_coef": "0.5", "method": "fs",
              "config": "", "model_cfg": "/m.json", "area": False}
    tab, jtab = _tab(title), next(t for t in jgui.TABS if t.title == title)
    assert vars(gui.build_namespace(tab, values)) == vars(jgui.build_namespace(jtab, values))
    assert vars(gui.build_namespace(tab, {})) == vars(jgui.build_namespace(jtab, {}))


def test_zproject_tab_runs_tool_and_reports_status(tmp_path):
    in_dir = tmp_path / "in"
    stack = _slices(in_dir, np.random.RandomState(0), size=48, name="w1")
    out_dir = tmp_path / "out"
    tab = _tab("Z Project")
    statuses = []
    controller = gui.TabController(tab, _vars_for(tab, in_root=str(in_dir), out_root=str(out_dir),
                                                  method="max"), statuses.append, device="cpu")
    controller.launch(join=True)
    assert statuses[0] == "Running Z Project..."
    assert statuses[-1] == "Z Project finished.", statuses
    np.testing.assert_array_equal(np.asarray(Image.open(out_dir / "w1_max.tif")), stack.max(0))


def test_inv_depth_tab_runs_tool(tmp_path, monkeypatch):
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", tmp_path / "nonexistent")
    in_dir = tmp_path / "in"
    _slices(in_dir, np.random.RandomState(1), n=2, size=64)
    tab = _tab("Predict Depth of Invasion")
    statuses = []
    gui.TabController(tab, _vars_for(tab, in_root=str(in_dir), out_root=str(tmp_path / "out")),
                      statuses.append, device="cpu").launch(join=True)
    assert statuses[-1] == "Predict Depth of Invasion finished.", statuses
    with open(tmp_path / "out" / "invasion_depth_predictions.csv") as f:
        assert [r["Z Slice ID"] for r in csv.DictReader(f)] == ["w_z0", "w_z1"]


def test_bad_input_reports_exit_status(tmp_path):
    tab = _tab("Z Project")
    statuses = []
    gui.TabController(tab, _vars_for(tab, in_root=str(tmp_path / "nonexistent"),
                                     out_root=str(tmp_path / "out")), statuses.append,
                      device="cpu").launch(join=True)
    assert statuses[-1].startswith("Z Project exited with code"), statuses


def test_plate_tab_checks_its_namespace(tmp_path):
    """The plate tab's namespace takes the parser's defaults; a missing
    required field or a bad method exits 2, as argparse would."""
    tab = _tab("Process Plate (batch)")
    statuses = []
    gui.TabController(tab, _vars_for(tab, in_root=str(tmp_path), out_root=str(tmp_path / "out")),
                      statuses.append, device="cpu").launch(join=True)
    assert statuses[-1] == "Process Plate (batch) exited with code 2.", statuses
    ns = gui.build_namespace(tab, {"in_root": str(tmp_path), "out_root": str(tmp_path / "o"),
                                   "image_width_microns": "800", "method": "mean"})
    from tmat_torch.tools import plate_pipeline

    with pytest.raises(SystemExit) as exc:
        plate_pipeline.main(args=ns, device="cpu")
    assert exc.value.code == 2


def test_namespace_matches_build_namespace():
    tab = _tab("Analyze Microvessels")
    controller = gui.TabController(
        tab, _vars_for(tab, in_root="/a", out_root="/b", image_width_microns="1000",
                       graph_thresh_1="2 8", detect_well=True, tta="4"), lambda s: None)
    ns = controller.namespace()
    assert isinstance(ns, argparse.Namespace)
    assert (ns.in_root, ns.out_root, ns.image_width_microns) == ("/a", "/b", 1000.0)
    assert ns.graph_thresh_1 == [2.0, 8.0] and ns.detect_well is True and ns.tta == 4


class _Widget:
    """Any ttk widget: takes any arguments, lays out anywhere; a notebook
    records its tabs' titles in ``tabs``."""

    tabs = []

    def __init__(self, *args, **kwargs):
        self.kwargs = kwargs

    def grid(self, **kwargs):
        pass

    def pack(self, **kwargs):
        pass

    def add(self, child, text):
        _Widget.tabs.append(text)


def test_build_app_without_tk():
    """``build_app`` with stand-in Tk modules: one tab and one controller per
    tool tab, each on the device given; a Run button per tab."""
    tk_mod = argparse.Namespace(StringVar=FakeVar, BooleanVar=FakeVar)
    ttk_mod = argparse.Namespace(Notebook=_Widget, Frame=_Widget, Label=_Widget, Entry=_Widget,
                                 Checkbutton=_Widget, Button=_Widget)
    root = argparse.Namespace(title=lambda text: None)
    _Widget.tabs.clear()
    status, controllers = gui.build_app(root, tk_mod, ttk_mod, filedialog_mod=None, device="cpu")
    assert _Widget.tabs == [t.title for t in gui.TABS] == list(controllers)
    assert status.get() == "Ready."
    zproj = controllers["Z Project"]
    assert zproj.device == "cpu" and zproj.variables["method"].get() == "max"
    assert zproj.variables["area"].get() is False
