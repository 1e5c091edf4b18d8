"""The port's import rules and device policy.

``tmat_torch`` imports torch, numpy and scipy, never JAX, the JAX package
or a package the card lacks; its entry points run on CUDA unless the
caller passes ``device="cpu"``, and raise when there is no CUDA device.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "tmat_torch"
SHIPPED_CFG = PKG.parent / "model_training/binary_segmentation/configs/unet_patch_segmentor_1.json"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
FORBIDDEN = ("jax", "flax", "triton", "msgpack", "networkx", "PIL", "cv2", "tmat_tpu", "h5py",
             "matplotlib")
# imported only inside the functions that need them (image files, .h5 weights, panels)
LAZY = ("PIL", "h5py", "matplotlib")


def test_modules_import_without_forbidden_packages():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert {"tmat_torch.tools.plate_pipeline", "tmat_torch.ops.down_block", "tmat_torch.ops.focus_stack",
            "tmat_torch.tools.compute_zproj", "tmat_torch.tools.compute_cell_area",
            "tmat_torch.ops.wellmask", "tmat_torch.core.nd2", "tmat_torch.tools.compute_branches",
            "tmat_torch.ops.sato", "tmat_torch.ops.blur", "tmat_torch.topo.morse",
            "tmat_torch.topo.lightgraph", "tmat_torch.topo.regionprops",
            "tmat_torch.core.config", "tmat_torch.models.resnet", "tmat_torch.models.preprocess",
            "tmat_torch.models.synthetic", "tmat_torch.tools.compute_inv_depth", "tmat_torch.cli",
            "tmat_torch.configure", "tmat_torch.gui", "tmat_torch.models.train",
            "tmat_torch.models.train_segmentation", "tmat_torch.models.train_invasion",
            "tmat_torch.models.augment", "tmat_torch.models.data",
            "tmat_torch.models.eval_segmentation", "tmat_torch.models.hp_search",
            "tmat_torch.models.bo", "tmat_torch.models.convert",
            "tmat_torch.models.layers", "tmat_torch.models.quant", "tmat_torch.ops.int8_conv",
            "tmat_torch.packaging"} <= set(MODULES)


def test_front_doors_import_no_jax_triton_or_tk():
    """The CLI, the GUI (Tk only inside ``main``) and the inv_depth tool."""
    front = ["tmat_torch.cli", "tmat_torch.gui", "tmat_torch.tools.compute_inv_depth"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {front!r}: importlib.import_module(m)\n"
        "import tmat_torch.cli as c; c._tool_modules()\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'tmat_tpu', 'triton', 'tkinter', '_tkinter'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_import_of_the_jax_package():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                # PIL, h5py and matplotlib only inside functions, never at module level
                allowed = top in LAZY and node.col_offset > 0
                # Tk only inside the GUI's functions
                assert top != "tkinter" or (path.name == "gui.py" and node.col_offset > 0), path
                assert top not in FORBIDDEN or allowed, f"{path}: imports {name}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")


@pytest.mark.parametrize("entry", ["resolve_device", "segmentor", "run_plate", "main", "zproj_main",
                                   "zproj_project", "cell_area_main", "cell_area_analyze",
                                   "branches_main", "branches_analyze", "inv_depth_main",
                                   "inv_depth_ensemble", "inv_depth_prep", "resnet", "cli", "gui",
                                   "train_segmentation", "train_invasion", "hp_search",
                                   "eval_segmentation", "unet_trainable", "resnet_trainable",
                                   "invasion_data", "quant_calibrate", "quant_pred_fn"])
def test_entry_points_refuse_without_cuda(no_cuda, entry, tmp_path):
    from tmat_torch.device import resolve_device
    from tmat_torch.models.unet import UNetXceptionPatchSegmentor
    from tmat_torch import cli, gui
    from tmat_torch.models.preprocess import prep_inv_depth_imgs_hybrid
    from tmat_torch.models import (data, eval_segmentation, hp_search, quant, train_invasion,
                                   train_segmentation)
    from tmat_torch.models.resnet import build_resnet50_tl, build_trainable_resnet50_tl
    from tmat_torch.models.unet import build_unet_xception
    from tmat_torch.tools import (compute_branches, compute_cell_area, compute_inv_depth, compute_zproj,
                                  plate_pipeline)

    calls = {
        "resolve_device": lambda: resolve_device(None),
        "segmentor": lambda: UNetXceptionPatchSegmentor(32, tmp_path / "none.msgpack", (8, 16)),
        "run_plate": lambda: plate_pipeline.run_plate(
            np.zeros((1, 1, 8, 8), np.uint8), ["W0"], object(), {"image_width_microns": 1.0}),
        "main": lambda: plate_pipeline.main(
            argv=[str(tmp_path), str(tmp_path / "out"), "--image-width-microns", "800"]),
        "zproj_main": lambda: compute_zproj.main(argv=[str(tmp_path), str(tmp_path / "out"), "-m", "fs"]),
        "zproj_project": lambda: compute_zproj.project(np.zeros((2, 8, 8), np.uint8), "fs"),
        "cell_area_main": lambda: compute_cell_area.main(argv=[str(tmp_path), str(tmp_path / "out")]),
        "cell_area_analyze": lambda: compute_cell_area.analyze_images([np.zeros((8, 8), np.uint8)], 0.0),
        "branches_main": lambda: compute_branches.main(argv=[str(tmp_path), str(tmp_path / "out")]),
        "branches_analyze": lambda: compute_branches.analyze_branches(
            np.zeros((2, 8, 8), np.uint8), None, {"image_width_microns": 1.0}),
        "inv_depth_main": lambda: compute_inv_depth.main(argv=[str(tmp_path), str(tmp_path / "out")]),
        "inv_depth_ensemble": lambda: compute_inv_depth.load_ensemble([], (32, 32, 3), "conv4_block6_out"),
        "inv_depth_prep": lambda: prep_inv_depth_imgs_hybrid(np.zeros((2, 8, 8), np.uint8), (4, 4)),
        "resnet": lambda: build_resnet50_tl(1, (32, 32, 3)),
        "cli": lambda: cli.main(["compute_inv_depth", str(tmp_path), str(tmp_path / "out")]),
        "gui": lambda: gui.run_tool(gui.TABS[3], gui.build_namespace(
            gui.TABS[3], {"in_root": str(tmp_path), "out_root": str(tmp_path / "out")})),
        "train_segmentation": lambda: train_segmentation.main([str(tmp_path)]),
        "train_invasion": lambda: train_invasion.main([str(tmp_path)]),
        "hp_search": lambda: hp_search.main([str(tmp_path)]),
        "eval_segmentation": lambda: eval_segmentation.main(
            [str(tmp_path), str(tmp_path / "out"), "--model-cfg", str(SHIPPED_CFG)]),
        "unet_trainable": lambda: build_unet_xception(1, (32, 32), filter_counts=(8, 16)),
        "resnet_trainable": lambda: build_trainable_resnet50_tl(1, (32, 32, 3)),
        "invasion_data": lambda: data.InvasionDataGenerator({0: [], 1: []}, {}, 2, (8, 8),
                                                            np.random.RandomState(0)),
        "quant_calibrate": lambda: quant.calibrate({}, np.zeros((1, 8, 8, 1), np.float32)),
        "quant_pred_fn": lambda: quant.make_quant_pred_fn({}, (8, 16), scales={}),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


def test_missing_member_names_the_port_trainer(tmp_path, monkeypatch, capsys):
    """A missing ensemble checkpoint points the user at the port's trainer."""
    from tmat_torch.core import defs
    from tmat_torch.tools import compute_inv_depth

    (tmp_path / "mt" / "best_ensemble").mkdir(parents=True)
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", tmp_path / "mt")
    (tmp_path / "in").mkdir()
    np.save(tmp_path / "in" / "unused.npy", np.zeros(1))
    with pytest.raises(SystemExit) as exc:
        compute_inv_depth.main(argv=[str(tmp_path / "in"), str(tmp_path / "out")], device="cpu")
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "Ensemble checkpoint not found" in out
    assert "python -m tmat_torch.models.train_invasion" in out and "tmat_tpu" not in out
