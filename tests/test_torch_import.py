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
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
FORBIDDEN = ("jax", "flax", "triton", "msgpack", "networkx", "PIL", "cv2", "tmat_tpu")


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
    assert "tmat_torch.tools.plate_pipeline" in MODULES and "tmat_torch.ops.down_block" in MODULES


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
                # PIL only inside the image loaders, never at module level
                allowed = top == "PIL" and path.name == "io.py" and node.col_offset > 0
                assert top not in FORBIDDEN or allowed, f"{path}: imports {name}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")


@pytest.mark.parametrize("entry", ["resolve_device", "segmentor", "run_plate", "main"])
def test_entry_points_refuse_without_cuda(no_cuda, entry, tmp_path):
    from tmat_torch.device import resolve_device
    from tmat_torch.models.unet import UNetXceptionPatchSegmentor
    from tmat_torch.tools import plate_pipeline

    calls = {
        "resolve_device": lambda: resolve_device(None),
        "segmentor": lambda: UNetXceptionPatchSegmentor(32, tmp_path / "none.msgpack", (8, 16)),
        "run_plate": lambda: plate_pipeline.run_plate(
            np.zeros((1, 1, 8, 8), np.uint8), ["W0"], object(), {"image_width_microns": 1.0}),
        "main": lambda: plate_pipeline.main(
            argv=[str(tmp_path), str(tmp_path / "out"), "--image-width-microns", "800"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")
