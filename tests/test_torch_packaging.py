"""The port's one-dir bundle (``tmat_torch/packaging.py``), the counterpart
of ``tests/test_packaging.py``.

The launchers run the help paths here, which need no card; a tool run on
the card from a bundle is ``chip_smoke.py``'s ``package`` phase.
"""

import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from tmat_torch import packaging

REPO = Path(__file__).resolve().parents[1]


def _env(tmp_path, **extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"TMAT_TPU_BASE_DIR": str(tmp_path / "base"), "TMAT_TORCH_BUILD_DIR": str(tmp_path / "build")})
    env.update(extra)
    return env


def test_bundle_layout(tmp_path):
    out = packaging.build_bundle(tmp_path / "app")
    for rel in ("tmat_torch/cli.py", "tmat_torch/csrc/down_block.cu", "tmat_torch/csrc/focus_stack.cu",
                "tmat_torch/csrc/int8_conv.cu", "tmat_torch/topo/csrc/labeling.cpp",
                "config/default_branching_computation.json",
                "model_training/binary_segmentation/checkpoints/checkpoint_1.msgpack",
                "model_training/binary_segmentation/checkpoints/checkpoint_1.msgpack.quant.json",
                "model_training/binary_segmentation/configs/unet_patch_segmentor_1.json",
                "model_training/best_ensemble/best_finetune_weights_0.msgpack", "README.txt"):
        assert (out / rel).is_file(), rel
    sources = {p.name for p in (REPO / "tmat_torch" / "csrc").glob("*.cu")}
    assert {p.name for p in (out / "tmat_torch" / "csrc").glob("*.cu")} == sources
    for name, _ in packaging.LAUNCHERS:
        assert (out / name).stat().st_mode & stat.S_IXUSR
        assert "TMAT_TORCH_PYTHON" in (out / name).read_text()
    # no built library, cache or user config, and no JAX package
    assert not list(out.rglob("*.so")) and not list(out.rglob("__pycache__"))
    assert not list(out.rglob(".torch_build")) and not (out / "tmat_tpu").exists()
    assert not (out / "runtime").exists()
    readme = (out / "README.txt").read_text()
    assert "nvcc" in readme and "g++" in readme and ".torch_build" in readme and "driver" in readme


def test_bundle_refuses_overwrite(tmp_path, capsys):
    packaging.build_bundle(tmp_path / "app")
    with pytest.raises(FileExistsError):
        packaging.build_bundle(tmp_path / "app")
    (tmp_path / "app" / "stale.txt").write_text("x")
    assert packaging.main([str(tmp_path / "app"), "--force"]) == 0
    assert not (tmp_path / "app" / "stale.txt").exists()
    assert "Bundle written to" in capsys.readouterr().out


def test_launcher_runs_the_cli_help(tmp_path):
    """Through TMAT_TORCH_PYTHON, from another directory, with a bundle path
    holding a space and a quote."""
    out = packaging.build_bundle(tmp_path / "my app's")
    env = _env(tmp_path, TMAT_TORCH_PYTHON=sys.executable)
    for argv, want in ((["--help"], "compute_zproj"), (["compute_zproj", "-h"], "--method")):
        proc = subprocess.run([str(out / "tmat-torch"), *argv], capture_output=True, text=True, env=env,
                              timeout=300, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert want in proc.stdout
    # the bundle's own package answered, not the repo's
    proc = subprocess.run([sys.executable, "-c", "import os, sys; sys.path.insert(0, os.environ['B']); "
                           "import tmat_torch.core.defs as d; print(d.REPO_DIR)"],
                          capture_output=True, text=True, env={**env, "B": str(out)}, cwd=tmp_path, timeout=300)
    assert Path(proc.stdout.strip()) == out


def test_runtime_closure_holds_torch_and_its_requirements():
    dists, missing = packaging.runtime_closure()
    names = {d.metadata["Name"].lower().replace("_", "-") for d in dists}
    assert {"torch", "numpy", "scipy", "pillow", "filelock", "sympy", "mpmath", "jinja2", "markupsafe",
            "fsspec", "networkx", "typing-extensions"} <= names
    assert not {"jax", "jaxlib", "flax", "optax", "pytest"} & names
    assert missing == []


def test_standalone_bundle_runs_without_python_on_path(tmp_path):
    out = tmp_path / "app"
    try:
        packaging.build_bundle(out, standalone=True)
        assert (out / "runtime" / "bin" / "python3").is_file()
        site = out / "runtime" / "site-packages"
        assert (site / "torch" / "__init__.py").is_file() and (site / "numpy").is_dir()
        assert not (site / "jax").exists()
        cleanbin = tmp_path / "cleanbin"
        cleanbin.mkdir()
        for tool in ("bash", "dirname", "env"):
            os.symlink(shutil.which(tool), cleanbin / tool)
        env = {"HOME": str(tmp_path), "PATH": str(cleanbin), "TERM": "dumb",
               "TMAT_TPU_BASE_DIR": str(tmp_path / "base"), "TMAT_TORCH_BUILD_DIR": str(tmp_path / "build")}
        proc = subprocess.run([str(out / "tmat-torch"), "--help"], capture_output=True, text=True, env=env,
                              timeout=600, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "compute_branches" in proc.stdout
    finally:
        shutil.rmtree(out, ignore_errors=True)  # about 1 GB of CPU torch
