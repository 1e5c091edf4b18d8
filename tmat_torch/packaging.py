"""One-dir relocatable application bundle of the port.

Counterpart of ``tmat_tpu/packaging.py``. The bundle holds everything above
the CUDA driver: the ``tmat_torch`` sources (its kernels as ``csrc/*.cu``
and ``topo/csrc/*.cpp``, never a built library), the default configs and
all model artifacts, laid out as in the repo, so that
``core/defs.py::REPO_DIR`` (three levels above ``defs.py``) is the bundle's
root, plus the ``tmat-torch`` and ``tmat-torch-gui`` launchers. The kernels
build from the bundled sources at first use into ``<base dir>/.torch_build``
(``build.py``), so the first run on a machine needs ``nvcc`` and ``g++``; a
machine without them fails that build loudly.

``--standalone`` also embeds the running CPython and the site-packages
closure of the port: the installed distributions that torch, numpy, scipy
and pillow require, followed through their requirements (on a CUDA build of
torch that takes in its ``nvidia-*`` libraries and ``triton``), each copied
file by file from its installed record. The bundle then runs where no
Python is installed.

Usage:
    python -m tmat_torch.packaging OUT_DIR [--force] [--standalone]
"""

from __future__ import annotations

import argparse
import importlib.metadata as metadata
import re
import shutil
import stat
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

from tmat_torch.core import defs

PKG_DIR = Path(__file__).resolve().parent
LAUNCHERS = (("tmat-torch", "tmat_torch.cli"), ("tmat-torch-gui", "tmat_torch.gui"))
# the distributions the port imports; the closure follows their requirements
RUNTIME_ROOTS = ("torch", "numpy", "scipy", "pillow")
# never bundled: compiled libraries, caches, a user's package.cfg
_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "package.cfg", ".torch_build", "_build")

_LAUNCHER = """#!/usr/bin/env bash
# Relocatable launcher. Interpreter preference order:
#   1. TMAT_TORCH_PYTHON (explicit override)
#   2. the bundled standalone runtime (runtime/bin/python3), if present
#   3. the host's python3
# The bundle path travels in the environment, never spliced into code.
HERE="$(cd "$(dirname "${{BASH_SOURCE[0]}}")" && pwd)"
PY="${{TMAT_TORCH_PYTHON:-}}"
if [ -z "$PY" ] && [ -x "$HERE/runtime/bin/python3" ]; then
    PY="$HERE/runtime/bin/python3"
    export PYTHONHOME="$HERE/runtime"
    export LD_LIBRARY_PATH="$HERE/runtime/lib${{LD_LIBRARY_PATH:+:$LD_LIBRARY_PATH}}"
    export PYTHONPATH="$HERE/runtime/site-packages"
fi
PY="${{PY:-python3}}"
TMAT_TORCH_BUNDLE_DIR="$HERE" exec "$PY" -c "
import os
import sys
sys.path.insert(0, os.environ['TMAT_TORCH_BUNDLE_DIR'])
from {module} import main
sys.exit(main() or 0)
" "$@"
"""

_README = """tmat-torch one-dir application bundle
=====================================

Relocatable: move or copy this directory anywhere and run

    ./tmat-torch          # CLI (interactive menu, or ./tmat-torch SUBCOMMAND ...)
    ./tmat-torch-gui      # tkinter GUI

The tools run on an NVIDIA GPU (sm_90a, an H100 or H200): the machine needs
the NVIDIA driver. The CUDA kernels and the host engines ship as sources
(tmat_torch/csrc/*.cu, tmat_torch/topo/csrc/*.cpp) and are built at their
first use into <base dir>/.torch_build (TMAT_TORCH_BUILD_DIR overrides it),
so the first run needs nvcc (the CUDA toolkit; CUDA_HOME, PATH or
/usr/local/cuda) and g++. `./tmat-torch warmup` builds them all at once.

Interpreter: if a runtime/ directory is present (bundle built with
--standalone), the launchers use the embedded CPython and its
site-packages (torch with its CUDA libraries, numpy, scipy, pillow) and the
machine needs no Python. Without runtime/, the host needs Python >= 3.10
with torch (a CUDA build), numpy, scipy and pillow; TMAT_TORCH_PYTHON
chooses the interpreter.

Contents:
    tmat_torch/      package source, kernel sources included
    config/          default tool configs (JSON)
    model_training/  UNet segmentor checkpoint (and its int8 scales),
                     invasion-depth ensemble weights, histories, HP metadata
    runtime/         (--standalone only) embedded CPython + site-packages
"""


def _marker_holds(marker: str) -> bool:
    """Whether a requirement's environment marker holds here; requirements
    of an extra never do."""
    if "extra" in marker:
        return False
    try:
        from packaging.markers import Marker
    except ImportError:  # kept when it cannot be evaluated
        return True
    return Marker(marker).evaluate()


def runtime_closure(roots=RUNTIME_ROOTS) -> Tuple[List[metadata.Distribution], List[str]]:
    """The installed distributions ``roots`` need, through their
    requirements, and the names of required ones not installed."""
    found: Dict[str, metadata.Distribution] = {}
    missing: List[str] = []
    todo = list(roots)
    while todo:
        name = todo.pop()
        key = re.sub(r"[-_.]+", "-", name).lower()
        if key in found or key in missing:
            continue
        try:
            dist = metadata.distribution(name)
        except metadata.PackageNotFoundError:
            missing.append(key)
            continue
        found[key] = dist
        for req in dist.requires or ():
            spec, _, marker = req.partition(";")
            if marker.strip() and not _marker_holds(marker.strip()):
                continue
            todo.append(re.match(r"[A-Za-z0-9._-]+", spec.strip()).group(0))
    return [found[k] for k in sorted(found)], sorted(missing)


def _copy_runtime(out: Path) -> None:
    """Embed the running CPython (binary, libpython, stdlib) in ``runtime/``
    and the port's site-packages closure in ``runtime/site-packages``, which
    the launcher puts on ``PYTHONPATH`` (a distribution's own site layout,
    site-packages or dist-packages, depends on how its Python was built)."""
    import sysconfig

    stdlib = Path(sysconfig.get_paths()["stdlib"])
    runtime = out / "runtime"
    (runtime / "bin").mkdir(parents=True)
    shutil.copy2(Path(sys.executable).resolve(), runtime / "bin" / "python3")
    libdir = runtime / "lib"
    libdir.mkdir()
    # a shared libpython (the launcher puts runtime/lib on LD_LIBRARY_PATH)
    for d in {Path(sys.base_prefix) / "lib", Path(sysconfig.get_config_var("LIBDIR") or sys.base_prefix)}:
        for lib in d.glob("libpython*.so*"):
            if lib.resolve().is_file():
                shutil.copy2(lib.resolve(), libdir / lib.name)
    shutil.copytree(stdlib, libdir / stdlib.name, ignore=shutil.ignore_patterns(
        "__pycache__", "test", "tests", "idlelib", "site-packages", "dist-packages"))

    site = runtime / "site-packages"
    site.mkdir()
    dists, missing = runtime_closure()
    copies = []
    for dist in dists:
        if dist.files is None:  # installed without a record of its files
            missing.append(dist.metadata["Name"])
        for f in dist.files or ():
            rel = str(f)
            if rel.startswith("..") or "__pycache__" in rel or rel.endswith(".pyc"):
                continue
            src = Path(dist.locate_file(f))
            if src.is_file():
                (site / rel).parent.mkdir(parents=True, exist_ok=True)
                copies.append((src, site / rel))
    with ThreadPoolExecutor(8) as pool:  # many files, some of them large
        list(pool.map(lambda pair: shutil.copy2(*pair), copies))
    if missing:
        print(f"runtime packages not found (skipped): {missing}")


def build_bundle(out_dir, force: bool = False, standalone: bool = False) -> Path:
    """Assemble the one-dir bundle; returns its path."""
    out = Path(out_dir).expanduser().resolve()
    if out.exists():
        if not force:
            raise FileExistsError(f"{out} already exists (pass --force to overwrite)")
        shutil.rmtree(out)
    out.mkdir(parents=True)
    shutil.copytree(PKG_DIR, out / "tmat_torch", ignore=_IGNORE)
    for src, name in ((defs.PKG_CONFIG_DIR, "config"), (defs.PKG_MODEL_DIR, "model_training")):
        if Path(src).is_dir():
            shutil.copytree(src, out / name, ignore=_IGNORE)
    if standalone:
        _copy_runtime(out)
    for name, module in LAUNCHERS:
        launcher = out / name
        launcher.write_text(_LAUNCHER.format(module=module))
        launcher.chmod(launcher.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    (out / "README.txt").write_text(_README)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", type=str)
    p.add_argument("--force", action="store_true", help="replace an existing bundle directory")
    p.add_argument("--standalone", action="store_true",
                   help="embed a CPython runtime and the port's site-packages, so that the bundle "
                        "runs on machines with no Python installed")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    out = build_bundle(args.out_dir, force=args.force, standalone=args.standalone)
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"Bundle written to {out} ({size / 1e6:.1f} MB, {size} bytes, "
          f"{time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
