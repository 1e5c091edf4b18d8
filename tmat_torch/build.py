"""Build the port's native libraries at first use, from the package sources.

CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into shared libraries with a plain C interface; the host engines
(``topo/csrc/*.cpp``) with ``g++``. Outputs go to ``tmat_torch/_build/``
(git-ignored) and are rebuilt when the source is newer. Each build writes
a temporary file and renames it into place, so concurrent processes never
load a half-written library. A failed build raises: nothing falls back.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Sequence

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "_build"
CUDA_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# compiler output of the last build of each library (nvcc's -Xptxas -v lines)
logs: Dict[str, str] = {}
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(env)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build(name: str, src: Path, compile_cmd: Callable[[Path], List[str]]) -> Path:
    out = BUILD_DIR / f"lib{name}.so"
    with _lock(name):
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.{threading.get_ident()}.so"
        proc = subprocess.run(compile_cmd(tmp), capture_output=True, text=True)
        logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {src.name} failed:\n{logs[name]}")
        os.replace(tmp, out)
        return out


def cuda_library(name: str, defines: Sequence[str] = (), variant: str = "",
                 flags: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a; returns the library path.
    ``defines`` are preprocessor macros; a build with them is kept apart as
    ``lib<name>_<variant>.so``. ``flags`` are further nvcc flags of this
    library alone (``-fmad=false`` where a kernel must round as its plain
    version does)."""
    src = PKG_DIR / "csrc" / f"{name}.cu"
    return _build(
        f"{name}_{variant}" if variant else name,
        src,
        lambda o: [nvcc_path(), *CUDA_ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags, *(f"-D{d}" for d in defines),
                   "-o", str(o), str(src)],
    )


def host_library(name: str) -> Path:
    """Compile ``topo/csrc/<name>.cpp`` with the host C++ compiler, with
    ``-march=native`` where the compiler takes it (the flags of the JAX
    package's build of the same sources)."""
    src = PKG_DIR / "topo" / "csrc" / f"{name}.cpp"

    def cmd(native: bool):
        return lambda o: [os.environ.get("CXX", "g++"), "-O3", *(["-march=native"] if native else []),
                          "-funroll-loops", "-std=c++17", "-shared", "-fPIC", str(src), "-o", str(o)]

    try:
        return _build(name, src, cmd(True))
    except RuntimeError:
        return _build(name, src, cmd(False))


class LazyLibrary:
    """A ctypes library loaded (and built) on the first ``get()``."""

    def __init__(self, load: Callable):
        self._load = load
        self._lib = None
        self._guard = threading.Lock()

    def get(self):
        with self._guard:
            if self._lib is None:
                self._lib = self._load()
            return self._lib
