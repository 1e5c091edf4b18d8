"""Build the port's native libraries at first use, into a cache kept
between processes.

CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into shared libraries with a plain C interface; the host engines
(``topo/csrc/*.cpp``) with ``g++``. This is the port's counterpart of the
JAX package's compilation and executable caches
(``tmat_tpu/core/compile_cache.py``, ``core/aot_cache.py``): the port
compiles no program at run time, so its cold start is this build.

Each library is kept as ``lib<name>-<key>.so``, where the key hashes what
went into it: the source's bytes, the whole compiler command line
(flags, macros, architecture; what ``-march=native`` means on this host),
the compiler's ``--version``, and the torch and CUDA versions. A change of
any of them builds a new library; nothing is reused on the source's date.
The directory is ``build_dir()``: an explicit argument, else
``TMAT_TORCH_BUILD_DIR``, else ``<base dir>/.torch_build``, so
``tmat-torch configure`` moves it with the models and configs.

A build holds a lock file beside its library, so of several processes
that want one library at once one compiles and the others wait and load
it; the compiler writes a temporary file that is renamed into place, so
nobody loads a half-written library. A failed build raises: nothing
falls back.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR_ENV = "TMAT_TORCH_BUILD_DIR"
CUDA_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
HOST_LIBRARIES = ("labeling", "dmtgraph", "morse")

# compiler output of each library this process built (nvcc's -Xptxas -v lines)
logs: Dict[str, str] = {}
# libraries this process compiled: a cache miss each
builds = 0
_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_identities: Dict[tuple, str] = {}


def build_dir(path: Optional[str] = None) -> Path:
    """Where the libraries are kept: ``path``, else ``TMAT_TORCH_BUILD_DIR``,
    else ``<base dir>/.torch_build``."""
    if path is None:
        path = os.environ.get(BUILD_DIR_ENV)
    if path is None:
        from tmat_torch.core import defs

        path = Path(defs.BASE_DIR) / ".torch_build"
    return Path(path)


def _thread_lock(key: str) -> threading.Lock:
    with _guard:
        return _locks.setdefault(key, threading.Lock())


def _identity(cmd: Sequence[str]) -> str:
    """What a command prints, run once per process: a compiler's version,
    or the target options that ``-march=native`` stands for here."""
    key = tuple(cmd)
    with _guard:
        if key in _identities:
            return _identities[key]
    try:
        proc = subprocess.run(list(cmd), capture_output=True, text=True)
        out = proc.stdout + proc.stderr
    except OSError as exc:  # no such compiler: its build will say so
        out = f"unavailable: {exc}"
    with _guard:
        _identities[key] = out
    return out


def library_key(src: Path, cmd: Sequence[str]) -> str:
    """The cache key of ``src`` compiled by ``cmd`` (the command without
    its output and source): source bytes, command line, compiler identity,
    torch and CUDA versions."""
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for part in (*cmd, _identity([cmd[0], "--version"]),
                 torch.__version__, str(torch.version.cuda)):
        h.update(part.encode() + b"\0")
    if "-march=native" in cmd:
        h.update(_identity([cmd[0], "-march=native", "-Q", "--help=target"]).encode())
    return h.hexdigest()[:20]


def _build(name: str, src: Path, cmd: List[str], directory: Optional[str] = None) -> Path:
    """``lib<name>-<key>.so`` of ``src`` compiled by ``cmd + ["-o", out,
    src]``, from the cache or built now."""
    global builds
    out_dir = build_dir(directory)
    out = out_dir / f"lib{name}-{library_key(src, cmd)}.so"
    with _thread_lock(str(out)):
        if out.exists():
            return out
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f".{out.stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when closed, or when the process dies
            if out.exists():  # another process built it meanwhile
                return out
            tmp = out_dir / f".{out.name}.{os.getpid()}.{threading.get_ident()}"
            proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True, text=True)
            logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {src.name} failed:\n{logs[name]}")
            os.replace(tmp, out)
            with _guard:
                builds += 1
        return out


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


def cuda_command(nvcc: str, defines: Sequence[str] = (), flags: Sequence[str] = ()) -> List[str]:
    """The nvcc command line of a CUDA library, without output and source."""
    return [nvcc, *CUDA_ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", *flags, *(f"-D{d}" for d in defines)]


def cuda_library(name: str, defines: Sequence[str] = (), flags: Sequence[str] = (),
                 directory: Optional[str] = None) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a; returns the library path.
    ``defines`` are preprocessor macros and ``flags`` further nvcc flags of
    this library alone (``-fmad=false`` where a kernel must round as its
    plain version does); each combination is a library of its own."""
    src = PKG_DIR / "csrc" / f"{name}.cu"
    return _build(name, src, cuda_command(nvcc_path(), defines, flags), directory)


def host_command(cxx: str, native: bool) -> List[str]:
    """The C++ command line of a host library, without output and source."""
    return [cxx, "-O3", *(["-march=native"] if native else []), "-funroll-loops", "-std=c++17",
            "-shared", "-fPIC"]


def host_library(name: str, directory: Optional[str] = None) -> Path:
    """Compile ``topo/csrc/<name>.cpp`` with the host C++ compiler, with
    ``-march=native`` where the compiler takes it (the flags of the JAX
    package's build of the same sources)."""
    src = PKG_DIR / "topo" / "csrc" / f"{name}.cpp"
    cxx = os.environ.get("CXX", "g++")
    try:
        return _build(name, src, host_command(cxx, True), directory)
    except RuntimeError:
        return _build(name, src, host_command(cxx, False), directory)


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
