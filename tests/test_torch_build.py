"""The port's build cache (``tmat_torch/build.py``), on the host libraries.

A library is keyed by its source, its whole command line and the
toolchain, so a change of any of them builds a new one; several processes
that want one library at once produce one build; the directory follows
the argument, then ``TMAT_TORCH_BUILD_DIR``, then the base dir; a failed
build raises and leaves nothing behind. CUDA command lines are checked as
strings here: there is no nvcc.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tmat_torch import build
from tmat_torch.core import defs

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def src(tmp_path):
    path = tmp_path / "k.cu"
    path.write_text("extern \"C\" int f() { return 1; }\n")
    return path


def test_key_follows_source_flags_defines_and_arch(src, monkeypatch):
    base = build.cuda_command("nvcc")
    key = build.library_key(src, base)
    assert build.library_key(src, list(base)) == key  # deterministic
    keys = {key,
            build.library_key(src, build.cuda_command("nvcc", flags=["-fmad=false"])),
            build.library_key(src, build.cuda_command("nvcc", defines=["TMAT_DOWN_BLOCK_PROBE"])),
            build.library_key(src, build.cuda_command("nvcc", defines=["TMAT_DOWN_BLOCK_STEP_PROBE"]))}
    monkeypatch.setattr(build, "CUDA_ARCH_FLAGS", ["-gencode", "arch=compute_80,code=sm_80"])
    keys.add(build.library_key(src, build.cuda_command("nvcc")))
    assert len(keys) == 5
    src.write_text(src.read_text() + "// one more line\n")
    assert build.library_key(src, base) not in keys


def test_key_follows_the_toolchain(src, monkeypatch):
    cmd = build.host_command("g++", native=False)
    key = build.library_key(src, cmd)
    monkeypatch.setitem(build._identities, ("g++", "--version"), "g++ (another) 99.0")
    assert build.library_key(src, cmd) != key
    monkeypatch.undo()
    monkeypatch.setattr(build.torch, "__version__", "0.0.0+other")
    assert build.library_key(src, cmd) != key


def test_cuda_command_line():
    cmd = build.cuda_command("/usr/local/cuda/bin/nvcc", ["A=1"], ["-fmad=false"])
    assert cmd[0] == "/usr/local/cuda/bin/nvcc"
    assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert cmd[-2:] == ["-fmad=false", "-DA=1"]
    assert "-o" not in cmd  # the output is not part of the key


def test_build_dir_follows_argument_env_and_base_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setattr(defs, "BASE_DIR", tmp_path / "base")
    assert build.build_dir() == tmp_path / "base" / ".torch_build"
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "env"))
    assert build.build_dir() == tmp_path / "env"
    assert build.build_dir(str(tmp_path / "arg")) == tmp_path / "arg"
    lib = build.host_library("labeling")
    assert lib.parent == tmp_path / "env" and lib.name.startswith("liblabeling-")


def test_host_library_is_built_once_and_changes_with_its_flags(tmp_path):
    before = build.builds
    first = build.host_library("dmtgraph", directory=str(tmp_path))
    assert build.builds == before + 1 and first.is_file()
    assert build.host_library("dmtgraph", directory=str(tmp_path)) == first
    assert build.builds == before + 1
    src = build.PKG_DIR / "topo" / "csrc" / "dmtgraph.cpp"
    other = build._build("dmtgraph", src, build.host_command("g++", native=False), str(tmp_path))
    assert other != first and other.is_file() and build.builds == before + 2
    assert sorted(p.name for p in tmp_path.glob("*.so")) == sorted([first.name, other.name])


def test_failed_build_raises_and_leaves_no_library(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="building bad.cpp failed"):
        build._build("bad", bad, build.host_command("g++", native=False), str(out))
    assert not [p for p in out.iterdir() if not p.name.endswith(".lock")]


_BUILD_ONE = textwrap.dedent("""
    import sys
    from tmat_torch import build
    path = build.host_library("labeling", directory=sys.argv[1])
    print("BUILT", build.builds, path)
""")


def test_concurrent_processes_build_one_library(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(4)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(out.split("BUILT ", 1)[1].split())
    assert sum(int(n) for n, _ in outs) == 1
    assert len({path for _, path in outs}) == 1
    assert [p.name for p in tmp_path.glob("*.so")] == [Path(outs[0][1]).name]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".lib") and not p.name.endswith(".lock")]
