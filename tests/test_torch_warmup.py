"""``tmat-torch warmup`` on the CPU, in fresh processes.

Mirrors ``tests/test_warmup.py`` and ``tests/test_cold_start.py``: the
first process fills an empty build cache (the three host libraries; the
CUDA kernels need a card), a second fresh process builds none of them
and its tools write byte-equal outputs, and an unknown tool is refused.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_RUN = textwrap.dedent("""
    import sys
    from tmat_torch import cli
    sys.exit(cli.main(["warmup", *sys.argv[1:]], device="cpu"))
""")


def _warmup(tmp_path, *argv):
    base = tmp_path / "base"
    for sub in ("config", "model_training"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "TMAT_TORCH_BUILD_DIR": str(tmp_path / "build"), "TMAT_TPU_BASE_DIR": str(base),
           "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-c", _RUN, *argv], capture_output=True, text=True, env=env,
                          timeout=600)


def _built(out):
    n, of = re.search(r"(\d+) of (\d+) native libraries built", out).groups()
    return int(n), int(of)


def _digests(out):
    return dict(re.findall(r"(\w+) warmed in [\d.]+s \(outputs sha256 (\w+)\)", out))


def test_warmup_fills_the_cache_and_a_second_process_builds_none(tmp_path):
    argv = ["--size", "48", "--z", "2", "--tools", "zproj", "area", "inv_depth"]
    first = _warmup(tmp_path, *argv)
    assert first.returncode == 0, first.stdout + first.stderr
    assert _built(first.stdout) == (3, 3)
    libs = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    assert [name.split("-")[0] for name in libs] == ["libdmtgraph", "liblabeling", "libmorse"]

    second = _warmup(tmp_path, *argv)
    assert second.returncode == 0, second.stdout + second.stderr
    assert _built(second.stdout) == (0, 3)
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == libs
    assert _digests(first.stdout) == _digests(second.stdout)
    assert set(_digests(first.stdout)) == {"zproj", "area", "inv_depth"}
    # the synthetic inputs and outputs are gone
    assert not list(tmp_path.glob("tmat_warmup_*"))


@pytest.mark.parametrize("argv", [["--tools", "nope"], ["--size", "big"]])
def test_warmup_rejects_bad_arguments(tmp_path, argv):
    proc = _warmup(tmp_path, *argv)
    assert proc.returncode == 2 and "invalid" in proc.stderr
    assert not (tmp_path / "build").exists()
