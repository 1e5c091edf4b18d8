"""The port's ``core/profiling.py::maybe_profile`` and ``core/dev_config.py``
against the JAX package's."""

import json

import pytest
import torch

from tmat_tpu.core import dev_config as jdev
from tmat_tpu.core.profiling import maybe_profile as jax_maybe_profile
from tmat_torch.core import dev_config
from tmat_torch.core.profiling import PROFILE_DIR_ENV, maybe_profile


def test_maybe_profile_noop_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv(PROFILE_DIR_ENV, raising=False)
    monkeypatch.delenv("TMAT_TPU_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_profile("x") as prof, jax_maybe_profile("x"):
        torch.ones(4).sum()
    assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_maybe_profile_writes_a_trace(monkeypatch, tmp_path):
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path))
    with maybe_profile("plate") as prof:
        (torch.arange(64.0) * 2).sum()
    assert prof is not None
    traces = list((tmp_path / "plate").glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names


@pytest.mark.parametrize("base", [None, "given"])
def test_dev_directories_equal_jax(base, tmp_path):
    arg = None if base is None else tmp_path
    assert vars(dev_config.get_dev_directories(arg)) == vars(jdev.get_dev_directories(arg))
    dirs = dev_config.get_dev_directories(tmp_path)
    assert (dirs.data_dir, dirs.analysis_dir, dirs.figures_dir) == (
        tmp_path / "data", tmp_path / "analysis", tmp_path / "figures")
