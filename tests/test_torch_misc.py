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


def test_default_infer_dtype_and_constants():
    """The CPU's compute dtype is the JAX package's on its CPU; the
    constants of ``core/defs.py`` are the JAX package's."""
    import jax.numpy as jnp

    from tmat_tpu.core import defs as jdefs
    from tmat_tpu.models import default_infer_dtype as jax_default_infer_dtype
    from tmat_torch.core import defs
    from tmat_torch.models import default_infer_dtype

    assert default_infer_dtype("cpu") == torch.float32 and jax_default_infer_dtype() == jnp.float32
    for name in ("MAX_UINT16", "MAX_UINT8", "EPSILON"):
        assert getattr(defs, name) == getattr(jdefs, name) and type(getattr(defs, name)) is type(getattr(jdefs, name))
    assert defs.OUTPUT_DIR == defs.BASE_DIR / "output" and jdefs.OUTPUT_DIR == jdefs.BASE_DIR / "output"
    assert defs.BASE_DIR == jdefs.BASE_DIR


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nx_graph_from_binary_skeleton_equals_jax(seed):
    """Random skeletons (Zhang-Suen of random blobs, plus isolated pixels):
    the same nodes, weighted edges and ``physical_pos``."""
    import numpy as np
    from scipy import ndimage

    from tmat_tpu.topo.transforms import nx_graph_from_binary_skeleton as jax_graph
    from tmat_torch.ops.morphology import skeletonize
    from tmat_torch.topo.transforms import nx_graph_from_binary_skeleton

    rng = np.random.RandomState(seed)
    blobs = ndimage.uniform_filter(rng.rand(48, 53), size=5) > 0.52
    skel = skeletonize(torch.tensor(blobs)).numpy()
    skel[rng.randint(0, 48, 4), rng.randint(0, 53, 4)] = True
    for s in (skel, np.zeros((5, 6), bool)):
        g, ref = nx_graph_from_binary_skeleton(s), jax_graph(s)
        assert sorted(g.nodes) == sorted(ref.nodes)
        assert sorted(g.edges(data="weight")) == sorted(ref.edges(data="weight"))
        np.testing.assert_array_equal(g.graph["physical_pos"], ref.graph["physical_pos"])
    assert g.number_of_nodes() == 0 and len(ref.graph["physical_pos"]) == 0
    g = nx_graph_from_binary_skeleton(skel)
    assert g.number_of_edges() > 20 and {w for *_, w in g.edges(data="weight")} == {1.0, np.sqrt(2)}
