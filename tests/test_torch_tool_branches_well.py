"""The port's ``compute_branches`` with ``-w`` against the JAX tool: a
vessel network inside a bright disc, the shipped segmentor, and the port's
well search with its own unit draws (JAX's) and with the JAX package's
passed in. Held to the outputs of
test_torch_tool_branches.py: byte-equal CSVs and ``config.json``, PNGs
(the well mask among them) within one grey level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from test_tool_branches import _vessel_network_img
from test_torch_tool_branches import _rows, _run_both, jax_native_engine  # noqa: F401
from tmat_torch.ops import wellmask


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(
        wellmask, "unit_draws",
        lambda seed, num_iters=25000: np.asarray(
            jax.random.uniform(jax.random.PRNGKey(seed), (num_iters, 6), jnp.float32)))


def _disc_image(hw=160, seed=0):
    """A vessel network inside a bright disc on a dark frame."""
    img = _vessel_network_img(hw, hw, seed).astype(np.float32)
    rr, cc = np.mgrid[0:hw, 0:hw]
    inside = (rr - hw / 2 - 3) ** 2 + (cc - hw / 2 + 2) ** 2 <= (0.46 * hw) ** 2
    return np.clip(np.where(inside, img * 0.5 + 110, img * 0.2), 0, 255).astype(np.uint8)


def test_main_2d_detect_well(tmp_path, jax_draws):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    Image.fromarray(_disc_image()).save(in_dir / "wellW.tif")
    out = _run_both(tmp_path, in_dir, ["--image-width-microns", "1000", "-w"])
    assert (out / "visualizations" / "wellW" / "well_mask.png").is_file()
    rows = _rows(out / "branching_analysis.csv")
    assert rows[1][0] == "wellW"


def test_main_2d_detect_well_default_draws(tmp_path):
    """``-w`` with the port's own unit draws, nothing patched: the outputs
    of the JAX tool, held as above."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    Image.fromarray(_disc_image()).save(in_dir / "wellD.tif")
    out = _run_both(tmp_path, in_dir, ["--image-width-microns", "1000", "-w"])
    assert (out / "visualizations" / "wellD" / "well_mask.png").is_file()
    assert _rows(out / "branching_analysis.csv")[1][0] == "wellD"
