"""The port's ``compute_branches`` 2-D path against the JAX tool with the
shipped segmentor checkpoint (patch 320, filters 64-512, float32 on the
CPU), and the port's ``--no-vis`` CSVs against the same JAX run. Held to
the outputs of test_torch_tool_branches.py: byte-equal CSVs and
``config.json``, PNGs within one grey level.
"""

import os

from test_torch_tool_branches import _rows, _run_both, _well_image, jax_native_engine  # noqa: F401


def test_main_2d_shipped_checkpoint(tmp_path):
    out = _run_both(tmp_path, _well_image(tmp_path), ["--image-width-microns", "1000"], no_vis_too=True)
    rows = _rows(out / "branching_analysis.csv")
    assert rows[1][0] == "wellA" and int(rows[1][1]) >= 1 and float(rows[1][2]) > 0
    assert {"prediction.png", "segmentation_mask.png", "distance_transform.png", "barcode.png",
            "morse_tree.png", "original_image.png"} <= set(os.listdir(out / "visualizations" / "wellA"))
