"""Numbered patch-segmentor configs (``tmat_tpu/models/registry.py::get_last_exp_num``)."""

from __future__ import annotations

from pathlib import Path

from tmat_torch.core import defs


def get_last_exp_num() -> int:
    """Highest n of the ``unet_patch_segmentor_{n}.json`` configs, in the
    user base dir if it has a config dir, else in the shipped tree."""
    exp_num = 0
    cfg_dir = Path(defs.MODEL_TRAINING_DIR) / "binary_segmentation" / "configs"
    if not cfg_dir.is_dir():
        cfg_dir = Path(defs.model_training_path("binary_segmentation")) / "configs"
    if cfg_dir.is_dir():
        for file in cfg_dir.glob("*.json"):
            if file.name.startswith("unet_patch_segmentor_"):
                exp_num = max(exp_num, int(file.stem.split("_")[-1]))
    return exp_num
