"""Numbered patch-segmentor configs (``tmat_tpu/models/registry.py``)."""

from __future__ import annotations

import json
from pathlib import Path

from tmat_torch.core import defs

REQUIRED_KEYS = ["patch_size", "checkpoint_file", "filter_counts"]
OPTIONAL_KEYS = ["ds_ratio", "norm_mean", "norm_std", "channels"]


def _cfg_dir() -> Path:
    return Path(defs.MODEL_TRAINING_DIR) / "binary_segmentation" / "configs"


def get_last_exp_num() -> int:
    """Highest n of the ``unet_patch_segmentor_{n}.json`` configs, in the
    user base dir if it has a config dir, else in the shipped tree."""
    exp_num = 0
    cfg_dir = _cfg_dir()
    if not cfg_dir.is_dir():
        cfg_dir = Path(defs.model_training_path("binary_segmentation")) / "configs"
    if cfg_dir.is_dir():
        for file in cfg_dir.glob("*.json"):
            if file.name.startswith("unet_patch_segmentor_"):
                exp_num = max(exp_num, int(file.stem.split("_")[-1]))
    return exp_num


def save_unet_patch_segmentor_cfg(cfg: dict) -> Path:
    """Write ``cfg`` as the next numbered segmentor config in the user base
    dir and return its path."""
    for key in REQUIRED_KEYS:
        if cfg.get(key) is None:
            raise ValueError(f"Missing required config parameter: {key}")
    for key in cfg:
        if key not in REQUIRED_KEYS and key not in OPTIONAL_KEYS:
            raise ValueError(f"Invalid config parameter: {key}")

    save_dir = _cfg_dir()
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / f"unet_patch_segmentor_{get_last_exp_num() + 1}.json"
    with open(save_path, "w") as fp:
        json.dump(cfg, fp, indent=4)
    return save_path
