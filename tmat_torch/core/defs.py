"""Package constants and the model-artifact path registry.

A copy of what the port needs from ``tmat_tpu/core/defs.py``: the user
base dir (``TMAT_TPU_BASE_DIR``, else ``package.cfg``, else
``~/tmat_tpu``; shared with the JAX package so both read the same user
models), and ``model_training_path`` and ``default_config_path``, which
prefer the user copy of a file over the one shipped in the repo
(``model_training/`` and ``config/``, read where the JAX package reads
them).
"""

from __future__ import annotations

import configparser
import os
from pathlib import Path

import numpy as np

SUPPORTED_IMAGE_FORMATS = ("ND2", "TIF", "TIFF", "OME-TIFF", "PNG")

MAX_UINT16 = np.iinfo(np.uint16).max
MAX_UINT8 = np.iinfo(np.uint8).max
EPSILON = np.finfo(np.float32).eps

PKG_NAME = "tmat_tpu"  # the user base dir and its package.cfg section
REPO_DIR = Path(__file__).resolve().parent.parent.parent
PKG_CFG_PATH = REPO_DIR / "tmat_tpu" / "package.cfg"
PKG_MODEL_DIR = REPO_DIR / "model_training"
PKG_CONFIG_DIR = REPO_DIR / "config"


def _read_user_base_dir() -> Path:
    env = os.environ.get("TMAT_TPU_BASE_DIR")
    if env:
        return Path(env).expanduser()
    cfg = configparser.ConfigParser()
    try:
        cfg.read(PKG_CFG_PATH)
        base = cfg[PKG_NAME]["base_dir"]
        if base.startswith("~"):
            return Path.home().resolve() / base[2:]
        return Path(base)
    except KeyError:
        return Path.home() / PKG_NAME


BASE_DIR = _read_user_base_dir()
MODEL_TRAINING_DIR = BASE_DIR / "model_training"
SCRIPT_CONFIG_DIR = BASE_DIR / "config"
OUTPUT_DIR = BASE_DIR / "output"


def default_config_path(name: str) -> Path:
    """Path of a default tool config, preferring the user copy."""
    user = SCRIPT_CONFIG_DIR / name
    if user.is_file():
        return user
    return PKG_CONFIG_DIR / name


def model_training_path(relpath: str) -> Path:
    """Path under model_training/, preferring the user base dir over the
    files shipped in the repo."""
    user = MODEL_TRAINING_DIR / relpath
    if user.exists():
        return user
    return PKG_MODEL_DIR / relpath
