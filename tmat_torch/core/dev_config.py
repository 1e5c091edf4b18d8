"""Developer directory layout for analysis workflows.

A copy of ``tmat_tpu/core/dev_config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from tmat_torch.core import defs


@dataclass
class DevDirs:
    data_dir: Path
    analysis_dir: Path
    figures_dir: Path


def get_dev_directories(base_dir: Path = None) -> DevDirs:
    base = Path(base_dir) if base_dir else defs.BASE_DIR
    return DevDirs(
        data_dir=base / "data",
        analysis_dir=base / "analysis",
        figures_dir=base / "figures",
    )
