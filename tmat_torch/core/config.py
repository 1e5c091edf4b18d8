"""Tool config loading with CLI-override merge semantics.

A copy of ``tmat_tpu/core/config.py``: a JSON tool config (``config/*.json``
or the user's copy) merged with argparse flags, where a flag wins when it
was given (not None).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

from tmat_torch.core.log import SFM


def load_tool_config(config_path: Optional[str], default_path: Path) -> Dict[str, Any]:
    """Load a JSON tool config, falling back to the packaged default."""
    path = Path(config_path) if config_path else Path(default_path)
    if not path.is_file():
        print(f"{SFM.failure} Config file {path} does not exist.", flush=True)
        sys.exit(1)
    with open(path, "r", encoding="utf8") as fp:
        return json.load(fp)


def merge_cli_overrides(
    config: Dict[str, Any], args_dict: Dict[str, Any], params: Iterable[str]
) -> Dict[str, Any]:
    """CLI flag wins when provided; otherwise the config key stands.

    A param is written into the config when it is missing from the config
    or the CLI supplied a non-None value.
    """
    for param in params:
        if param not in config or args_dict.get(param) is not None:
            config[param] = args_dict.get(param)
    return config
