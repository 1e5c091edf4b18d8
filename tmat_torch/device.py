"""Device and compute-dtype policy of the port's entry points.

``device=None`` means CUDA. Without a CUDA device the entry points raise
unless the caller asked for ``device="cpu"``: they never carry on quietly
on the CPU. The compute dtype is bfloat16 on CUDA and float32 on the CPU
(``tmat_tpu/models/__init__.py::default_infer_dtype``); a model config's
``"dtype"`` key overrides it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on; raises if it is CUDA and
    no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tmat_torch needs a CUDA device; none is available. "
            "Pass device='cpu' to run on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 on CUDA, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def dtype_from_name(name: Optional[str], device: torch.device) -> torch.dtype:
    """A config's ``"dtype"`` name ("float32"/"bfloat16"), else the default."""
    if name is None:
        return default_dtype(device)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]
