"""Which card a process takes, and padding a batch to a multiple.

Counterpart of ``tmat_tpu/parallel/mesh.py``. The JAX package lays one
mesh over every process's devices; the port's processes exchange no
tensor (``parallel/distributed.py``), so what remains is the map of a
process to its card and ``pad_to_multiple``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def process_card(local_rank: Optional[int] = None, n_cards: Optional[int] = None) -> int:
    """The card of the process with ``local_rank`` (default ``LOCAL_RANK``,
    else 0) on a host with ``n_cards`` (default: the visible CUDA devices):
    ``local_rank % n_cards``, so more processes than cards share them in turn."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError("no CUDA device to map a process to")
    return local_rank % n_cards


def pad_to_multiple(arr, multiple: int, axis: int = 0):
    """Pad ``axis`` to a multiple of ``multiple`` by repeating the edge;
    returns ``(padded, n_valid)``."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_widths = [(0, 0)] * arr.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(arr, pad_widths, mode="edge"), n
