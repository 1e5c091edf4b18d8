"""Morse-graph branch statistics: ctypes binding to ``csrc/morse.cpp``.

Counterpart of ``tmat_tpu/topo/morse_native.py``, native only: the
library is built at first use; a failed build or a refused input raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from tmat_torch import build
from tmat_torch.topo.dmtgraph import compute_dmt_graph

_I32P = ctypes.POINTER(ctypes.c_int32)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.host_library("morse")))
    lib.morse_analyze.restype = ctypes.c_int64
    lib.morse_analyze.argtypes = [
        _I32P, ctypes.c_int64, _I32P, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    return lib


_lib = build.LazyLibrary(_load)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _lib.get()


def morse_barcode_native(
    img: np.ndarray,
    thresholds: Tuple[float, float] = (1, 4),
    smoothing_window: int = 15,
    min_branch_length: float = 15,
    max_branch_length: Optional[float] = None,
    remove_isolated_branches: bool = False,
    pruning_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Filtered persistence barcode (n_bars, 2) of the Morse skeleton."""
    lib = load()
    verts, edges = compute_dmt_graph(
        np.asarray(img, np.float32), thresholds[0], thresholds[1]
    )
    verts = np.ascontiguousarray(verts, np.int32)
    edges = np.ascontiguousarray(edges, np.int32)
    if len(verts) == 0 or len(edges) == 0:
        return np.zeros((0, 2), np.float64)

    mask_ptr, mask_h, mask_w = None, 0, 0
    if pruning_mask is not None:
        mask = np.ascontiguousarray(pruning_mask > 0, np.uint8)
        mask_ptr = mask.ctypes.data_as(ctypes.c_void_p)
        mask_h, mask_w = mask.shape

    out = np.empty(2 * len(verts), np.float64)
    n_bars = lib.morse_analyze(
        verts.ctypes.data_as(_I32P), len(verts),
        edges.ctypes.data_as(_I32P), len(edges),
        int(smoothing_window), float(min_branch_length),
        float(max_branch_length) if max_branch_length else -1.0,
        1 if remove_isolated_branches else 0,
        mask_ptr, mask_h, mask_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if n_bars < 0:
        raise RuntimeError("morse_analyze refused its input graph")
    return out[: 2 * n_bars].reshape(-1, 2)


def morse_stats_native(img, **kwargs) -> Tuple[int, float, float]:
    """(n_branches, total_len, avg_len) of the filtered barcode."""
    bars = morse_barcode_native(img, **kwargs)
    lengths = bars[:, 1] - bars[:, 0]
    lengths = lengths[~np.isinf(lengths)]
    total = float(np.sum(lengths))
    avg = 0.0 if total == 0 else float(total / len(lengths))
    return len(bars), total, avg
