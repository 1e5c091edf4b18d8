"""Discrete Morse graph: ctypes binding to ``csrc/dmtgraph.cpp``.

Counterpart of ``tmat_tpu/topo/dmtgraph.py``, native only (no NumPy
fallback): the library is built at first use and a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from tmat_torch import build

_I32PP = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.host_library("dmtgraph")))
    lib.dmt_compute_graph.restype = ctypes.c_int
    lib.dmt_compute_graph.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float,
        _I32PP, ctypes.POINTER(ctypes.c_int32),
        _I32PP, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dmt_free.restype = None
    lib.dmt_free.argtypes = [ctypes.c_void_p]
    return lib


_lib = build.LazyLibrary(_load)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _lib.get()


def compute_dmt_graph(
    img: np.ndarray, delta1: float, delta2: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Discrete-Morse graph of a 2-D grayscale image: (vertex positions
    (V, 2) int32, edge index pairs (E, 2) int32)."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError("img must be 2-D grayscale")
    lib = load()
    verts_p = ctypes.POINTER(ctypes.c_int32)()
    edges_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int32()
    n_edges = ctypes.c_int32()
    status = lib.dmt_compute_graph(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), img.shape[0], img.shape[1],
        ctypes.c_float(delta1), ctypes.c_float(delta2),
        ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(edges_p), ctypes.byref(n_edges),
    )
    if status != 0:
        raise RuntimeError(f"dmt_compute_graph failed with status {status}")
    try:
        nv, ne = n_verts.value, n_edges.value
        verts = np.ctypeslib.as_array(verts_p, shape=(max(nv, 1), 2))[:nv].copy()
        edges = np.ctypeslib.as_array(edges_p, shape=(max(ne, 1), 2))[:ne].copy()
    finally:
        lib.dmt_free(verts_p)
        lib.dmt_free(edges_p)
    return verts.astype(np.int32), edges.astype(np.int32)
