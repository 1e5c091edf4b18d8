"""Native component filter: ctypes binding to ``csrc/labeling.cpp``.

Counterpart of ``tmat_tpu/topo/labeling_native.py``, native only: the
library is built with the host C++ compiler at first use, and a failed
build raises instead of falling back to a Python path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tmat_torch import build

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.host_library("labeling")))
    lib.branch_filter.restype = ctypes.c_int64
    lib.branch_filter.argtypes = [_U8P, _U8P, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, _U8P]
    return lib


_lib = build.LazyLibrary(_load)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _lib.get()


def branch_filter_native(
    mask: np.ndarray, skeleton: np.ndarray, remove_isolated: bool
) -> np.ndarray:
    """Label ``mask`` (8-connected), drop components that are too circular
    or whose ``skeleton`` has no fork, in one C call. ``mask`` must hold
    values in 0..255; the result has its dtype."""
    if mask.dtype not in (np.uint8, np.bool_) and mask.max(initial=0) > 255:
        raise ValueError("branch_filter_native takes masks with values in 0..255")
    m = np.ascontiguousarray(mask, np.uint8)
    s = np.ascontiguousarray(np.asarray(skeleton) > 0, np.uint8)
    h, w = m.shape
    out = np.empty((h, w), np.uint8)
    load().branch_filter(m.ctypes.data_as(_U8P), s.ctypes.data_as(_U8P), h, w,
                         1 if remove_isolated else 0, out.ctypes.data_as(_U8P))
    return out.astype(mask.dtype, copy=False)
