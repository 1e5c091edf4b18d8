"""Native labeling engine: ctypes binding to ``csrc/labeling.cpp``.

Counterpart of ``tmat_tpu/topo/labeling_native.py``, native only: the
library is built with the host C++ compiler at first use, and a failed
build raises instead of falling back to a Python path. ``ccl_label``
numbers components in scipy's raster order; ``region_props`` gives area,
perimeter (skimage's weighted border count), eccentricity and equivalent
diameter per label; ``branch_filter`` is the decision pass of
``filter_branch_seg_mask``; ``drop_small_regions`` is skimage's
``remove_small_objects`` over a label raster.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tmat_torch import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.host_library("labeling")))
    lib.ccl_label.restype = ctypes.c_int64
    lib.ccl_label.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, _I32P]
    lib.region_props.restype = None
    lib.region_props.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                 _F64P, _F64P, _F64P, _F64P]
    lib.branch_filter.restype = ctypes.c_int64
    lib.branch_filter.argtypes = [_U8P, _U8P, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, _U8P]
    lib.drop_small_regions.restype = None
    lib.drop_small_regions.argtypes = [_I32P, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int64]
    return lib


_lib = build.LazyLibrary(_load)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library."""
    return _lib.get()


def label_native(mask: np.ndarray, connectivity: int = 2) -> Tuple[np.ndarray, int]:
    """(int32 labels, n_labels) of a 2-D mask, numbered as scipy.ndimage.label
    numbers them; ``connectivity`` 1 is the cross, 2 the full 3x3."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    m = np.ascontiguousarray(np.asarray(mask) > 0, np.uint8)
    if m.ndim != 2:
        raise ValueError(f"label_native takes a 2-D mask, got shape {m.shape}")
    h, w = m.shape
    labels = np.empty((h, w), np.int32)
    n = load().ccl_label(m.ctypes.data_as(_U8P), h, w, int(connectivity),
                         labels.ctypes.data_as(_I32P))
    return labels, int(n)


def _f64p(a: Optional[np.ndarray]):
    return a.ctypes.data_as(_F64P) if a is not None else None


def region_props_native(labels: np.ndarray, n_labels: int,
                        props: Sequence[str] = ("area", "perimeter")) -> Dict[str, np.ndarray]:
    """Per-region float64 properties (index i is label i + 1) of ``props``,
    among area, perimeter, eccentricity and equivalent_diameter_area."""
    lab = np.ascontiguousarray(labels, np.int32)
    if lab.ndim != 2:
        raise ValueError(f"region_props_native takes a 2-D label raster, got {lab.shape}")
    h, w = lab.shape
    size = max(int(n_labels), 1)
    area = np.zeros(size, np.float64)
    perim = np.zeros(size, np.float64) if "perimeter" in props else None
    ecc = np.zeros(size, np.float64) if "eccentricity" in props else None
    eqd = np.zeros(size, np.float64) if "equivalent_diameter_area" in props else None
    load().region_props(lab.ctypes.data_as(_I32P), h, w, int(n_labels),
                        _f64p(area), _f64p(perim), _f64p(ecc), _f64p(eqd))
    out = {}
    for name, arr in (("area", area), ("perimeter", perim), ("eccentricity", ecc),
                      ("equivalent_diameter_area", eqd)):
        if name in props:
            out[name] = arr[:n_labels]
    return out


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


def remove_small_objects_native(labels: np.ndarray, n_labels: int, min_size: int) -> np.ndarray:
    """``labels`` with the regions of fewer than ``min_size`` pixels zeroed
    (a new array of the input's dtype)."""
    if np.asarray(labels).max(initial=0) > np.iinfo(np.int32).max:
        raise ValueError("remove_small_objects_native takes labels that fit int32")
    out = np.ascontiguousarray(labels, np.int32).copy()
    h, w = out.shape
    load().drop_small_regions(out.ctypes.data_as(_I32P), h, w, int(n_labels), int(min_size))
    return out.astype(labels.dtype, copy=False)
