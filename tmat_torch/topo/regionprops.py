"""Connected-component labeling and region statistics on the host.

Counterpart of ``tmat_tpu/topo/regionprops.py`` (skimage.measure's
``label``, ``regionprops`` and ``perimeter``, and
``remove_small_objects``). ``label``, ``region_properties`` and
``remove_small_objects`` run in the native engine (``labeling_native``),
native only; ``perimeter`` of one mask keeps the JAX package's NumPy body
(skimage's weighted border count, weights 1 / sqrt(2) / (1 + sqrt(2))/2
from the 10-2-10 neighbour-code convolution).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
from scipy import ndimage

from tmat_torch.topo import labeling_native as ln

_PERIM_WEIGHTS = np.zeros(50)
_PERIM_WEIGHTS[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIM_WEIGHTS[[21, 33]] = math.sqrt(2)
_PERIM_WEIGHTS[[13, 23]] = (1 + math.sqrt(2)) / 2
_PERIM_KERNEL = np.array([[10, 2, 10], [2, 1, 2], [10, 2, 10]])
_ALL_PROPS = ("area", "perimeter", "eccentricity", "equivalent_diameter_area")


def label(mask: np.ndarray, connectivity: int = 2):
    """(int32 labels, n): connectivity 1 = cross, 2 = full 3x3, numbered as
    scipy.ndimage.label numbers them."""
    return ln.label_native(np.asarray(mask), connectivity)


def perimeter(mask: np.ndarray) -> float:
    """skimage.measure.perimeter (4-connectivity border, weighted counts)."""
    image = (np.asarray(mask) > 0).astype(np.uint8)
    strel = ndimage.generate_binary_structure(2, 1)
    eroded = ndimage.binary_erosion(image, strel, border_value=0)
    border = image - eroded.astype(np.uint8)
    perimeter_image = ndimage.convolve(border.astype(np.int32), _PERIM_KERNEL, mode="constant",
                                       cval=0)
    hist = np.bincount(perimeter_image[border > 0].ravel(), minlength=50)[:50]
    return float(hist @ _PERIM_WEIGHTS)


def eccentricity_from_moments(mu20, mu02, mu11) -> float:
    """skimage eccentricity from the central second moments (inertia
    tensor eigenvalues)."""
    t = mu20 + mu02
    d = math.sqrt(max((mu20 - mu02) ** 2 + 4 * mu11**2, 0.0))
    l1 = (t + d) / 2
    l2 = (t - d) / 2
    if l1 == 0:
        return 0.0
    return math.sqrt(max(1 - l2 / l1, 0.0))


def region_properties(labels: np.ndarray, n_labels: int,
                      props: Sequence[str] = _ALL_PROPS) -> Dict[str, np.ndarray]:
    """Per-region area / perimeter / eccentricity / equivalent diameter of
    the requested ``props``; index i of each array is label i + 1."""
    return ln.region_props_native(labels, n_labels, props)


def regionprops_image(mask: np.ndarray, prop: str) -> np.ndarray:
    """A per-region scalar property painted back onto the mask's regions."""
    labels, n = label(mask)
    if n == 0:
        return np.zeros(mask.shape, float)
    values = region_properties(labels, n, props=(prop,))[prop]
    lut = np.concatenate(([0.0], values))
    return lut[labels]


def remove_small_objects(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Zero the labeled regions of fewer than ``min_size`` pixels (skimage
    semantics); ``labels`` is an integer label raster."""
    labels = np.asarray(labels)
    if not np.issubdtype(labels.dtype, np.integer):
        raise TypeError(f"remove_small_objects takes an integer label raster, got {labels.dtype}")
    return ln.remove_small_objects_native(labels, int(labels.max(initial=0)), min_size)
