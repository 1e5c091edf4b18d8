"""plate_max_dense's generator: ``inputs/vessels.py``'s plates, with the
traffic's ``curves`` (low, high) a 320 px field in place of the recipe's
2-6.

The pool's wells take ``vessels.curve_counts(pool_wells, size, low,
high)`` curves (the same spread for every seed, in a seeded order), each
well drawn by ``vessels.vessel_well`` from the seed as ``vessels.
well_pool`` draws it; the plates are ``vessels.plates`` of that pool.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.inputs import vessels


def make(seed: int, traffic: Dict, device="cpu") -> List[np.ndarray]:
    """The traffic's cycle of ``cycle_plates`` plates of ``wells_per_plate``
    wells, from a pool of ``pool_wells`` wells at the traffic's density."""
    n, size = traffic["pool_wells"], traffic["size"]
    counts = vessels.curve_counts(n, size, *traffic["curves"])
    order = vessels.seeded(seed, 0).permutation(n)
    pool = np.stack([vessels.vessel_well(vessels.seeded(seed, 1, i), size, traffic["z"], counts[order[i]], device)
                     for i in range(n)])
    return vessels.plates(pool, seed, traffic["cycle_plates"], traffic["wells_per_plate"], device)
