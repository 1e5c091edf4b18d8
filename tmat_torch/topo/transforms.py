"""Segmentation-mask post-processing of the plate pipeline.

Counterparts in ``tmat_tpu/topo/transforms.py``: the batched disk(2)
median (``_median_filter_disk2_batch``) and ``filter_branch_seg_mask`` on
the path the plate uses (``footprint=None`` with a precomputed skeleton),
which drops components that are too circular or whose skeleton has no
fork, through the native labeling engine.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch.topo import labeling_native


def _disk2() -> np.ndarray:
    y, x = np.mgrid[-2:3, -2:3]
    return x**2 + y**2 <= 4


def median_filter_disk2_batch(x: torch.Tensor) -> torch.Tensor:
    """disk(2) median (13 taps, edge padding) of a (B, H, W) batch."""
    fp = _disk2()
    h, w = x.shape[-2:]
    padded = F.pad(x[:, None], (2, 2, 2, 2), mode="replicate")[:, 0]
    taps = [padded[:, dy : dy + h, dx : dx + w]
            for dy in range(5) for dx in range(5) if fp[dy, dx]]
    return torch.stack(taps).median(dim=0).values


def filter_branch_seg_mask(
    mask: np.ndarray,
    precomputed_skeleton: np.ndarray,
    remove_isolated: bool = True,
) -> np.ndarray:
    """Drop components of an (already median-filtered) mask that are too
    circular (4*pi*area/perimeter^2 > 0.8) or, with ``remove_isolated``,
    whose part of ``precomputed_skeleton`` has no fork."""
    return labeling_native.branch_filter_native(
        np.asarray(mask), precomputed_skeleton, remove_isolated
    )
