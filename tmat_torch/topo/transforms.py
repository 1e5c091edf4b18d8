"""Segmentation-mask post-processing.

Counterparts in ``tmat_tpu/topo/transforms.py``: the footprint median
(``median_filter_footprint``, and the batched disk(2) form of the plate),
the weighted graph of a skeleton (``nx_graph_from_binary_skeleton``, which
imports ``networkx`` when it is called: the card has none),
``filter_branch_seg_mask``, which drops components that are too circular
or whose skeleton has no fork, and ``remove_small_islands``. The medians
and the skeleton run on the tensors' device; labeling and the decisions
run in the native engine, with no Python fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tmat_torch.ops.filters import pad_hw
from tmat_torch.ops.morphology import disk, skeletonize
from tmat_torch.topo import labeling_native
from tmat_torch.topo import regionprops as rp


def median_filter_footprint(img: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """Rank median over ``footprint`` of the trailing (H, W) axes, edge
    padding (skimage.filters.median, mode='nearest'), float32. An even
    number of taps gives the mean of the two middle values, as
    ``jnp.median`` does."""
    fp = np.asarray(footprint) > 0
    kh, kw = fp.shape
    ry, rx = (kh - 1) // 2, (kw - 1) // 2
    h, w = img.shape[-2:]
    padded = pad_hw(img.float(), ry, kh - 1 - ry, rx, kw - 1 - rx, "nearest")
    taps = torch.stack([padded[..., dy : dy + h, dx : dx + w]
                        for dy in range(kh) for dx in range(kw) if fp[dy, dx]])
    n = taps.shape[0]
    if n % 2:
        return taps.median(dim=0).values
    mid = taps.sort(dim=0).values[n // 2 - 1 : n // 2 + 1]
    return mid.mean(dim=0)


def median_filter_disk2_batch(x: torch.Tensor) -> torch.Tensor:
    """disk(2) median (13 taps, edge padding) of a (B, H, W) batch."""
    return median_filter_footprint(x, disk(2))


median_filter_batch = median_filter_disk2_batch


def nx_graph_from_binary_skeleton(skeleton: np.ndarray):
    """The weighted undirected ``networkx`` graph of a 2-D binary skeleton:
    a node per skeleton pixel (numbered in ``np.argwhere`` order, positions
    in ``graph["physical_pos"]``), an edge between 8-neighbours weighted by
    their distance (1 or sqrt(2)), and the pixels with no neighbour as
    isolated nodes."""
    import networkx as nx

    skeleton = np.asarray(skeleton).astype(bool)
    g = nx.Graph()
    node_pos = np.argwhere(skeleton)
    g.graph["physical_pos"] = node_pos
    if len(node_pos) == 0:
        return g
    node_labels = np.full(skeleton.shape, -1)
    node_labels[node_pos[:, 0], node_pos[:, 1]] = np.arange(node_pos.shape[0])
    edge_connected = np.zeros(skeleton.shape, dtype=bool)
    weighted_edges = []

    def shift_2d(arr, pad_vals):
        padded = np.pad(arr, pad_vals)
        pad_bottom, pad_right = pad_vals[0, 1], pad_vals[1, 1]
        h, w = arr.shape
        return padded[pad_bottom : h + pad_bottom, pad_right : w + pad_right]

    # each neighbour direction once: down, right, down-right, down-left
    for shift_rows, shift_cols in [(1, 0), (0, 1), (1, 1), (1, -1)]:
        pad_vals = np.array([[shift_rows == 1, 0], [shift_cols == 1, shift_cols == -1]])
        dest_nodes = skeleton * shift_2d(skeleton, pad_vals)
        if not np.any(dest_nodes):
            continue
        src_nodes = shift_2d(dest_nodes, np.flip(pad_vals, axis=1))
        edge_connected += src_nodes + dest_nodes
        src_ids = node_labels[(node_labels > -1) & src_nodes]
        dest_ids = node_labels[(node_labels > -1) & dest_nodes]
        weight = np.linalg.norm((shift_rows, shift_cols))
        weighted_edges.extend(zip(src_ids, dest_ids, np.full(src_ids.shape, weight)))
    g.add_weighted_edges_from(weighted_edges)

    isolated = skeleton * np.logical_not(edge_connected)
    if np.any(isolated):
        g.add_nodes_from(node_labels[(node_labels > -1) & isolated].tolist())
    return g


def filter_branch_seg_mask(
    mask: np.ndarray,
    footprint: Union[None, str, np.ndarray] = "default",
    remove_isolated: bool = True,
    precomputed_skeleton: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cpu",
) -> np.ndarray:
    """Median-filter a 2-D mask over ``footprint`` (disk(2) by default;
    None: no median), then drop components that are too circular
    (4*pi*area/perimeter^2 > 0.8) or, with ``remove_isolated``, whose
    skeleton has no fork. The median and the Zhang-Suen skeleton run as
    one (1, H, W) batch on ``device``. ``precomputed_skeleton`` is the
    skeleton of a mask already filtered, so it requires ``footprint=None``.
    Returns a new array of the mask's dtype."""
    mask = np.asarray(mask)
    if isinstance(footprint, str):
        if footprint != "default":
            raise ValueError(f"unknown footprint {footprint!r}")
        footprint = disk(2)
    if precomputed_skeleton is not None and footprint is not None:
        raise ValueError(
            "precomputed_skeleton requires footprint=None: the skeleton must "
            "correspond to the mask actually labeled (post-median)"
        )
    if footprint is not None:
        x = torch.from_numpy(mask.astype(np.float32)).to(device)[None]
        med = median_filter_footprint(x, footprint)
        skel = skeletonize(med > 0)[0].cpu().numpy()
        mask = med[0].cpu().numpy().astype(mask.dtype)
    elif precomputed_skeleton is not None:
        skel = np.asarray(precomputed_skeleton)
    else:
        m = torch.from_numpy(np.ascontiguousarray(mask > 0)).to(device)[None]
        skel = skeletonize(m)[0].cpu().numpy()
    return labeling_native.branch_filter_native(mask, skel, remove_isolated)


def remove_small_islands(
    mask: np.ndarray,
    min_area0: int = 100,
    min_area1: int = 100,
    connectivity0: int = 1,
    connectivity1: int = 1,
) -> np.ndarray:
    """Fill holes smaller than ``min_area0``, then drop islands smaller
    than ``min_area1``, of a {0, 1} mask."""
    mask = np.asarray(mask)
    if mask.min() != 0 or mask.max() > 1:
        raise ValueError("this function expects a binary mask of values 0 and 1")
    mask = mask.copy()

    inverse = 1 - mask
    labeled_inv, _ = rp.label(inverse, connectivity=connectivity0)
    labeled_inv = rp.remove_small_objects(labeled_inv, min_area0)
    mask[labeled_inv == 0] = 1

    labeled, _ = rp.label(mask, connectivity=connectivity1)
    labeled = rp.remove_small_objects(labeled, min_area1)
    mask[labeled == 0] = 0
    return mask
