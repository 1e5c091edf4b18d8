"""The plate pipeline's two device programs, on one device.

Counterpart of ``tmat_tpu/parallel/plate.py::plate_stage1`` and
``plate_stage2`` without the mesh and the AOT executable cache: a chunk of
wells is a leading batch axis on one device, and PyTorch runs the ops
eagerly on the current stream.

Stage 1: Z projection (or the host's projection), Lanczos resize to the
segmentor's scale, per-well rescale, the GMM area fraction, the tiled
UNet (one forward of every patch of a well), then the disk(2) median,
Zhang-Suen skeleton and bit-packing of the thresholded prediction. The
packed rasters and the areas go to the host; ``preds`` stays on the
device for stage 2.

Stage 2: the two exact EDTs, the centreline weighting
``preds * dist / (dist + centreline_dt)`` and the linear resize.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from tmat_torch.ops.distance import edt_batch
from tmat_torch.ops.morphology import skeletonize
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import resize
from tmat_torch.ops.threshold import exec_threshold
from tmat_torch.ops.tiled import tiled_core
from tmat_torch.ops.zproj import proj_masked
from tmat_torch.topo.transforms import median_filter_disk2_batch

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(x: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., ceil(W/8)) uint8 in ``np.packbits`` bit order."""
    w = x.shape[-1]
    b = x.to(torch.uint8)
    if w % 8:
        b = torch.nn.functional.pad(b, (0, (-w) % 8))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=x.device)
    b = b.reshape(*b.shape[:-1], -1, 8).to(torch.int32)
    return (b * weights).sum(-1).to(torch.uint8)


def unpackbits(packed: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of ``packbits``: (..., W/8) uint8 -> (..., w) bool."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :w].to(torch.bool)


def plate_stage1(
    stacks: torch.Tensor,
    pred_func: Callable,
    window_size: int,
    subdivisions: int,
    target: Tuple[int, int],
    sd_coef: float,
    proj_method: str = "max",
    z_counts: Optional[Sequence[int]] = None,
    pre_projected: bool = False,
    tta: int = 8,
):
    """One chunk of wells through stage 1.

    ``stacks`` is (B, Z, H, W), or (B, H, W) projections when
    ``pre_projected``; ``z_counts`` masks Z padding on ragged plates.
    Returns (area (B,), preds (B, *target) f32, packed filtered masks,
    packed skeletons), all on the stacks' device.
    """
    if pre_projected:
        proj = stacks.float()
    else:
        if z_counts is None:
            z_counts = [stacks.shape[1]] * stacks.shape[0]
        proj = torch.stack([proj_masked(s, int(zc), proj_method)
                            for s, zc in zip(stacks, z_counts)])
    small = rescale_intensity(resize(proj, target, "lanczos"), dims=(-2, -1))
    scaled = rescale_intensity(proj, dims=(-2, -1))
    thresh = exec_threshold(scaled, None, float(sd_coef)) > 0
    area = thresh.float().mean(dim=(-2, -1))
    preds = torch.stack([
        tiled_core(img, pred_func, window_size, subdivisions, 1, tta) for img in small
    ])
    seg = (preds > 0.5).float()
    filtered = median_filter_disk2_batch(seg) > 0.5
    skels = skeletonize(filtered)
    return area, preds, packbits(filtered), packbits(skels)


def plate_stage2(
    preds: torch.Tensor,
    masks: torch.Tensor,
    skels_pre: torch.Tensor,
    dsamp: Tuple[int, int],
) -> torch.Tensor:
    """Centreline-relative distance weighting and downsample.

    ``masks`` are the component-filtered masks and ``skels_pre`` the
    pre-filter skeletons, each bool or bit-packed uint8 (``packbits``).
    Filtering removes whole components, so the filtered skeleton is
    ``skels_pre & masks``. Returns ``preds * dist / (dist + cdt)``
    resized to ``dsamp``.
    """
    w = preds.shape[-1]
    if masks.dtype == torch.uint8 and masks.shape[-1] != w:
        masks = unpackbits(masks, w)
    if skels_pre.dtype == torch.uint8 and skels_pre.shape[-1] != w:
        skels_pre = unpackbits(skels_pre, w)
    masks = masks.to(torch.bool)
    skels = skels_pre.to(torch.bool) & masks
    dist = edt_batch(masks)
    cdt = edt_batch(~skels)
    rel = dist / torch.clamp(dist + cdt, min=1e-12)
    return resize(preds * rel, dsamp, "linear")
