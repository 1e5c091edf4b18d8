"""The plate pipeline's building blocks and its two device programs, on one device.

Counterpart of ``tmat_tpu/parallel/plate.py`` without the mesh and the AOT
executable cache: a plate or a chunk of wells is a leading batch axis on
one device, and PyTorch runs the ops eagerly on the current stream.

Building blocks, each a whole (B, ...) plate: ``plate_zproj`` (the five
projections at full depth; ``fs`` is one launch of the focus-stacking
kernel), ``plate_zproj_masked`` (the same over each well's first
``z_counts`` slices), ``plate_threshold`` (rescale, GMM threshold,
binarise) and ``plate_segment`` (the tiled UNet of each well). They run on
``device`` (None = CUDA); a tensor elsewhere is moved there.

Stage 1: Z projection of the whole chunk (``plate_zproj_masked``; focus
stacking is one kernel launch per chunk) or the host's projection,
Lanczos resize to the segmentor's scale, per-well rescale, the GMM area
fraction (``plate_threshold``; of the well's pixels when well masks are
given), the tiled UNet (``plate_segment``: one forward of every patch of a
well), then the disk(2) median,
Zhang-Suen skeleton and bit-packing of the thresholded prediction. The
packed rasters and the areas go to the host; ``preds`` stays on the
device for stage 2.

Stage 2: the two exact EDTs, the centreline weighting
``preds * dist / (dist + centreline_dt)`` and the linear resize.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tmat_torch.core.profiling import StageTimer
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.ops.distance import edt_batch
from tmat_torch.ops.morphology import skeletonize
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import resize
from tmat_torch.ops.threshold import exec_threshold
from tmat_torch.ops.tiled import tiled_core
from tmat_torch.ops.zproj import PROJ_METHODS, proj_focus_stacking_batch, proj_masked_batch
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


packbits_device = packbits  # the JAX package's names
unpackbits_device = unpackbits


def _on(x, device: DeviceLike) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))).to(dev)


def plate_zproj(stacks, method: str = "max", device: DeviceLike = None) -> torch.Tensor:
    """Z-project each stack of a (B, Z, H, W) plate at full depth, as the
    whole-stack projections do (``PROJ_METHODS``): max, min and fs keep the
    stacks' dtype, avg and med are float32 (avg is the sum times the
    reciprocal of the depth, as ``jnp.mean``). ``fs`` is one launch of the
    focus-stacking kernel on CUDA."""
    stacks = _on(stacks, device)
    if method == "fs":
        return proj_focus_stacking_batch(stacks)
    if method not in PROJ_METHODS:
        raise ValueError(f"Unknown projection method: {method}")
    return PROJ_METHODS[method](stacks, axis=1)


def plate_zproj_masked(stacks: torch.Tensor, z_counts: Optional[Sequence[int]] = None,
                       method: str = "max") -> torch.Tensor:
    """float32 projections of a ragged (B, Z, H, W) chunk: ``z_counts``
    mask each well's Z padding out of the reduction (all of Z when None)."""
    return proj_masked_batch(stacks, z_counts, method)


def plate_threshold(imgs, sd_coef: float, masks=None, device: DeviceLike = None) -> torch.Tensor:
    """Each (H, W) image of a (B, H, W) plate rescaled onto [0, 1], zeroed
    outside its mask, zeroed again below its GMM threshold (``sd_coef``;
    pixels outside the mask are left out of the fit) and binarised: uint8
    {0, 1}. ``masks=None`` is a mask of ones."""
    imgs = _on(imgs, device)
    masks = torch.ones_like(imgs, dtype=torch.float32) if masks is None else _on(masks, imgs.device)
    scaled = torch.where(masks > 0, rescale_intensity(imgs, dims=(-2, -1)), 0.0)
    return (exec_threshold(scaled, masks, float(sd_coef)) > 0).to(torch.uint8)


def plate_segment(imgs, pred_func: Callable, window_size: int, subdivisions: int = 2, tta: int = 8,
                  device: DeviceLike = None) -> torch.Tensor:
    """Smooth-blended tiled segmentation of each well of a (B, H, W) plate
    (``ops/tiled.py``: ``tta`` dihedral variants, one ``pred_func`` call on
    all the patches of a well): (B, H, W) float32 probabilities."""
    imgs = _on(imgs, device).float()
    return torch.stack([tiled_core(img, pred_func, window_size, subdivisions, 1, tta) for img in imgs])


def plate_stage1(
    stacks: torch.Tensor,
    pred_func: Callable,
    window_size: int,
    subdivisions: int,
    target: Tuple[int, int],
    sd_coef: float,
    wm_small: Optional[torch.Tensor] = None,
    proj_method: str = "max",
    z_counts: Optional[Sequence[int]] = None,
    pre_projected: bool = False,
    tta: int = 8,
    timer: Optional[StageTimer] = None,
):
    """One chunk of wells through stage 1.

    ``stacks`` is (B, Z, H, W), or (B, H, W) projections when
    ``pre_projected``; ``z_counts`` masks Z padding on ragged plates.
    ``wm_small`` are (B, *target) well masks: the area is then the
    thresholded fraction of the well's pixels and the segmentor sees the
    well only. Returns (area (B,), preds (B, *target) f32, packed filtered
    masks, packed skeletons), all on the stacks' device. ``timer`` times
    the parts as stages ``zproj`` (when it runs), ``resize``,
    ``threshold``, ``segment`` and ``median_skeleton``: host time, as the
    host enqueues them and waits in the GMM's and the skeleton's syncs.
    """
    stage = (timer or StageTimer()).stage
    if pre_projected:
        proj = stacks.float()
    else:
        with stage("zproj"):
            proj = plate_zproj_masked(stacks, z_counts, proj_method)
    with stage("resize"):
        small = rescale_intensity(resize(proj, target, "lanczos"), dims=(-2, -1))
        wm_full = None
        if wm_small is not None:
            wm_small = wm_small.float()
            wm_full = (resize(wm_small, proj.shape[-2:], "nearest") > 0).float()
            small = small * wm_small
    with stage("threshold"):
        thresh = plate_threshold(proj, sd_coef, wm_full, device=proj.device).float()
        if wm_full is None:
            area = thresh.mean(dim=(-2, -1))
        else:
            area = thresh.sum(dim=(-2, -1)) / torch.clamp(wm_full.sum(dim=(-2, -1)), min=1.0)
    with stage("segment"):
        preds = plate_segment(small, pred_func, window_size, subdivisions, tta, device=small.device)
    with stage("median_skeleton"):
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
