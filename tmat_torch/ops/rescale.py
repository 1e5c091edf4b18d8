"""Intensity rescaling and masking (``tmat_tpu/ops/rescale.py``)."""

from __future__ import annotations

import torch


def rescale_intensity(img: torch.Tensor, out_range=(0.0, 1.0), in_range=None, dims=None) -> torch.Tensor:
    """Linear stretch of the image's (min, max), or of ``in_range``, onto
    ``out_range``, as skimage.exposure.rescale_intensity: values are clipped
    to the input range, then mapped linearly. A constant image (an empty
    range) maps to out_min. ``dims`` are the image's axes (default: all);
    the leading axes left out are a batch of images, each stretched on its
    own range (``in_range`` is one range for all)."""
    img = img.float()
    if in_range is not None:
        imin, imax = (torch.tensor(float(v), dtype=torch.float32, device=img.device) for v in in_range)
    elif dims is None:
        imin, imax = img.min(), img.max()
    else:
        imin = img.amin(dim=dims, keepdim=True)
        imax = img.amax(dim=dims, keepdim=True)
    omin, omax = (float(v) for v in out_range)
    scale = torch.where(
        imax > imin, (omax - omin) / torch.clamp(imax - imin, min=1e-38), torch.zeros_like(imax)
    )
    return (torch.minimum(torch.maximum(img, imin), imax) - imin) * scale + omin


def apply_mask(img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``img`` with the pixels where ``mask`` is 0 set to 0."""
    return torch.where(mask == 0, torch.zeros_like(img), img)


def bin_thresh(img: torch.Tensor, img_max, threshold: float = 0.0) -> torch.Tensor:
    """``img_max`` where ``img > threshold``, else 0, in ``img``'s dtype."""
    return torch.where(img > threshold, img_max, 0).to(img.dtype)
