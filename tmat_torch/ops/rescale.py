"""Intensity rescaling (``tmat_tpu/ops/rescale.py::rescale_intensity``)."""

from __future__ import annotations

import torch


def rescale_intensity(img: torch.Tensor, out_range=(0.0, 1.0), dims=None) -> torch.Tensor:
    """Linear stretch of the image's (min, max) onto ``out_range``, as
    skimage.exposure.rescale_intensity with in_range='image'. A constant
    image maps to out_min. ``dims`` are the image's axes (default: all);
    the leading axes left out are a batch of images, each stretched on
    its own range."""
    img = img.float()
    if dims is None:
        imin, imax = img.min(), img.max()
    else:
        imin = img.amin(dim=dims, keepdim=True)
        imax = img.amax(dim=dims, keepdim=True)
    omin, omax = (float(v) for v in out_range)
    scale = torch.where(
        imax > imin, (omax - omin) / torch.clamp(imax - imin, min=1e-38), torch.zeros_like(imax)
    )
    return (torch.minimum(torch.maximum(img, imin), imax) - imin) * scale + omin
