"""Input preprocessing of the invasion-depth classifier.

Counterpart of ``tmat_tpu/models/preprocess.py``: each slice is resized to
the classifier's input size with Lanczos-4, stretched to its own 0-255
range, repeated to 3 channels, then Keras ``resnet50.preprocess_input``
(caffe mode: RGB->BGR and the ImageNet means subtracted). The SwinV2
members (``models/swin.py``) take the same stretched 3 channels with
torchvision's ImageNet normalisation on [0, 1] instead
(``imagenet_prep_tail``).

``prep_inv_depth_imgs`` does all of it on the device with the jax-lanczos5
resize (``ops/resize.py::resize``). The tool takes the hybrid path: the
true a=4 resize in numpy on the host (``host_resize``), integer slices
rounded and clipped back to their dtype and uploaded in it, and the rest
on the device (``prep_tail``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import resize, resize_lanczos4_host

# Keras caffe-mode ImageNet means, BGR order
_CAFFE_MEAN_BGR = np.array([103.939, 116.779, 123.68], np.float32)
# torchvision's ImageNet mean and std, RGB, on [0, 1]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def resnet50_preprocess(x: torch.Tensor) -> torch.Tensor:
    """Keras resnet50.preprocess_input on (..., 3): RGB->BGR, subtract the
    ImageNet means."""
    x = x.float().flip(-1)
    return x - torch.from_numpy(_CAFFE_MEAN_BGR).to(x.device)


def prep_tail(resized: torch.Tensor) -> torch.Tensor:
    """(Z, h, w) resized slices of any dtype -> (Z, h, w, 3) float32
    classifier inputs: per-slice 0-255 stretch, 3 channels, caffe means."""
    rescaled = rescale_intensity(resized.float(), out_range=(0, 255), dims=(-2, -1))
    return resnet50_preprocess(rescaled[..., None].repeat(1, 1, 1, 3))


@lru_cache(maxsize=None)
def _imagenet_affine(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) of each channel that maps a 0-255 value to its
    normalised one, on ``device`` (made once: no copy to the card a stack)."""
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float64)
    scale = 1.0 / (255.0 * std)
    shift = -torch.tensor(_IMAGENET_MEAN, dtype=torch.float64) / std
    return scale.float().to(device), shift.float().to(device)


def imagenet_prep_tail(resized: torch.Tensor) -> torch.Tensor:
    """(Z, h, w) resized slices of any dtype -> (Z, h, w, 3) float32 SwinV2
    inputs: per-slice 0-255 stretch, 3 channels, each ``(v/255 − mean)/std``."""
    rescaled = rescale_intensity(resized.float(), out_range=(0, 255), dims=(-2, -1))
    scale, shift = _imagenet_affine(rescaled.device)
    return torch.addcmul(shift, rescaled[..., None], scale)


def prep_inv_depth_imgs(images: torch.Tensor, img_hw: Tuple[int, int]) -> torch.Tensor:
    """A (Z, H, W) or (H, W) stack -> (Z, h, w, 3) inputs, all on the
    tensor's device (jax's lanczos5 for the resize)."""
    images = images.float()
    if images.ndim == 2:
        images = images[None]
    return prep_tail(resize(images, tuple(img_hw), "lanczos4"))


def host_resize(images: np.ndarray, img_hw: Tuple[int, int]) -> np.ndarray:
    """The host half of the hybrid prep: (Z, h, w) Lanczos-4 slices, in
    the input's integer dtype (``np.rint``, half to even, then clipped)
    when it has one, else float32; C-contiguous."""
    images = np.asarray(images)
    if images.ndim == 2:
        images = images[None]
    resized = resize_lanczos4_host(images, tuple(img_hw))
    if np.issubdtype(images.dtype, np.integer):
        info = np.iinfo(images.dtype)
        resized = np.clip(np.rint(resized), info.min, info.max).astype(images.dtype)
    return resized


def prep_inv_depth_imgs_hybrid(images, img_hw: Tuple[int, int],
                               device: DeviceLike = None) -> torch.Tensor:
    """``prep_inv_depth_imgs`` with the true Lanczos-4 resize on the host:
    (Z, h, w, 3) float32 inputs on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    return prep_tail(torch.from_numpy(host_resize(images, img_hw)).to(dev))
