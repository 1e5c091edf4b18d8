"""The port's models: the UNet-Xception segmentor, the ResNet50 invasion
classifier, their trainers and checkpoints (``tmat_tpu/models``)."""

from __future__ import annotations

import torch

from tmat_torch.device import DeviceLike, default_dtype, resolve_device


def default_infer_dtype(device: DeviceLike = None) -> torch.dtype:
    """The inference compute dtype on ``device`` (None = CUDA): bfloat16 on
    CUDA, float32 on the CPU (``device.py``)."""
    return default_dtype(resolve_device(device))
