"""UNet-Xception eval forward and the tiled patch segmentor.

Counterparts: ``tmat_tpu/models/unet.py`` (the Flax module and
``UNetXceptionPatchSegmentor``) and the BN-folded forward of
``tmat_tpu/ops/pallas_unet.py::make_fused_pred_fn``, whose rounding
points this forward keeps. Batches are NHWC, as in the JAX package.

The down blocks run through ``ops.down_block`` (the CUDA kernel on a CUDA
tensor). The entry conv, the up path's transpose convs, the 1x1 residuals
and the head are plain PyTorch convolutions and matmuls, as the JAX
package leaves them to XLA. Flax padding conventions kept here:

- ``SAME`` at stride 2 pads (0, 1) on even sizes (TF rule), not (1, 1);
- ``nn.ConvTranspose(3x3, stride 1, SAME)`` without ``transpose_kernel``
  is a plain correlation with the unflipped (kh, kw, in, out) kernel and
  padding (1, 1);
- the up residual is a 1x1 conv followed by a nearest x2 upsample.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmat_torch.core import defs
from tmat_torch.device import DeviceLike, dtype_from_name, resolve_device
from tmat_torch.models.params_io import from_flax_variables, load_variables
from tmat_torch.ops.down_block import BIAS_KEYS, WEIGHT_KEYS, down_block, down_block_plain
from tmat_torch.ops.resize import resize, target_shape_for_ratio
from tmat_torch.ops.tiled import predict_img_with_smooth_windowing


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/Flax SAME padding (before, after) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x: torch.Tensor, k_oihw: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME conv of an NHWC tensor; the result is NHWC-contiguous. The conv
    runs in the channels-last layout (the NCHW view of an NHWC tensor, and
    kernels stored channels-last), so nothing is copied between layouts."""
    kh, kw = k_oihw.shape[-2:]
    (pt, pb), (pl, pr) = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if (pt, pl) == (pb, pr):
        y = F.conv2d(xc, k_oihw, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), k_oihw, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def _pointwise(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1x1 conv with f32 accumulation, rounded once to x's dtype."""
    return (x.float() @ w.float() + b).to(x.dtype)


class UNetXception(nn.Module):
    """Eval-mode UNet-Xception with BatchNorm folded into the convs.

    ``folded`` is ``params_io.from_flax_variables``' output. Weights are
    held in the compute ``dtype``; biases of the down blocks stay float32
    (the kernel adds them to f32 sums).
    """

    def __init__(self, folded: Dict[str, Any], dtype: torch.dtype = torch.float32,
                 output_act: str = "sigmoid"):
        super().__init__()
        self.dtype = dtype
        self.output_act = output_act

        def cast(a, keep_f32=False):
            t = torch.as_tensor(np.ascontiguousarray(a))
            return t.float() if keep_f32 else t.to(dtype)

        def conv_kernel(k_hwio):
            """(kh, kw, in, out) -> OIHW, stored channels-last."""
            k = torch.as_tensor(np.ascontiguousarray(np.transpose(k_hwio, (3, 2, 0, 1))))
            return k.to(dtype).contiguous(memory_format=torch.channels_last)

        self.register_buffer("entry_k", conv_kernel(folded["entry"]["k"]))
        self.register_buffer("entry_b", cast(folded["entry"]["b"]))
        self.n_down = len(folded["down"])
        for i, blk in enumerate(folded["down"]):
            for key, val in blk.items():
                self.register_buffer(f"down{i}_{key}", cast(val, key in BIAS_KEYS))
        self.n_up = len(folded["up"])
        for j, up in enumerate(folded["up"]):
            self.register_buffer(f"up{j}_k1", conv_kernel(up["k1"]))
            self.register_buffer(f"up{j}_b1", cast(up["b1"]))
            self.register_buffer(f"up{j}_k2", conv_kernel(up["k2"]))
            self.register_buffer(f"up{j}_b2", cast(up["b2"]))
            self.register_buffer(f"up{j}_wr", cast(up["wr"]))
            self.register_buffer(f"up{j}_br", cast(up["br"], True))
        self.register_buffer("head_k", conv_kernel(folded["head"]["k"]))
        self.register_buffer("head_b", cast(folded["head"]["b"]))

    def down_weights(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"down{i}_{k}") for k in WEIGHT_KEYS}

    @torch.no_grad()
    def forward(self, batch: torch.Tensor, plain_down: bool = False) -> torch.Tensor:
        """(B, H, W, 1) -> (B, H, W, 1) float32 probabilities.
        ``plain_down`` runs the down blocks' plain PyTorch version instead
        of the kernel, to hold one against the other on the card."""
        block = down_block_plain if plain_down else down_block
        x = batch.to(self.dtype)
        x = torch.relu(_conv_nhwc(x, self.entry_k, 2) + self.entry_b)
        for i in range(self.n_down):
            x = block(x, self.down_weights(i), first=(i == 0))
        for j in range(self.n_up):
            prev = x
            h = torch.relu(x)
            h = _conv_nhwc(h, getattr(self, f"up{j}_k1"), 1) + getattr(self, f"up{j}_b1")
            h = torch.relu(h)
            h = _conv_nhwc(h, getattr(self, f"up{j}_k2"), 1) + getattr(self, f"up{j}_b2")
            r = _pointwise(prev, getattr(self, f"up{j}_wr"), getattr(self, f"up{j}_br"))
            x = _upsample2(h + r)  # = up(h) + up(r): the upsample only copies
        y = (_conv_nhwc(x, self.head_k, 1) + self.head_b).float()
        if self.output_act == "sigmoid":
            y = torch.sigmoid(y)
        elif self.output_act == "softmax":
            y = torch.softmax(y, dim=-1)
        return y


class UNetXceptionPatchSegmentor:
    """Binary segmentation of large images by smooth-blended tiled patches.

    Lanczos downsample by ``ds_ratio``, optional mean/std normalisation,
    spline-window tiling (subdivisions 2, ``tta`` dihedral variants),
    nearest upsample back to the input size. ``device=None`` means CUDA.
    """

    def __init__(
        self,
        patch_size: int,
        checkpoint_file,
        filter_counts: Tuple[int, ...],
        ds_ratio: float = 0.5,
        norm_mean: Optional[float] = None,
        norm_std: Optional[float] = None,
        channels: int = 1,
        dtype: Optional[torch.dtype] = None,
        tta: int = 8,
        device: DeviceLike = None,
    ):
        if checkpoint_file is None:
            raise ValueError("the segmentor needs a checkpoint file")
        self.device = resolve_device(device)
        self.dtype = dtype_from_name(None, self.device) if dtype is None else dtype
        self.patch_size = patch_size
        self.tta = tta
        self.channels = channels
        self.norm_mean = norm_mean
        self.norm_std = norm_std
        self.ds_ratio = ds_ratio
        folded = from_flax_variables(load_variables(checkpoint_file), filter_counts)
        self.model = UNetXception(folded, self.dtype).to(self.device).eval()

    def _pred_fn(self, batch: torch.Tensor) -> torch.Tensor:
        return self.model(batch)

    def predict(self, x: np.ndarray, auto_resample: bool = True) -> np.ndarray:
        img = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        original_shape = tuple(img.shape[:2])
        target_shape = target_shape_for_ratio(original_shape, self.ds_ratio)
        do_resampling = original_shape != target_shape and auto_resample
        if do_resampling:
            img = resize(img, target_shape, "lanczos")
        if self.norm_mean is not None and self.norm_std is not None:
            img = (img - self.norm_mean) / self.norm_std
        pred = predict_img_with_smooth_windowing(
            img, window_size=self.patch_size, subdivisions=2,
            pred_func=self._pred_fn, tta=self.tta,
        )
        if do_resampling:
            pred = resize(pred, original_shape, "nearest")
        return pred.cpu().numpy()


def get_unet_patch_segmentor_from_cfg(
    cfg_json: str, device: DeviceLike = None
) -> UNetXceptionPatchSegmentor:
    """A patch segmentor from a model config JSON. A relative
    ``checkpoint_file`` resolves under the user base dir first, then the
    repo's shipped ``model_training/`` tree."""
    with open(cfg_json, "r") as fp:
        cfg = json.load(fp)
    checkpoint_file = cfg["checkpoint_file"]
    if not Path(checkpoint_file).is_absolute():
        checkpoint_file = defs.model_training_path(
            f"binary_segmentation/checkpoints/{checkpoint_file}"
        )
    dev = resolve_device(device)
    return UNetXceptionPatchSegmentor(
        cfg["patch_size"],
        checkpoint_file,
        tuple(cfg["filter_counts"]),
        ds_ratio=cfg.get("ds_ratio", 1),
        norm_mean=cfg.get("norm_mean", None),
        norm_std=cfg.get("norm_std", None),
        channels=cfg.get("channels", 1),
        dtype=dtype_from_name(cfg.get("dtype"), dev),
        tta=int(cfg.get("tta", 8)),
        device=dev,
    )
