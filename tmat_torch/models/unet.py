"""UNet-Xception: the trainable model, the eval forward and the tiled patch segmentor.

Counterparts: ``tmat_tpu/models/unet.py`` (the Flax module,
``build_unet_xception`` and ``UNetXceptionPatchSegmentor``) and the
BN-folded forward of
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

``TrainableUNetXception`` is the Flax module itself, BatchNorm unfolded
(``layers.BatchNorm``), for training through autograd on these same
helpers and the down block's plain pieces (depthwise conv, TF-SAME max
pool); a trained model reaches inference by ``layers.flax_variables`` ->
``from_flax_variables`` -> ``UNetXception``, and so through the kernel.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmat_torch.core import defs
from tmat_torch.device import DeviceLike, dtype_from_name, resolve_device
from tmat_torch.models.layers import BatchNorm, Conv, init_kernels
from tmat_torch.models.params_io import from_flax_variables, load_variables
from tmat_torch.ops.down_block import (BIAS_KEYS, WEIGHT_KEYS, _depthwise, _maxpool3x3s2, down_block,
                                       down_block_plain)
from tmat_torch.ops.int8_conv import same_pads as _same_pads
from tmat_torch.ops.resize import resize, target_shape_for_ratio
from tmat_torch.ops.tiled import predict_img_with_smooth_windowing


def _conv_nhwc(x: torch.Tensor, k_oihw: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    """SAME conv of an NHWC tensor; the result is NHWC-contiguous. The conv
    runs in the channels-last layout (the NCHW view of an NHWC tensor, and
    kernels stored channels-last), so nothing is copied between layouts."""
    kh, kw = k_oihw.shape[-2:]
    (pt, pb), (pl, pr) = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2)
    if (pt, pl) == (pb, pr):
        y = F.conv2d(xc, k_oihw, stride=stride, padding=(pt, pl), groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), k_oihw, stride=stride, groups=groups)
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
    (the kernel adds them to f32 sums). An up conv's kernel may be None
    where a subclass's ``up_conv`` computes that conv otherwise
    (``models/quant.py::MixedUNetXception``).
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
            if k_hwio is None:
                return None
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

    def up_conv(self, j: int, i: int, h: torch.Tensor) -> torch.Tensor:
        """Up block ``j``'s ``i``-th 3x3 conv (1 or 2) with its bias."""
        return _conv_nhwc(h, getattr(self, f"up{j}_k{i}"), 1) + getattr(self, f"up{j}_b{i}")

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
            h = torch.relu(self.up_conv(j, 1, torch.relu(x)))
            h = self.up_conv(j, 2, h)
            r = _pointwise(prev, getattr(self, f"up{j}_wr"), getattr(self, f"up{j}_br"))
            x = _upsample2(h + r)  # = up(h) + up(r): the upsample only copies
        y = (_conv_nhwc(x, self.head_k, 1) + self.head_b).float()
        if self.output_act == "sigmoid":
            y = torch.sigmoid(y)
        elif self.output_act == "softmax":
            y = torch.softmax(y, dim=-1)
        return y


def check_consec_factor(x: Sequence[float], factor: float) -> bool:
    """Elements increase consecutively by ``factor``."""
    return all(x[i] == x[i - 1] * factor for i in range(1, len(x)))


class SeparableConv(nn.Module):
    """Flax ``SeparableConv``: a bias-free depthwise 3x3 (``(3, 3, 1, C)``)
    and a pointwise 1x1 with bias."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.depthwise = Conv((3, 3, 1, in_ch), bias=False)
        self.pointwise = Conv((1, 1, in_ch, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.depthwise.kernel[:, :, 0, :].reshape(9, -1)
        return _pointwise(_depthwise(x, dw), self.pointwise.kernel[0, 0], self.pointwise.bias)


class TrainableUNetXception(nn.Module):
    """``tmat_tpu.models.unet.UNetXception``, trainable: NHWC float32 in,
    probabilities out; BatchNorm (momentum ``bn_momentum``, eps 1e-3) uses
    batch statistics in train mode and updates its running ones. Submodules
    carry the Flax names in Flax's creation order (``layers``)."""

    def __init__(self, n_outputs: int = 1, filter_counts: Tuple[int, ...] = (32, 64, 128, 256),
                 output_act: str = "sigmoid", bn_momentum: float = 0.99, channels: int = 1):
        super().__init__()
        f = tuple(sorted(filter_counts))
        if not check_consec_factor(f, 2):
            raise ValueError("Filter depths do not increase consecutively by a factor of 2.")
        if output_act not in ("sigmoid", "softmax", "linear"):
            raise ValueError(f"unsupported output activation {output_act!r}")
        self.filter_counts, self.output_act = f, output_act
        self.n_down, self.n_up = len(f) - 1, len(f)
        n = {"Conv": 0, "BatchNorm": 0, "SeparableConv": 0, "ConvTranspose": 0}

        def add(kind, module):
            self.add_module(f"{kind}_{n[kind]}", module)
            n[kind] += 1

        def bn(c):
            add("BatchNorm", BatchNorm(c, bn_momentum, 1e-3))

        add("Conv", Conv((3, 3, channels, f[0])))
        bn(f[0])
        prev = f[0]
        for filters in f[1:]:
            add("SeparableConv", SeparableConv(prev, filters))
            bn(filters)
            add("SeparableConv", SeparableConv(filters, filters))
            bn(filters)
            add("Conv", Conv((1, 1, prev, filters)))
            prev = filters
        for filters in reversed(f):
            add("ConvTranspose", Conv((3, 3, prev, filters)))
            bn(filters)
            add("ConvTranspose", Conv((3, 3, filters, filters)))
            bn(filters)
            add("Conv", Conv((1, 1, prev, filters)))
            prev = filters
        add("Conv", Conv((3, 3, prev, n_outputs)))

    def _layer(self, name: str) -> nn.Module:
        return self._modules[name]

    def _conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        conv = self._layer(name)
        return _conv_nhwc(x, conv.oihw(), stride) + conv.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_down, n_up = self.n_down, self.n_up
        x = torch.relu(self._layer("BatchNorm_0")(self._conv(x.float(), "Conv_0", 2)))
        previous = x
        for i in range(n_down):
            if i:
                x = torch.relu(x)
            x = self._layer(f"SeparableConv_{2 * i}")(x)
            x = torch.relu(self._layer(f"BatchNorm_{1 + 2 * i}")(x))
            x = self._layer(f"SeparableConv_{2 * i + 1}")(x)
            x = _maxpool3x3s2(self._layer(f"BatchNorm_{2 + 2 * i}")(x))
            res = self._layer(f"Conv_{1 + i}")  # 1x1 stride 2: TF-SAME pads nothing
            x = x + _pointwise(previous[:, ::2, ::2], res.kernel[0, 0], res.bias)
            previous = x
        for j in range(n_up):
            bn = 1 + 2 * n_down + 2 * j
            h = self._conv(torch.relu(x), f"ConvTranspose_{2 * j}")
            h = torch.relu(self._layer(f"BatchNorm_{bn}")(h))
            h = self._layer(f"BatchNorm_{bn + 1}")(self._conv(h, f"ConvTranspose_{2 * j + 1}"))
            res = self._layer(f"Conv_{1 + n_down + j}")
            x = _upsample2(h + _pointwise(previous, res.kernel[0, 0], res.bias))
            previous = x
        y = self._conv(x, f"Conv_{1 + n_down + n_up}")
        if self.output_act == "sigmoid":
            return torch.sigmoid(y)
        if self.output_act == "softmax":
            return torch.softmax(y, dim=-1)
        return y


def build_unet_xception(
    n_outputs: int,
    img_shape: Tuple[int, int],
    channels: int = 1,
    filter_counts: Tuple[int, ...] = (32, 64, 128, 256),
    output_act: str = "sigmoid",
    seed: int = 0,
    bn_momentum: float = 0.99,
    device: DeviceLike = None,
) -> TrainableUNetXception:
    """The trainable UNet on ``device`` (None = CUDA), initialised as Flax
    initialises it (lecun-normal kernels drawn from ``torch.Generator``
    seeded with ``seed``, zero biases, BN scale 1, statistics 0 / 1).
    ``img_shape`` (the patch size) must be divisible by 2**len(filter_counts)."""
    dev = resolve_device(device)
    h, w = img_shape
    if h % 2 ** len(filter_counts) or w % 2 ** len(filter_counts):
        raise ValueError(f"patch {img_shape} is not divisible by 2**{len(filter_counts)}")
    model = TrainableUNetXception(n_outputs, tuple(filter_counts), output_act, bn_momentum, channels)
    init_kernels(model, seed)
    return model.to(dev)


class UNetXceptionPatchSegmentor:
    """Binary segmentation of large images by smooth-blended tiled patches.

    Lanczos downsample by ``ds_ratio``, optional mean/std normalisation,
    spline-window tiling (subdivisions 2, ``tta`` dihedral variants),
    nearest upsample back to the input size. ``device=None`` means CUDA.

    ``quantize`` (None reads ``TMAT_TPU_INT8 == "1"``) swaps the forward
    for ``models/quant.py``'s mixed int8 one (``.quantized``): its scales
    come from the checkpoint's sidecar when it matches the checkpoint, else
    from a calibration on the segmentor's device, then saved beside the
    checkpoint where that can be written.
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
        quantize: Optional[bool] = None,
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
        variables = load_variables(checkpoint_file)
        if quantize is None:
            quantize = os.environ.get("TMAT_TPU_INT8", "0") == "1"
        self.quantized = bool(quantize)
        if not self.quantized:
            folded = from_flax_variables(variables, filter_counts)
            self.model = UNetXception(folded, self.dtype).to(self.device).eval()
            return
        from tmat_torch.models import quant

        scales = quant.load_scales_for(checkpoint_file)
        calibrated = scales is None
        # the folded tags follow the model's sorted filter counts
        self.model, scales = quant.make_quant_pred_fn(
            variables, tuple(sorted(filter_counts)), scales=scales, patch_size=patch_size,
            float_dtype=self.dtype, device=self.device)
        if calibrated:
            try:  # best-effort cache next to the checkpoint
                quant.save_scales_for(checkpoint_file, scales)
            except OSError:
                pass

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
        quantize=cfg.get("quantize"),
    )
