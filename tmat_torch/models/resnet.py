"""ResNet50 transfer-learning classifier: inference, and a trainable twin.

Counterpart of ``tmat_tpu/models/resnet.py``: Keras ResNet50 v1 (the
stride on the first 1x1 of a stage's first block, not on the 3x3 as in
torchvision), truncated at a named block output, then global average
pooling, a dense head in float32 and the output activation. Each
convolution carries its batch norm folded in (``params_io.
from_flax_resnet_variables``), so a block is four convolutions with bias.

Padding as Flax has it: conv1 pads 3 and runs 7x7/2; the max pool pads 1
with -inf and runs 3x3/2; the 3x3 convolutions pad 1; a 1x1 stride-2
convolution pads nothing (Flax SAME for a 1x1 kernel, even or odd size).

The base runs in the model's compute dtype (bfloat16 on CUDA, channels
last); the pooled features are cast to float32 for the head, as the JAX
model does. A member loaded on CUDA by the tool
(``tools/compute_inv_depth.py::load_ensemble``) replays its features (the
NHWC view, the cast, the base and the pool) from one CUDA graph of
``GRAPH_BATCH`` slices captured at load, in the memory pool the process's
members share (``models/graphed.py``); the head runs eagerly on the graph's
output. A member built by ``build_resnet50_tl``, and any member on the CPU,
runs eagerly. ``ensemble_forward`` runs k members on one input: the
counterpart of the JAX package's vmapped ``make_ensemble_apply``; it also
runs ``models/swin.py``'s members, and counts each member's graph replays
(``graph_replays``) or eager forward (``eager_forwards``).

``TrainableResNet50TL`` is the Flax module with BatchNorm unfolded, for
training (``models/train.py``): Flax names, layouts and init, float32.
Its base normalises with the running statistics even in train mode (the
JAX base runs ``train=False`` inside), so fine-tuning trains the base's
BN scale and bias but never its statistics; the dense head starts at
zero. A trained member reaches ``load_member`` through its Flax tree
(``layers.flax_variables`` -> ``params_io.from_flax_resnet_variables``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tmat_torch.core.profiling import count
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.graphed import GraphedFeatures
from tmat_torch.models.layers import BatchNorm, Conv, flax_variables, init_kernels
from tmat_torch.models.params_io import RESNET_BN_EPS, from_flax_resnet_variables

BN_EPS = RESNET_BN_EPS

# blocks and filters per stage of ResNet50
_STAGE_BLOCKS = {2: 3, 3: 4, 4: 6, 5: 3}
_STAGE_FILTERS = {2: 64, 3: 128, 4: 256, 5: 512}

LAST_LAYER_OPTIONS = (
    "conv5_block3_out",
    "conv5_block2_out",
    "conv5_block1_out",
    "conv4_block6_out",
)


def _parse_last_layer(name: str) -> Tuple[int, int]:
    """'conv4_block6_out' -> (4, 6)."""
    parts = name.split("_")
    stage = int(parts[0][4:])
    block = int(parts[1][5:])
    if stage not in _STAGE_BLOCKS or not 1 <= block <= _STAGE_BLOCKS[stage]:
        raise ValueError(f"Unsupported ResNet50 truncation layer: {name}")
    return stage, block


def _block_specs(last_layer: str) -> list:
    """(name, filters, stride, conv_shortcut) of each bottleneck block up to
    ``last_layer``, in order."""
    last_stage, last_block = _parse_last_layer(last_layer)
    out = []
    for stage in range(2, last_stage + 1):
        n_blocks = _STAGE_BLOCKS[stage] if stage < last_stage else last_block
        for block in range(1, n_blocks + 1):
            stride = 1 if (stage == 2 or block > 1) else 2
            out.append((f"conv{stage}_block{block}", _STAGE_FILTERS[stage], stride, block == 1))
    return out


class BottleneckBlock(nn.Module):
    """Keras ResNet v1 bottleneck: 1x1/stride -> 3x3 -> 1x1, with a 1x1
    projection shortcut in a stage's first block."""

    def __init__(self, in_channels: int, filters: int, stride: int, conv_shortcut: bool):
        super().__init__()
        self.conv0 = (nn.Conv2d(in_channels, 4 * filters, 1, stride=stride)
                      if conv_shortcut else None)
        self.conv1 = nn.Conv2d(in_channels, filters, 1, stride=stride)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1)
        self.conv3 = nn.Conv2d(filters, 4 * filters, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.conv0 is None else self.conv0(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        return F.relu(self.conv3(y) + shortcut)


class ResNet50Base(nn.Module):
    """ResNet50 feature extractor truncated at ``last_layer``; NCHW in and out."""

    def __init__(self, last_layer: str = "conv5_block3_out"):
        super().__init__()
        self.last_layer = last_layer
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.blocks = nn.ModuleDict()
        channels = 64
        for name, filters, stride, shortcut in _block_specs(last_layer):
            self.blocks[name] = BottleneckBlock(channels, filters, stride, shortcut)
            channels = 4 * filters
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for block in self.blocks.values():
            x = block(x)
        return x


class ResNet50TL(GraphedFeatures):
    """Truncated ResNet50 + GAP + dense head. Input (B, h, w, 3) float32,
    output (B, n_outputs) float32. ``input_shape`` is the input a captured
    graph takes (``capture``; Keras' default)."""

    def __init__(self, n_outputs: int = 1, last_layer: str = "conv5_block3_out",
                 output_act: str = "sigmoid", input_shape: Tuple[int, int, int] = (224, 224, 3)):
        super().__init__()
        if output_act not in ("sigmoid", "softmax", "linear", None):
            raise ValueError(f"unsupported output activation {output_act!r}")
        self.base = ResNet50Base(last_layer)
        self.head = nn.Linear(self.base.out_channels, n_outputs)
        self.output_act = output_act
        self.input_shape = tuple(input_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.base.conv1.weight.dtype

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 3) -> (B, C) float32: the pooled features, eagerly."""
        # NHWC -> NCHW view: the strides of channels_last, no copy
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        return self.base(x).mean(dim=(2, 3)).float()  # accumulated in float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.head(self.pooled(x))
        if self.output_act == "sigmoid":
            return torch.sigmoid(y)
        if self.output_act == "softmax":
            return torch.softmax(y, dim=-1)
        return y


def _conv_nchw(x: torch.Tensor, conv: Conv, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """A Flax conv (HWIO kernel, bias) on an NHWC tensor, through its NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.oihw(), conv.bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class _TrainableBlock(nn.Module):
    """Flax ``BottleneckBlock``: ``0_conv``/``0_bn`` (the projection
    shortcut of a stage's first block), then ``1_`` .. ``3_`` conv + BN."""

    def __init__(self, in_channels: int, filters: int, stride: int, conv_shortcut: bool):
        super().__init__()
        self.stride = stride
        shapes = {"1": (1, 1, in_channels, filters), "2": (3, 3, filters, filters),
                  "3": (1, 1, filters, 4 * filters)}
        if conv_shortcut:
            shapes = {"0": (1, 1, in_channels, 4 * filters), **shapes}
        for i, shape in shapes.items():
            self.add_module(f"{i}_conv", Conv(shape))
            self.add_module(f"{i}_bn", BatchNorm(shape[-1], eps=RESNET_BN_EPS, use_running_average=True))

    def _unit(self, x: torch.Tensor, i: str, stride: int = 1, padding: int = 0) -> torch.Tensor:
        return self._modules[f"{i}_bn"](_conv_nchw(x, self._modules[f"{i}_conv"], stride, padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self._unit(x, "0", self.stride) if "0_conv" in self._modules else x
        y = F.relu(self._unit(x, "1", self.stride))
        y = F.relu(self._unit(y, "2", padding=1))
        return F.relu(self._unit(y, "3") + shortcut)


class _TrainableBase(nn.Module):
    """Flax ``ResNet50Base``: ``conv1_conv``/``conv1_bn``, then the blocks."""

    def __init__(self, last_layer: str):
        super().__init__()
        self.add_module("conv1_conv", Conv((7, 7, 3, 64)))
        self.add_module("conv1_bn", BatchNorm(64, eps=RESNET_BN_EPS, use_running_average=True))
        channels = 64
        for name, filters, stride, shortcut in _block_specs(last_layer):
            self.add_module(name, _TrainableBlock(channels, filters, stride, shortcut))
            channels = 4 * filters
        self.out_channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self._modules["conv1_bn"](_conv_nchw(x, self._modules["conv1_conv"], 2, 3)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for name, block in self._modules.items():
            if "_block" in name:
                x = block(x)
        return x


class TrainableResNet50TL(nn.Module):
    """``tmat_tpu.models.resnet.ResNet50TL``, trainable: (B, h, w, 3)
    float32 in, (B, n_outputs) out; submodules ``base_model`` and ``head``
    (a Flax ``Dense``: kernel (C, n), bias)."""

    def __init__(self, n_outputs: int = 1, last_layer: str = "conv5_block3_out",
                 output_act: str = "sigmoid"):
        super().__init__()
        if output_act not in ("sigmoid", "softmax", "linear"):
            raise ValueError(f"unsupported output activation {output_act!r}")
        self.output_act = output_act
        self.base_model = _TrainableBase(last_layer)
        self.head = Conv((self.base_model.out_channels, n_outputs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.base_model(x.float()).mean(dim=(1, 2))
        y = feats @ self.head.kernel + self.head.bias
        if self.output_act == "sigmoid":
            return torch.sigmoid(y)
        if self.output_act == "softmax":
            return torch.softmax(y, dim=-1)
        return y


def build_trainable_resnet50_tl(
    n_outputs: int,
    img_shape: Tuple[int, int, int],
    base_last_layer: str = "conv5_block3_out",
    output_act: str = "sigmoid",
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainableResNet50TL:
    """The trainable classifier on ``device`` (None = CUDA), initialised as
    Flax's ``model.init(jax.random.PRNGKey(seed))`` initialises it: the same
    lecun-normal kernels (``layers.init_kernels``, drawn on ``device``), zero
    biases, BN scale 1 and statistics 0 / 1, and a zero head
    (``tmat_tpu/models/resnet.py``: with a random base a random head
    saturates the sigmoid)."""
    if tuple(img_shape)[-1] != 3:
        raise ValueError(f"the classifier takes 3-channel inputs, not {img_shape}")
    dev = resolve_device(device)
    model = TrainableResNet50TL(n_outputs, base_last_layer, output_act).to(dev)
    init_kernels(model, seed, zero=("head.kernel",))
    return model


def build_resnet50_tl(
    n_outputs: int,
    img_shape: Tuple[int, int, int],
    base_last_layer: str = "conv5_block3_out",
    output_act: str = "sigmoid",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    init: str = "random",
    device: DeviceLike = None,
) -> ResNet50TL:
    """The classifier in eval mode on ``device`` (None = CUDA): the base in
    ``dtype`` (channels last on CUDA), the head in float32.

    ``init="random"`` gives it the weights of Flax's ``model.init(
    jax.random.PRNGKey(seed))``: ``build_trainable_resnet50_tl(seed=seed)``'s
    kernels, BatchNorm folded in (``params_io.from_flax_resnet_variables``).
    ``init="zeros"`` draws nothing and sets every weight to 0, for a
    checkpoint to overwrite (``load_member``)."""
    if tuple(img_shape)[-1] != 3:
        raise ValueError(f"the classifier takes 3-channel inputs, not {img_shape}")
    if init not in ("random", "zeros"):
        raise ValueError(f"unknown init {init!r}")
    dev = resolve_device(device)
    model = ResNet50TL(n_outputs, base_last_layer, output_act, img_shape).eval().requires_grad_(False)
    model.to(dev)
    if init == "random":
        # the activation draws nothing: the trainable twin takes no None
        drawn = build_trainable_resnet50_tl(n_outputs, img_shape, base_last_layer, "linear", seed, dev)
        load_member(model, from_flax_resnet_variables(flax_variables(drawn)))
    else:
        for t in model.state_dict().values():
            t.zero_()
    model.base.to(dtype=dtype, memory_format=(torch.channels_last if dev.type == "cuda"
                                              else torch.contiguous_format))
    return model


def load_member(model: ResNet50TL, weights) -> ResNet50TL:
    """Copy a ``from_flax_resnet_variables`` weight map into ``model``,
    each tensor cast to the dtype and layout of the one it replaces."""
    state = model.state_dict()
    missing = set(state) ^ set(weights)
    if missing:
        raise ValueError(f"weights do not fit the model: {sorted(missing)[:6]}")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(torch.as_tensor(weights[name]))
    return model


@torch.no_grad()
def ensemble_forward(members: Sequence[GraphedFeatures], x: torch.Tensor, timer=None) -> torch.Tensor:
    """(k, B, n_outputs) float32: each member (of any backbone: ResNet50TL,
    ``swin.SwinV2TL``) on the same (B, h, w, 3) input, in turn on the
    current stream, counting its graph replays or its eager forward (module
    doc). A member whose class names a ``span`` runs inside that stage of
    ``timer`` (a ``core.profiling.StageTimer``), if one is given."""
    outs = []
    for m in members:
        replays = m.replays(x)
        if replays:
            count("graph_replays", replays)
        else:
            count("eager_forwards")
        span = getattr(m, "span", None)
        if span is None or timer is None:
            outs.append(m(x))
        else:
            with timer.stage(span):
                outs.append(m(x))
    return torch.stack(outs)
