"""SwinV2 transfer-learning classifier: a backbone of the invasion-depth
ensemble beside ResNet50.

SwinV2 (Liu et al., "Swin Transformer V2: Scaling Up Capacity and
Resolution", arXiv:2111.09883) as Microsoft's Swin-Transformer repository
publishes it (``configs/swinv2/swinv2_base_patch4_window16_256.yaml``, timm's
``swinv2_base_window16_256``): ``SWINV2_B``. The JAX package has no
counterpart. Layout and equations:

- Patch embedding: ``Conv2d(3, C, 4, stride 4)``, then ``LayerNorm(C)``;
  no absolute position embedding. Tokens are (B, H·W, C), row-major.
- Stage i runs at ``C·2^i`` on a ``(H/4)/2^i`` grid with the window
  ``w = min(window, grid)``; its odd blocks shift by ``w/2`` where the grid
  exceeds the window (at 256²: stages 0-1 shift by 8, 2-3 do not shift).
- Block (res-post-norm): ``x = x + LN1(WA(x))``, ``x = x + LN2(fc2(GELU(
  fc1(x))))``, GELU exact, LayerNorm eps 1e-5.
- Window attention (WA): roll by (−s, −s), partition into w×w windows,
  ``qkv = x·Wqkv + [q_bias, 0, v_bias]``; logits ``(q̂·k̂ᵀ)·exp(min(τ_h,
  ln 100)) + 16·sigmoid(B_h) + M``, q̂ and k̂ L2-normalised over the head
  dim, ``B_h`` the ``cpb_mlp`` (``Linear(2, 512) → ReLU → Linear(512,
  heads)``) of the log-spaced relative coordinates gathered by the
  relative-position index, ``M`` −100 between tokens of different regions
  of a shifted window; softmax, ``·v``, ``proj``, windows reversed and
  rolled back.
- Patch merging: the 2×2 neighbours concatenated as (even, even), (odd,
  even), (even, odd), (odd, odd) by (row, col), ``Linear(4C, 2C)`` without
  bias, then ``LayerNorm(2C)``.
- Head: ``LayerNorm``, the mean over tokens, ``Linear(8C, n_outputs)`` in
  float32 and a sigmoid, as ``resnet.ResNet50TL``'s head. The one
  departure from the published model is this head, the tool's in place of
  ImageNet's 1000 classes.

The base runs in the model's compute dtype (bfloat16 on CUDA). What does
not depend on the input is computed once by ``prepare`` (span
``swin_tables``, one ``cpb_tables`` count a block), as BatchNorm folding is
for ResNet50: each block's ``16·sigmoid(B)`` table gathered over the
window, less its mean per head (a constant does not change a softmax, and
bfloat16 keeps the rest of a table near 8 only to 1/16), plus the shift
mask, as one additive table; the logit scales; ``[q_bias, 0, v_bias]``;
the roll and window partition as one token permutation and its inverse.
``prepare`` writes the tables into their buffers in place: call it again
after changing weights.

Attention goes through the module-level ``window_attention``, which the
blocks look up at call time. It runs ``F.scaled_dot_product_attention`` with
the table as ``attn_mask`` (contiguous: the fused kernels take no other),
the windows' heads as the heads of one image so that the table broadcasts
over the batch. Flash attention takes no additive mask; PyTorch 2.11 takes
cuDNN's fused attention for bfloat16 on the H100, else the memory-efficient
kernel, else its math path.

A member loaded on CUDA (``load_member``, the tool's path) replays its
features (all but the head) from one CUDA graph of ``GRAPH_BATCH`` slices,
captured at load, in the memory pool the process's members share
(``models/graphed.py``, as the ResNet50 members do): the host launches a
copy, a graph and the head instead of ~900 kernels. The blocks' Python (and
``window_attention``) runs only while capturing. Each replay, or an eager
forward (the CPU, or a member built and not captured), counts
``attn_calls`` (its blocks) and ``attn_windows`` (the windows its blocks
pass through the attention, spare rows included) (``core/profiling.py``);
a member's forward is the stage ``swin_forward`` of the timer
``resnet.ensemble_forward`` is given.

Checkpoints are ``torch.save`` of the module's state dict
(``save_member``), which keeps each block's ``relative_position_index`` as
the published checkpoints do; ``load_member`` reads the sizes back from its
shapes (``arch_of``), so a checkpoint of any size of the family loads.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tmat_torch.core.profiling import StageTimer, count
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.graphed import GRAPH_BATCH, GraphedFeatures  # noqa: F401 (GRAPH_BATCH re-exported)

BACKBONE = "swinv2_base_window16_256"
SWINV2_B = {"patch": 4, "embed_dim": 128, "depths": (2, 2, 18, 2), "heads": (4, 8, 16, 32), "window": 16,
            "mlp_ratio": 4, "cpb_hidden": 512}
LN_EPS = 1e-5
MASK = -100.0  # the shift mask's logit between tokens of different regions
MAX_LOGIT_SCALE = math.log(100.0)
INIT_STD = 0.02  # seeded weights: truncated normal (timm's cut at ±2), as the published init


def relative_coords_table(window: int) -> torch.Tensor:
    """(2w−1, 2w−1, 2) float32: relative coordinates in [−(w−1), w−1]²,
    divided by w−1, times 8, mapped by sign(t)·log2(|t|+1)/log2(8)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1) / (window - 1) * 8
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)


def relative_position_index(window: int) -> torch.Tensor:
    """(w², w²) int64: the table row of each (query, key) pair of a window."""
    ij = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")).flatten(1)
    rel = (ij[:, :, None] - ij[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """(nW, w², w²) float32: 0 within a region of the rolled grid, −100
    across regions."""
    regions = torch.zeros(grid, grid)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for n, (hs, ws) in enumerate((hs, ws) for hs in cuts for ws in cuts):
        regions[hs, ws] = n
    g = grid // window
    win = regions.view(g, window, g, window).transpose(1, 2).reshape(g * g, window * window)
    return torch.where(win[:, None, :] != win[:, :, None], MASK, 0.0)


def window_order(grid: int, window: int, shift: int) -> torch.Tensor:
    """(grid²,) int64: the row-major token at each place of the rolled and
    window-partitioned grid (windows in row-major order, then their tokens)."""
    idx = torch.roll(torch.arange(grid * grid).view(grid, grid), (-shift, -shift), (0, 1))
    g = grid // window
    return idx.view(g, window, g, window).transpose(1, 2).reshape(-1)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], scale: torch.Tensor) -> torch.Tensor:
    """Scaled cosine attention inside windows: ``softmax((q̂·k̂ᵀ)·scale + bias
    + mask)·v`` with q̂, k̂ L2-normalised over the head dim.

    ``q``, ``k``, ``v``: (B·nW, heads, N, d), an image's nW windows in a
    row; ``bias``: (nW or 1, heads, N, N); ``mask``: None or (nW, N, N);
    ``scale``: (heads,). Returns (B·nW, heads, N, d)."""
    if mask is not None:
        bias = bias + mask[:, None]
    n_w, (bw, heads, n, d) = bias.shape[0], q.shape
    # an image's windows as heads, so that the table broadcasts over images
    shape = (bw // n_w, n_w * heads, n, d)
    qn = F.normalize(q, dim=-1).mul_(scale.view(-1, 1, 1)).reshape(shape)
    kn = F.normalize(k, dim=-1).reshape(shape)
    out = F.scaled_dot_product_attention(qn, kn, v.reshape(shape), attn_mask=bias.reshape(1, n_w * heads, n, n),
                                         scale=1.0)
    return out.reshape(bw, heads, n, d)  # a copy only where the kernel strides its output otherwise (float32)


class WindowAttention(nn.Module):
    """SwinV2's window attention of one block (module doc); ``shift_mask``
    is the block's, or None."""

    def __init__(self, dim: int, heads: int, window: int, cpb_hidden: int,
                 mask: Optional[torch.Tensor] = None):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, cpb_hidden), nn.ReLU(), nn.Linear(cpb_hidden, heads, bias=False))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.register_buffer("shift_mask", mask, persistent=False)
        n = window * window
        n_w = 1 if mask is None else mask.shape[0]
        # prepare()'s tables
        self.register_buffer("qkv_bias", torch.zeros(3 * dim), persistent=False)
        self.register_buffer("bias", torch.zeros(n_w, heads, n, n), persistent=False)
        self.register_buffer("scale", torch.zeros(heads), persistent=False)

    @torch.no_grad()
    def prepare(self) -> None:
        """The tables that do not depend on the input, computed in float32
        and kept in the weights' dtype (module doc)."""
        mlp0, mlp2 = self.cpb_mlp[0], self.cpb_mlp[2]
        coords = relative_coords_table(self.window).to(mlp0.weight.device)
        hidden = F.relu(F.linear(coords, mlp0.weight.float(), mlp0.bias.float()))
        table = F.linear(hidden, mlp2.weight.float()).view(-1, self.heads)
        n = self.window * self.window
        bias = 16 * torch.sigmoid(table[self.relative_position_index.view(-1)].view(n, n, -1).permute(2, 0, 1))
        bias = bias - bias.mean(dim=(1, 2), keepdim=True)
        if self.shift_mask is not None:
            bias = bias[None] + self.shift_mask.float()[:, None]
        # in place, where a captured graph reads them; contiguous: the fused
        # attention kernels take a mask only with a unit last stride
        self.bias.copy_(bias.reshape(self.bias.shape))
        self.scale.copy_(torch.clamp(self.logit_scale.float(), max=MAX_LOGIT_SCALE).exp().view(-1))
        self.qkv_bias.copy_(torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bw, n, c = x.shape
        qkv = F.linear(x, self.qkv.weight, self.qkv_bias)
        q, k, v = qkv.view(bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = window_attention(q, k, v, self.bias, None, self.scale)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One res-post-norm block on a ``grid``² token grid."""

    def __init__(self, dim: int, heads: int, grid: int, window: int, shift: int, mlp_ratio: int,
                 cpb_hidden: int):
        super().__init__()
        self.window, self.shift = window, shift
        mask = shift_mask(grid, window, shift) if shift else None
        self.attn = WindowAttention(dim, heads, window, cpb_hidden, mask)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        order = window_order(grid, window, shift)
        self.register_buffer("order", order, persistent=False)
        self.register_buffer("unorder", torch.argsort(order), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        windows = torch.index_select(x, 1, self.order).view(-1, self.window * self.window, c)
        y = torch.index_select(self.attn(windows).view(b, l, c), 1, self.unorder)
        x = x + self.norm1(y)
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated in the published order, reduced, then
    normalised."""

    def __init__(self, dim: int, grid: int):
        super().__init__()
        self.grid = grid
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, self.grid // 2, 2, self.grid // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.norm(self.reduction(x.view(b, -1, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)  # NCHW
        return self.norm(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1]))


class SwinV2TL(GraphedFeatures):
    """SwinV2 backbone + GAP + dense head. Input (B, h, w, 3) float32,
    output (B, n_outputs) float32 probabilities; ``logits`` before the
    sigmoid."""

    span = "swin_forward"  # the stage a member's forward is in ``resnet.ensemble_forward``

    def __init__(self, img_size: int = 256, patch: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2), heads: Sequence[int] = (4, 8, 16, 32),
                 window: int = 16, mlp_ratio: int = 4, cpb_hidden: int = 512, n_outputs: int = 1):
        super().__init__()
        self.patch_embed = PatchEmbed(patch, embed_dim)
        grid, stages = img_size // patch, []
        for i, (depth, n_heads) in enumerate(zip(depths, heads)):
            dim, w = embed_dim * 2**i, min(window, grid)
            blocks = [SwinBlock(dim, n_heads, grid, w, w // 2 if j % 2 and grid > w else 0, mlp_ratio, cpb_hidden)
                      for j in range(depth)]
            stages.append(SwinStage(blocks, PatchMerging(dim, grid) if i < len(depths) - 1 else None))
            grid //= 2
        self.layers = nn.ModuleList(stages)
        self.out_channels = embed_dim * 2 ** (len(depths) - 1)
        self.norm = nn.LayerNorm(self.out_channels, eps=LN_EPS)
        self.head = nn.Linear(self.out_channels, n_outputs)
        # an image's windows through the attention, over all blocks
        self.n_blocks = len(self.blocks())
        self.windows_per_image = sum(blk.order.numel() // blk.window**2 for blk in self.blocks())
        self.input_shape = (img_size, img_size, 3)

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed.proj.weight.dtype

    def blocks(self):
        return [blk for stage in self.layers for blk in stage.blocks]

    def prepare(self, timer: Optional[StageTimer] = None) -> "SwinV2TL":
        """Every block's input-independent tables (module doc)."""
        with (timer or StageTimer()).stage("swin_tables"):
            for blk in self.blocks():
                blk.attn.prepare()
                count("cpb_tables")
        return self

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h, w, 3) -> (B, C) float32: the pooled features, eagerly."""
        # NHWC -> NCHW view: the strides of channels_last, no copy
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(self.dtype))
        for stage in self.layers:
            x = stage(x)
        return self.norm(x).mean(dim=1, dtype=torch.float32)

    def count_features(self, batch: int) -> None:
        count("attn_calls", self.n_blocks)
        count("attn_windows", batch * self.windows_per_image)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.pooled(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(x))


def arch_of(state: Dict[str, torch.Tensor]) -> Dict:
    """The sizes of the model whose state dict ``state`` is."""
    depths = []
    for key in state:
        m = re.fullmatch(r"layers\.(\d+)\.blocks\.(\d+)\.norm1\.weight", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            depths += [0] * (i + 1 - len(depths))
            depths[i] = max(depths[i], j + 1)
    heads = [state[f"layers.{i}.blocks.0.attn.logit_scale"].shape[0] for i in range(len(depths))]
    proj = state["patch_embed.proj.weight"]
    embed_dim = proj.shape[0]
    return {"patch": proj.shape[-1], "embed_dim": embed_dim, "depths": tuple(depths), "heads": tuple(heads),
            "window": math.isqrt(state["layers.0.blocks.0.attn.relative_position_index"].shape[0]),
            "mlp_ratio": state["layers.0.blocks.0.mlp.fc1.weight"].shape[0] // embed_dim,
            "cpb_hidden": state["layers.0.blocks.0.attn.cpb_mlp.0.weight"].shape[0],
            "n_outputs": state["head.weight"].shape[0]}


def _to_device(model: SwinV2TL, dtype: torch.dtype, dev: torch.device) -> SwinV2TL:
    """Eval mode on ``dev``: the base in ``dtype`` (the patch conv channels
    last on CUDA), the head in float32, the tables prepared."""
    model = model.eval().requires_grad_(False).to(dev)
    for name, child in model.named_children():
        if name != "head":
            child.to(dtype)
    if dev.type == "cuda":
        model.patch_embed.proj.to(memory_format=torch.channels_last)
    return model.prepare()


def build_swinv2_tl(img_shape: Tuple[int, int, int], arch: Optional[Dict] = None,
                    dtype: torch.dtype = torch.float32, seed: int = 0, device: DeviceLike = None) -> SwinV2TL:
    """A seeded classifier (``arch``: ``SWINV2_B`` by default) on ``device``
    (None = CUDA): every linear and convolution weight drawn from a normal
    of std ``INIT_STD`` truncated at ±2 (in float32 on ``device``, from a
    generator seeded with ``seed``), biases 0, LayerNorm (1, 0), τ = ln 10."""
    if tuple(img_shape)[-1] != 3 or img_shape[0] != img_shape[1]:
        raise ValueError(f"the classifier takes square 3-channel inputs, not {img_shape}")
    dev = resolve_device(device)
    with dev:
        model = SwinV2TL(img_shape[0], **(arch or SWINV2_B))
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                nn.init.trunc_normal_(m.weight, std=INIT_STD, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return _to_device(model, dtype, dev)


def save_member(model: SwinV2TL, path) -> None:
    """The member's checkpoint: its state dict, in float32."""
    torch.save({k: v.float() if v.is_floating_point() else v for k, v in model.state_dict().items()}, Path(path))


def load_member(path, img_shape: Tuple[int, int, int], dtype: torch.dtype, device: DeviceLike = None) -> SwinV2TL:
    """A member from ``save_member``'s checkpoint, on ``device`` (None =
    CUDA), the base in ``dtype``, its features captured as a graph on CUDA."""
    dev = resolve_device(device)
    state = torch.load(Path(path), map_location=dev, weights_only=True)
    with dev:
        model = SwinV2TL(img_shape[0], **arch_of(state))
    model.load_state_dict(state)
    return _to_device(model, dtype, dev).capture()
