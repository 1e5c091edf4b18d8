"""Plain reference of the SwinV2 invasion ensemble: from a raw Z stack to
its logits, probabilities and rows.

Written for the benchmark in plain PyTorch; it imports nothing of the
program and reads a member's checkpoint (a ``torch.save``d state dict of
float32 tensors, under the names of Microsoft's SwinV2 code) by itself.
Each slice is resized by ``reference/resnet.py``'s antialiased Lanczos-4
weights in float64, rounded half to even and clipped to uint8, stretched
onto 0-255, divided by 255, normalised by torchvision's ImageNet mean and
std and repeated to three channels.

Each member follows SwinV2 (Liu et al., arXiv:2111.09883, as
``configs/swinv2/swinv2_base_patch4_window16_256.yaml`` sizes it; the sizes come
from the configuration, not from the checkpoint) literally, on every
forward, in float32 with TF32 off: the patch embedding's convolution and
LayerNorm; per block a roll by (−s, −s) of the token grid, the partition
into w×w windows, ``qkv = x·Wqkv + [q_bias, 0, v_bias]``, cosine logits
``(q̂·k̂ᵀ)·exp(min(τ, ln 100))``, the continuous position bias (the
``cpb_mlp`` of the log-spaced relative coordinates, gathered by the
relative-position index, ``16·sigmoid``), the shift mask (−100 across the
rolled grid's regions, built as the published code builds it), softmax,
``·v``, ``proj``, the windows reversed and rolled back, and the post-norm
residuals ``x + LN1(attn)``, ``x + LN2(fc2(GELU(fc1)))``; patch merging
(the 2×2 neighbours as (even, even), (odd, even), (even, odd), (odd, odd),
the reduction, then its LayerNorm); the final LayerNorm, the mean over
tokens, the dense head (a logit) and a sigmoid. A row is the members' mean
rounded to 4 decimals and its prediction ``prob > cls_thresh``
(``reference/resnet.py``'s ``rows``).

``quantize`` runs the same computation with every Linear's input and
weight rounded to float8 (e4m3, one scale per tensor,
``reference/resnet.py``'s ``_fp8``): the control, one precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.resnet import _fp8, lanczos4_weights, rows  # noqa: F401 (rows: the cell's rows)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-5


def prep(stack: np.ndarray, hw, device) -> torch.Tensor:
    """(Z, H, W) uint8 -> (Z, h, w, 3) float32 classifier inputs."""
    x = torch.from_numpy(np.asarray(stack)).to(device).double()
    wh = torch.tensor(lanczos4_weights(x.shape[-2], hw[0]), device=device)
    ww = torch.tensor(lanczos4_weights(x.shape[-1], hw[1]), device=device)
    r = torch.clamp(torch.round(wh @ x @ ww.T), 0, 255)  # torch.round: half to even
    lo, hi = r.amin(dim=(-2, -1), keepdim=True), r.amax(dim=(-2, -1), keepdim=True)
    r = torch.where(hi > lo, (r - lo) * (255.0 / torch.clamp(hi - lo, min=1e-30)), 0.0)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float64, device=device)
    return ((r[..., None] / 255.0 - mean) / std).float()


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, w, w, C), windows in row-major order."""
    b, h, wd, c = x.shape
    return x.view(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // w) * (wd // w))
    x = windows.view(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def shift_mask(grid: int, w: int, s: int) -> torch.Tensor:
    """(nW, w², w²): 0 between tokens of one region of the rolled grid,
    −100 between tokens of two (the published code's ``attn_mask``)."""
    img = torch.zeros((1, grid, grid, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(img, w).view(-1, w * w)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def coords_table(w: int) -> torch.Tensor:
    r = torch.arange(-(w - 1), w, dtype=torch.float32)
    t = torch.stack(torch.meshgrid([r, r], indexing="ij")).permute(1, 2, 0).contiguous()
    t = t / (w - 1) * 8
    return torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / np.log2(8)


def position_index(w: int) -> torch.Tensor:
    coords = torch.flatten(torch.stack(torch.meshgrid([torch.arange(w), torch.arange(w)], indexing="ij")), 1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


class SwinV2Ref:
    """One member from its state dict at the configuration's sizes
    (``arch``: ``patch``, ``embed_dim``, ``depths``, ``heads``, ``window``);
    ``__call__`` takes NHWC float32 and gives (B,) logits."""

    def __init__(self, state: Dict[str, torch.Tensor], img_size: int, arch: Dict, device,
                 quantize: bool = False):
        self.p = {k: v.to(device).float() for k, v in state.items() if v.is_floating_point()}
        self.quantize, self.device = quantize, device
        self.patch, self.embed = arch["patch"], arch["embed_dim"]
        self.depths, self.heads, self.window = list(arch["depths"]), list(arch["heads"]), arch["window"]
        self.grid0 = img_size // self.patch

    def _linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p.get(f"{name}.bias")
        if self.quantize:
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, b)

    def _ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"], LN_EPS)

    def _attention(self, x: torch.Tensor, pre: str, heads: int, w: int, mask) -> torch.Tensor:
        b_, n, c = x.shape
        p = self.p
        qkv_w = p[f"{pre}.qkv.weight"]
        qkv_b = torch.cat((p[f"{pre}.q_bias"], torch.zeros_like(p[f"{pre}.v_bias"]), p[f"{pre}.v_bias"]))
        if self.quantize:
            qkv = F.linear(_fp8(x), _fp8(qkv_w), qkv_b)
        else:
            qkv = F.linear(x, qkv_w, qkv_b)
        qkv = qkv.reshape(b_, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
        logit_scale = torch.clamp(p[f"{pre}.logit_scale"], max=math.log(1.0 / 0.01)).exp()
        attn = attn * logit_scale
        coords = coords_table(w).to(self.device)
        hidden = torch.relu(self._linear(coords, f"{pre}.cpb_mlp.0"))
        table = self._linear(hidden, f"{pre}.cpb_mlp.2").view(-1, heads)
        bias = table[position_index(w).to(self.device).view(-1)].view(w * w, w * w, -1)
        attn = attn + 16 * torch.sigmoid(bias.permute(2, 0, 1).contiguous()).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self._linear(x, f"{pre}.proj")

    def _block(self, x: torch.Tensor, pre: str, grid: int, heads: int, w: int, s: int) -> torch.Tensor:
        b, l, c = x.shape
        shortcut = x
        x = x.view(b, grid, grid, c)
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = window_partition(x, w).view(-1, w * w, c)
        mask = shift_mask(grid, w, s).to(self.device) if s > 0 else None
        attn = self._attention(windows, f"{pre}.attn", heads, w, mask).view(-1, w, w, c)
        x = window_reverse(attn, w, grid, grid)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = shortcut + self._ln(x.reshape(b, l, c), f"{pre}.norm1")
        y = self._linear(F.gelu(self._linear(x, f"{pre}.mlp.fc1")), f"{pre}.mlp.fc2")
        return x + self._ln(y, f"{pre}.norm2")

    def _merge(self, x: torch.Tensor, pre: str, grid: int) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, grid, grid, c)
        x0, x1 = x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :]
        x2, x3 = x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1).view(b, -1, 4 * c)
        return self._ln(self._linear(x, f"{pre}.reduction"), f"{pre}.norm")

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x = F.conv2d(x.permute(0, 3, 1, 2).float(), p["patch_embed.proj.weight"], p["patch_embed.proj.bias"],
                     stride=self.patch)
        b, c = x.shape[:2]
        x = self._ln(x.flatten(2).transpose(1, 2), "patch_embed.norm")
        grid = self.grid0
        for i, (depth, heads) in enumerate(zip(self.depths, self.heads)):
            w = self.window
            s = w // 2
            if grid <= w:  # the published rule: no partition, no shift
                w, s = grid, 0
            for j in range(depth):
                x = self._block(x, f"layers.{i}.blocks.{j}", grid, heads, w, s if j % 2 else 0)
            if i < len(self.depths) - 1:
                x = self._merge(x, f"layers.{i}.downsample", grid)
                grid //= 2
        feats = self._ln(x, "norm").mean(dim=1)
        return self._linear(feats, "head")[:, 0]


def logits(x: torch.Tensor, member: SwinV2Ref, chunk: int = 8) -> torch.Tensor:
    """(B,) float32 logits of ``prep``'s inputs, ``chunk`` at a time."""
    return torch.cat([member(x[i:i + chunk]) for i in range(0, len(x), chunk)])


def stack_logits(stack: np.ndarray, members: Sequence[SwinV2Ref], hw, device) -> torch.Tensor:
    """(k, Z) float32 member logits of one stack."""
    x = prep(stack, hw, device)
    return torch.stack([logits(x, m) for m in members])

