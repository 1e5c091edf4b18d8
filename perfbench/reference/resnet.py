"""Plain reference of the invasion ensemble: from a raw Z stack to its rows.

Written for the benchmark in plain PyTorch and NumPy; it imports nothing
of the program and reads the shipped members with its own reader. Each
slice is resized to the classifier's input by the antialiased Lanczos-4
kernel (a = 4, cv2's INTER_LANCZOS4 weights, pixel centres aligned, rows
normalised), in float64, rounded half to even and clipped back to uint8;
then stretched onto 0-255, repeated to three channels and preprocessed as
Keras' ``resnet50.preprocess_input`` (caffe mode: RGB to BGR, ImageNet
means subtracted). Each member is Keras' ResNet50 v1 (He et al. 2015; the
stride on the first 1x1 of a stage's first block) up to the configured
block output, BatchNorm applied as published (eps 1.001e-5), global average
pooling, the dense head and a sigmoid, in float32 with TF32 off. A row is
the members' mean rounded to 4 decimals and its prediction ``prob >
cls_thresh``.

``quantize`` runs the same computation with every convolution's input and
kernel rounded to float8 (e4m3, one scale per tensor): the control, one
precision below the configuration's bfloat16.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_STAGES = {2: (3, 64), 3: (4, 128), 4: (6, 256), 5: (3, 512)}


def lanczos4_weights(n_in: int, n_out: int, a: int = 4) -> np.ndarray:
    scale = n_out / n_in
    stretch = max(1.0 / scale, 1.0)
    coord = (np.arange(n_out) + 0.5) / scale - 0.5
    x = (np.arange(n_in)[None, :] - coord[:, None]) / stretch
    w = np.where(np.abs(x) < a, np.sinc(x) * np.sinc(x / a), 0.0)
    return w / w.sum(axis=1, keepdims=True)


def prep(stack: np.ndarray, hw, device) -> torch.Tensor:
    """(Z, H, W) uint8 -> (Z, h, w, 3) float32 classifier inputs."""
    x = torch.from_numpy(np.asarray(stack)).to(device).double()
    wh = torch.tensor(lanczos4_weights(x.shape[-2], hw[0]), device=device)
    ww = torch.tensor(lanczos4_weights(x.shape[-1], hw[1]), device=device)
    r = torch.clamp(torch.round(wh @ x @ ww.T), 0, 255)  # torch.round: half to even
    lo, hi = r.amin(dim=(-2, -1), keepdim=True), r.amax(dim=(-2, -1), keepdim=True)
    r = torch.where(hi > lo, (r - lo) * (255.0 / torch.clamp(hi - lo, min=1e-30)), 0.0)
    bgr = r[..., None].repeat(1, 1, 1, 3).flip(-1)
    return (bgr - torch.tensor(_CAFFE_MEAN_BGR, dtype=torch.float64, device=device)).float()


def rank_members(ensemble_dir: Path, n_models: int) -> List[int]:
    """Members by their best fine-tune validation loss (identity when no history)."""
    best = np.full(n_models, np.inf)
    for i in range(n_models):
        hist = Path(ensemble_dir) / f"best_model_history_{i}.csv"
        if hist.is_file():
            with open(hist) as f:
                losses = [float(r["val_loss"]) for r in csv.DictReader(f)
                          if r.get("training_stage") == "finetune"]
            if losses:
                best[i] = min(losses)
    return list(range(n_models)) if np.isinf(best).all() else [int(i) for i in best.argsort()]


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax(), min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class ResNetRef:
    """One member from its Flax tree; ``__call__`` takes NHWC float32 and
    gives (B,) probabilities."""

    def __init__(self, tree: Dict, last_layer: str, device, eps: float = 1.001e-5,
                 quantize: bool = False):
        self.eps, self.quantize = eps, quantize
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        base, stats = tree["params"]["base_model"], tree["batch_stats"]["base_model"]
        self.p = {k: {kk: {n: t(a) for n, a in vv.items()} for kk, vv in v.items()}
                  if "_block" in k else {n: t(a) for n, a in v.items()} for k, v in base.items()}
        self.s = {k: {kk: {n: t(a) for n, a in vv.items()} for kk, vv in v.items()}
                  if "_block" in k else {n: t(a) for n, a in v.items()} for k, v in stats.items()}
        self.head = {n: t(a) for n, a in tree["params"]["head"].items()}
        stage, block = int(last_layer.split("_")[0][4:]), int(last_layer.split("_")[1][5:])
        self.blocks = [(s, b) for s in range(2, stage + 1)
                       for b in range(1, (_STAGES[s][0] if s < stage else block) + 1)]

    def _conv_bn(self, x, p, s, conv, bn, stride=1, padding=0):
        k = p[conv]["kernel"].permute(3, 2, 0, 1)
        if self.quantize:
            x, k = _fp8(x), _fp8(k)
        y = F.conv2d(x, k, p[conv]["bias"], stride=stride, padding=padding)
        g = p[bn]["scale"] / torch.sqrt(s[bn]["var"] + self.eps)
        return (y - s[bn]["mean"][:, None, None]) * g[:, None, None] + p[bn]["bias"][:, None, None]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).float()
        x = torch.relu(self._conv_bn(x, self.p, self.s, "conv1_conv", "conv1_bn", 2, 3))
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)  # zero padding after a relu
        for stage, block in self.blocks:
            name = f"conv{stage}_block{block}"
            p, s = self.p[name], self.s[name]
            stride = 2 if (stage > 2 and block == 1) else 1
            short = self._conv_bn(x, p, s, "0_conv", "0_bn", stride) if block == 1 else x
            y = torch.relu(self._conv_bn(x, p, s, "1_conv", "1_bn", stride))
            y = torch.relu(self._conv_bn(y, p, s, "2_conv", "2_bn", 1, 1))
            x = torch.relu(self._conv_bn(y, p, s, "3_conv", "3_bn") + short)
        feats = x.mean(dim=(2, 3))
        return torch.sigmoid(feats @ self.head["kernel"] + self.head["bias"])[:, 0]


def stack_probs(stack: np.ndarray, members: Sequence[ResNetRef], hw, device) -> torch.Tensor:
    """(k, Z) float32 member probabilities of one stack."""
    x = prep(stack, hw, device)
    return torch.stack([m(x) for m in members])


def rows(member_probs: torch.Tensor, cls_thresh: float) -> List[tuple]:
    """(probability rounded to 4 decimals, prediction) of each slice."""
    mean = member_probs.double().mean(dim=0).cpu().numpy()
    return [(round(float(p), 4), int(round(float(p), 4) > cls_thresh)) for p in mean]
