"""Plain reference of a plate well: from the raw Z stack to its row.

Written for the benchmark from the published description of each step
(the JAX package's and the port's docstrings), in plain PyTorch, NumPy and
SciPy, float32 with TF32 off for the UNet and float64 elsewhere. It
imports nothing of the program and takes none of its outputs: it reads the
shipped checkpoint with its own reader (``flax_msgpack.py``), and its host
tail (``topology.py``) is written anew from the original tool's published
description.

A well's row: the Z projection (``max``), the Lanczos-3 resize to the
segmentor's scale and the stretch onto [0, 1], the GMM area of the
projection (a 2-component mixture by k-means and EM, foreground above the
higher mean), the UNet-Xception segmentation
of every TTA patch (``unet_probs``) blended by the squared-spline window,
then the disk(2) median of the mask, its Zhang-Suen skeleton, the
component filter, the centreline distance weighting, the linear resize to
384 px and the Morse graph's branch count and lengths in um.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from scipy.signal.windows import triang

from perfbench.reference import topology

DOWNSAMPLE_WIDTH = 384


def no_tf32() -> None:
    """Plain float32 products on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- resize


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.where(x == 0, 1.0, 3 * np.sin(np.pi * x) * np.sin(np.pi * x / 3) / (np.pi**2 * x**2))
    return np.where(np.abs(x) < 3, y, 0.0)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weights(n_in: int, n_out: int, kernel: str) -> np.ndarray:
    """(n_out, n_in) float64 weights of ``jax.image.resize``'s scheme:
    pixel centres aligned, the kernel stretched by the scale when
    downsampling, each row normalised to 1."""
    fn = {"lanczos3": _lanczos3, "linear": _triangle}[kernel]
    scale = n_out / n_in
    stretch = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    w = fn((sample[:, None] - np.arange(n_in)[None, :]) / stretch)
    return w / w.sum(axis=1, keepdims=True)


def resize2d(img: torch.Tensor, shape: Tuple[int, int], kernel: str) -> torch.Tensor:
    """Separable resize of the trailing (H, W) axes, in float64."""
    wh = torch.tensor(resize_weights(img.shape[-2], shape[0], kernel), device=img.device)
    ww = torch.tensor(resize_weights(img.shape[-1], shape[1], kernel), device=img.device)
    return wh @ img.double() @ ww.T


def stretch(img: torch.Tensor) -> torch.Tensor:
    """Linear stretch of the image's (min, max) onto (0, 1); a constant image gives 0."""
    a, b = img.min(), img.max()
    if b <= a:
        return torch.zeros_like(img)
    return (img - a) / (b - a)


# ---------------------------------------------------------------- GMM area


def gmm_threshold(x: torch.Tensor, n_iter: int = 100, tol: float = 1e-3, dtype=torch.float64) -> float:
    """Foreground threshold min(255, mu_fg) of a 2-component 1-D Gaussian
    mixture of ``x``: 20 Lloyd steps from the mean for the start, then EM
    until the mean log-likelihood moves by less than ``tol`` (at most
    ``n_iter`` steps), computed in ``dtype`` (float64; the control takes
    bfloat16)."""
    x = x.to(dtype).flatten()
    t = x.mean()
    for _ in range(20):
        lo, hi = x[x <= t], x[x > t]
        t = ((lo.mean() if lo.numel() else t) + (hi.mean() if hi.numel() else t)) / 2
    lo, hi = x[x <= t], x[x > t]
    mu = torch.stack([lo.mean(), hi.mean()])
    var = torch.clamp(torch.stack([lo.var(unbiased=False), hi.var(unbiased=False)]), min=1e-6)
    pi = torch.tensor([lo.numel(), hi.numel()], dtype=dtype, device=x.device) / x.numel()
    # each step updates the mixture; the loop stops once the likelihood
    # that a step saw moved by less than tol from the step before's
    ll_prev, ll_curr, it = -math.inf, math.inf, 0
    while it < n_iter and abs(ll_curr - ll_prev) >= tol:
        logp = (-0.5 * (x[None] - mu[:, None]) ** 2 / var[:, None]
                - 0.5 * torch.log(2 * math.pi * var)[:, None] + torch.log(pi)[:, None])
        norm = torch.logsumexp(logp, dim=0)
        resp = torch.exp(logp - norm[None])
        nk = resp.sum(dim=1)
        mu = (resp * x[None]).sum(dim=1) / nk
        var = (resp * (x[None] - mu[:, None]) ** 2).sum(dim=1) / nk + 1e-6
        pi = nk / nk.sum()
        ll_prev, ll_curr, it = ll_curr, float(norm.float().mean()), it + 1
    return min(255.0, float(mu[int(torch.argmax(mu))]))


def area_band(proj: torch.Tensor, delta: float = 1e-4, dtype=torch.float64) -> Tuple[float, float]:
    """The projection's GMM area in percent, with the threshold moved by
    ``delta`` (of the stretched [0, 1] range) down and up: (least, most).
    A program whose threshold lies within ``delta`` of the reference's gives
    an area inside the band; ``dtype`` is the GMM's (the control's bfloat16)."""
    scaled = stretch(proj.double())
    t = gmm_threshold(scaled, dtype=dtype)

    def area(th):
        return 100 * float(((scaled > th) & (scaled > 0)).double().mean())

    return area(t + delta), area(t - delta)


# ---------------------------------------------------------------- UNet


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    """TensorFlow's SAME padding (before, after) of one axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class UNetRef(torch.nn.Module):
    """The UNet-Xception of Keras' "U-Net-like" segmentation example at
    the checkpoint's widths, evaluated in float32 with BatchNorm applied
    as published (not folded): NHWC (B, H, W, C) in, sigmoid
    probabilities (B, H, W, 1) out."""

    def __init__(self, tree: Dict, filters: Sequence[int], eps: float = 1e-3):
        super().__init__()
        self.p, self.bs, self.eps = tree["params"], tree["batch_stats"], eps
        self.f = sorted(filters)
        self.w = {}

    def to_device(self, device) -> "UNetRef":
        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    self.w[f"{prefix}{k}"] = torch.tensor(np.asarray(v, np.float32), device=device)

        walk(self.p, "")
        walk(self.bs, "stats.")
        return self

    def _k(self, name: str) -> torch.Tensor:
        return self.w[f"{name}.kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW

    def conv(self, x, name, stride=1, groups=1, bias=True):
        k = self._k(name)
        (pt, pb), (pl, pr) = _same(x.shape[2], k.shape[2], stride), _same(x.shape[3], k.shape[3], stride)
        y = F.conv2d(F.pad(x, (pl, pr, pt, pb)), k, stride=stride, groups=groups)
        return y + self.w[f"{name}.bias"][:, None, None] if bias else y

    def bn(self, x, i):
        n = f"BatchNorm_{i}"
        mean, var = self.w[f"stats.{n}.mean"], self.w[f"stats.{n}.var"]
        scale, bias = self.w[f"{n}.scale"], self.w[f"{n}.bias"]
        return ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + self.eps)
                * scale[:, None, None] + bias[:, None, None])

    def sep(self, x, name):
        x = self.conv(x, f"{name}.depthwise", groups=x.shape[1], bias=False)
        return self.conv(x, f"{name}.pointwise")

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        n_down, n_up = len(self.f) - 1, len(self.f)
        x = batch.float().permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x, "Conv_0", 2), 0))
        prev = x
        for i in range(n_down):
            if i:
                x = torch.relu(x)
            x = torch.relu(self.bn(self.sep(x, f"SeparableConv_{2 * i}"), 1 + 2 * i))
            x = self.bn(self.sep(x, f"SeparableConv_{2 * i + 1}"), 2 + 2 * i)
            (pt, pb), (pl, pr) = _same(x.shape[2], 3, 2), _same(x.shape[3], 3, 2)
            x = F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=-math.inf), 3, 2)
            x = x + self.conv(prev, f"Conv_{1 + i}", 2)
            prev = x
        for j in range(n_up):
            b = 1 + 2 * n_down + 2 * j
            h = torch.relu(self.bn(self.conv(torch.relu(x), f"ConvTranspose_{2 * j}"), b))
            h = self.bn(self.conv(h, f"ConvTranspose_{2 * j + 1}"), b + 1)
            x = F.interpolate(h + self.conv(prev, f"Conv_{1 + n_down + j}"), scale_factor=2,
                              mode="nearest")
            prev = x
        y = torch.sigmoid(self.conv(x, f"Conv_{1 + n_down + n_up}"))
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def predict(self, batch: torch.Tensor, block: int = 40) -> torch.Tensor:
        return torch.cat([self(batch[i : i + block]) for i in range(0, len(batch), block)])


# ---------------------------------------------------------------- tiling


def spline_window(n: int, power: int = 2) -> np.ndarray:
    """Squared-spline window of ``n`` samples, mean 1."""
    q = int(n / 4)
    outer = (np.abs(2 * triang(n)) ** power) / 2
    outer[q:-q] = 0
    inner = 1 - (np.abs(2 * (triang(n) - 1)) ** power) / 2
    inner[:q] = 0
    inner[-q:] = 0
    w = inner + outer
    return w / np.average(w)


def _geometry(h: int, w: int, win: int, sub: int):
    step = win // sub
    aug = int(round(win * (1 - 1.0 / sub)))
    n_steps = max(0, math.ceil((max(h, w) + 2 * aug - win) / step))
    return step, aug, win + n_steps * step, n_steps + 1


_DO = [lambda a: a, lambda a: torch.rot90(a, 1, (0, 1)), lambda a: torch.rot90(a, 2, (0, 1)),
       lambda a: torch.rot90(a, 3, (0, 1)), lambda a: torch.flip(a, (1,)),
       lambda a: torch.rot90(torch.flip(a, (1,)), 1, (0, 1)),
       lambda a: torch.rot90(torch.flip(a, (1,)), 2, (0, 1)),
       lambda a: torch.rot90(torch.flip(a, (1,)), 3, (0, 1))]
_UNDO = [lambda a: a, lambda a: torch.rot90(a, 3, (0, 1)), lambda a: torch.rot90(a, 2, (0, 1)),
         lambda a: torch.rot90(a, 1, (0, 1)), lambda a: torch.flip(a, (1,)),
         lambda a: torch.flip(torch.rot90(a, 3, (0, 1)), (1,)),
         lambda a: torch.flip(torch.rot90(a, 2, (0, 1)), (1,)),
         lambda a: torch.flip(torch.rot90(a, 1, (0, 1)), (1,))]


def tile(img: torch.Tensor, win: int, tta: int, sub: int = 2) -> torch.Tensor:
    """The patch batch of an (H, W) image: padded with its minimum onto a
    square canvas the patch grid tiles, ``tta`` dihedral variants, patches
    row-major: (tta * n * n, win, win, 1) float32."""
    h, w = img.shape
    step, aug, side, n = _geometry(h, w, win, sub)
    canvas = torch.full((side, side), float(img.min()), dtype=torch.float32, device=img.device)
    canvas[aug : aug + h, aug : aug + w] = img.float()
    out = []
    for k in range(tta):
        v = _DO[k](canvas)
        out += [v[i * step : i * step + win, j * step : j * step + win] for i in range(n) for j in range(n)]
    return torch.stack(out)[..., None]


def blend(probs: torch.Tensor, h: int, w: int, win: int, tta: int, sub: int = 2) -> torch.Tensor:
    """Window-weighted overlap-add of the patch outputs, the transforms
    undone and averaged: (h, w) float64."""
    step, aug, side, n = _geometry(h, w, win, sub)
    sw = torch.tensor(spline_window(win), device=probs.device)
    wind = sw[:, None] * sw[None, :]
    p = probs[..., 0].double().reshape(tta, n, n, win, win) * wind
    merged = torch.zeros((side, side), dtype=torch.float64, device=probs.device)
    for k in range(tta):
        canvas = torch.zeros((side, side), dtype=torch.float64, device=probs.device)
        for i in range(n):
            for j in range(n):
                canvas[i * step : i * step + win, j * step : j * step + win] += p[k, i, j]
        merged += _UNDO[k](canvas / sub**2)
    return (merged / tta)[aug : aug + h, aug : aug + w]


# ---------------------------------------------------------------- host tail


def zhang_suen(mask: torch.Tensor) -> torch.Tensor:
    """Zhang-Suen thinning of a 2-D mask (both sub-iterations until no change)."""
    x = (mask > 0).to(torch.uint8)
    h, w = x.shape
    while True:
        before = x
        for first in (True, False):
            p = F.pad(x, (1, 1, 1, 1))
            n, ne, e, se = p[0:h, 1:w + 1], p[0:h, 2:w + 2], p[1:h + 1, 2:w + 2], p[2:h + 2, 2:w + 2]
            s, sw, wn, nw = p[2:h + 2, 1:w + 1], p[2:h + 2, 0:w], p[1:h + 1, 0:w], p[0:h, 0:w]
            ring = [n, ne, e, se, s, sw, wn, nw]
            b = sum(r.int() for r in ring)
            a = sum(((ring[i] == 0) & (ring[(i + 1) % 8] == 1)).int() for i in range(8))
            c3 = (n * e * s) == 0 if first else (n * e * wn) == 0
            c4 = (e * s * wn) == 0 if first else (n * s * wn) == 0
            x = torch.where((x == 1) & (b >= 2) & (b <= 6) & (a == 1) & c3 & c4, 0, x).to(torch.uint8)
        if torch.equal(x, before):
            return x > 0


def _disk2() -> np.ndarray:
    y, x = np.mgrid[-2:3, -2:3]
    return x**2 + y**2 <= 4


def branch_row(preds: torch.Tensor, width_um: float, graph: Dict, pruning=None) -> Tuple[int, float, float]:
    """(branches, total um, mean um) of a (h, w) probability map, in
    float64; ``pruning`` (a bool raster at 384 px wide) prunes the
    branches whose median falls on it."""
    seg = (preds > 0.5).cpu().numpy().astype(np.uint8)
    filtered = ndimage.median_filter(seg, footprint=_disk2(), mode="nearest") > 0
    skel = zhang_suen(torch.from_numpy(filtered).to(preds.device)).cpu().numpy()
    masks = topology.component_filter(filtered, skel)
    skels = skel & masks
    dist = ndimage.distance_transform_edt(masks) if masks.any() else np.zeros(masks.shape)
    cdt = ndimage.distance_transform_edt(~skels) if skels.any() else np.full(masks.shape, np.inf)
    h, w = preds.shape
    with np.errstate(invalid="ignore"):
        rel = np.where(dist > 0, dist / np.maximum(dist + cdt, 1e-12), 0.0)
    p384 = resize2d(preds.double() * torch.from_numpy(rel).to(preds.device),
                    (int(round(h * DOWNSAMPLE_WIDTH / w)), DOWNSAMPLE_WIDTH), "linear").cpu().numpy()
    lo, hi = float(p384.min()), float(p384.max())
    if not np.isfinite(hi - lo) or hi - lo < 1e-12:
        return 0, 0.0, 0.0
    px_per_um = DOWNSAMPLE_WIDTH / width_um
    n, total_px, avg_px = topology.branch_stats(
        (p384 - lo) * (255.0 / (hi - lo)),
        (graph.get("graph_thresh_1", 5), graph.get("graph_thresh_2", 10)),
        round(max(1, graph.get("graph_smoothing_window", 12) * px_per_um)),
        round(graph.get("min_branch_length", 12) * px_per_um), pruning)
    return n, total_px / px_per_um, avg_px / px_per_um


def project(stack: np.ndarray) -> np.ndarray:
    """The max projection of a (Z, H, W) stack, float64."""
    return stack.max(axis=0).astype(np.float64)


def well_row(stack: np.ndarray, model: UNetRef, seg_cfg: Dict, traffic: Dict, device="cuda",
             kept: Optional[Dict] = None) -> Dict:
    """What the reference makes of a well's raw stack (trimmed to its
    depth by the caller): the patch batch's probabilities (``probs``), the
    area's band (``area_band``), the segmentor's scale (``target``) and the
    projection (``proj``). A reference that judges more of what the
    program made takes it from ``kept`` and returns its numbers in
    ``gaps``; the max projection has none."""
    proj = torch.from_numpy(project(stack)).to(device)
    h, w = proj.shape
    target = (int(round(h * seg_cfg["ds_ratio"])), int(round(w * seg_cfg["ds_ratio"])))
    small = stretch(resize2d(proj, target, "lanczos3"))
    probs = model.predict(tile(small, seg_cfg["patch_size"], seg_cfg.get("tta", 8)))
    return {"probs": probs, "area_band": area_band(proj), "target": target, "proj": proj}


def control_area(want: Dict) -> float:
    """The control's area of a well: its GMM run in bfloat16."""
    return 0.5 * sum(area_band(want["proj"], 0.0, torch.bfloat16))


def tail_row(probs: torch.Tensor, want: Dict, seg_cfg: Dict, traffic: Dict,
             dtype=torch.float64) -> Tuple[int, float, float]:
    """The host tail's row from given patch outputs (the program's own):
    blended at ``want``'s scale, rounded to ``dtype`` (the control's
    bfloat16), then ``branch_row``."""
    preds = blend(probs, *want["target"], seg_cfg["patch_size"], seg_cfg.get("tta", 8))
    return branch_row(preds.to(dtype).double(), traffic["image_width_microns"], traffic.get("graph", {}))
