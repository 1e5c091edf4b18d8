"""Post-training int8 (w8a8) inference for the UNet-Xception segmentor (opt-in).

Counterpart of ``tmat_tpu/models/quant.py``, with the same names, tags and
sidecar, so that the two packages share one ``<checkpoint>.quant.json``.
Opt-in (``quantize=True``, ``"quantize": true`` in a model config, or
``TMAT_TPU_INT8=1``); bf16 stays the default.

Scheme (the JAX module's): inference BatchNorm folded into the convs;
weights per output channel symmetric int8 (``max|w| / 127``); activations
per input channel symmetric, from the 99.95th percentile of ``|x|`` over a
calibration batch, folded into the weights along their input axis; the
sigmoid head stays float.

- ``extract_folded``, ``_tensor_scales``, ``quantize_folded`` and
  ``quantize_mixed`` are the JAX module's numpy, copied: the same scales
  give bit-equal int8 weights and float32 multipliers.
- ``forward_folded`` is the float32 structure oracle and, with
  ``collect``, the calibration pass; ``calibrate`` runs it on the
  segmentor's device in float32 (TF32 off on the card), where the JAX
  package runs it on its CPU backend.
- ``forward_quant`` is the full integer-domain graph: int8 relu, the
  max pool padded with -128, ``_add_q``'s float32 multiply-add then round
  half to even and clip to +-127, the float tail and the float head.
- ``forward_mixed`` (the default mode) keeps the float storage of the
  port's ``UNetXception`` forward, so the down blocks stay on the
  down-block kernel, and swaps the six deep up convs (``DEFAULT_MIXED_TAGS``)
  for int8 ones: the input requantised on the fly
  (``clip(round(h * inv_sx))``), s8 x s8 -> s32, then ``acc * eff + b`` in
  the float dtype. In float32 it follows the JAX function; in bfloat16 the
  down blocks keep Pallas's rounding points where JAX rounds at every conv.

Every s8 x s8 convolution but the depthwise ones goes through
``ops/int8_conv.py`` (the CUDA kernel on the card, its plain version on the
CPU). The depthwise int8 convs (``forward_quant``'s ``dw`` tags) are nine
shifted int32 multiply-adds in PyTorch, exact on any device.
"""

from __future__ import annotations

import hashlib
import json
import os
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.unet import UNetXception, _conv_nhwc, _upsample2
from tmat_torch.ops.down_block import _maxpool3x3s2
from tmat_torch.ops.int8_conv import conv2d_s8, epilogue_plain, pack_weights, same_pads

BN_EPS = 1e-3  # reference models.py BatchNormalization(epsilon=1e-3)


# ---------------------------------------------------------------------------
# BN folding / layer extraction (numpy, as in the JAX module)
# ---------------------------------------------------------------------------


def _fold_bn(w, b, bn_p, bn_s):
    """Fold an inference-mode BatchNorm into the preceding conv."""
    s = np.asarray(bn_p["scale"]) / np.sqrt(np.asarray(bn_s["var"]) + BN_EPS)
    w = np.asarray(w) * s  # broadcasts over the output-channel (last) axis
    b = np.zeros(w.shape[-1], np.float32) if b is None else np.asarray(b)
    b = (b - np.asarray(bn_s["mean"])) * s + np.asarray(bn_p["bias"])
    return w.astype(np.float32), b.astype(np.float32)


def extract_folded(variables, filter_counts: Sequence[int]) -> Dict[str, dict]:
    """Flatten the Flax tree into tag -> {w, b, kind, stride} with BN folded.

    Tags follow the forward structure: ``entry``; ``d{i}.dw1/pw1/dw2/pw2/res``
    per down block; ``u{j}.t1/t2/res`` per up block; ``head``.
    """
    p = variables["params"]
    bs = variables["batch_stats"]
    n_down = len(filter_counts) - 1
    n_up = len(filter_counts)
    out: Dict[str, dict] = {}

    def conv(name):
        c = p[name]
        return np.asarray(c["kernel"]), np.asarray(c["bias"])

    def spec(w, b, kind="conv", stride=1):
        return {"w": np.asarray(w, np.float32),
                "b": None if b is None else np.asarray(b, np.float32),
                "kind": kind, "stride": stride}

    w, b = conv("Conv_0")
    w, b = _fold_bn(w, b, p["BatchNorm_0"], bs["BatchNorm_0"])
    out["entry"] = spec(w, b, stride=2)

    bn_i = 1
    for i in range(n_down):
        for k, sep in ((1, f"SeparableConv_{2 * i}"), (2, f"SeparableConv_{2 * i + 1}")):
            dw = np.asarray(p[sep]["depthwise"]["kernel"])
            pw = np.asarray(p[sep]["pointwise"]["kernel"])
            pb = np.asarray(p[sep]["pointwise"]["bias"])
            pw, pb = _fold_bn(pw, pb, p[f"BatchNorm_{bn_i}"], bs[f"BatchNorm_{bn_i}"])
            bn_i += 1
            out[f"d{i}.dw{k}"] = spec(dw, None, kind="dw")
            out[f"d{i}.pw{k}"] = spec(pw, pb)
        w, b = conv(f"Conv_{1 + i}")
        out[f"d{i}.res"] = spec(w, b, stride=2)

    for j in range(n_up):
        for k, name in ((1, f"ConvTranspose_{2 * j}"), (2, f"ConvTranspose_{2 * j + 1}")):
            w, b = conv(name)
            w, b = _fold_bn(w, b, p[f"BatchNorm_{bn_i}"], bs[f"BatchNorm_{bn_i}"])
            bn_i += 1
            out[f"u{j}.t{k}"] = spec(w, b, kind="convT")
        w, b = conv(f"Conv_{1 + n_down + j}")
        out[f"u{j}.res"] = spec(w, b)

    w, b = conv(f"Conv_{1 + n_down + n_up}")
    out["head"] = spec(w, b)
    out["_n"] = {"down": n_down, "up": n_up}
    return out


# ---------------------------------------------------------------------------
# Shared forward structure (reference models.py:85-171, inference mode)
# ---------------------------------------------------------------------------


def _structure(x, conv: Callable, n_down: int, n_up: int, rec: Optional[Callable] = None):
    """Layer order of reference models.py:85-171 (inference mode). ``rec``
    is an identity hook at the residual-add sites (operands and sums), where
    the calibration pass takes statistics too."""
    r = (lambda tag, h: h) if rec is None else rec
    x = torch.relu(conv("entry", x))
    prev = x
    for i in range(n_down):
        h = torch.relu(x) if i != 0 else x
        h = torch.relu(conv(f"d{i}.pw1", conv(f"d{i}.dw1", h)))
        h = conv(f"d{i}.pw2", conv(f"d{i}.dw2", h))
        h = r(f"d{i}.main", _maxpool3x3s2(h))
        x = r(f"d{i}.sum", h + r(f"d{i}.res_out", conv(f"d{i}.res", prev)))
        prev = x
    for j in range(n_up):
        h = torch.relu(conv(f"u{j}.t1", torch.relu(x)))
        h = _upsample2(r(f"u{j}.main", conv(f"u{j}.t2", h)))
        x = r(f"u{j}.sum", h + _upsample2(r(f"u{j}.res_out", conv(f"u{j}.res", prev))))
        prev = x
    return torch.sigmoid(conv("head", x).float())


def _oihw(w_hwio: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A HWIO kernel (a depthwise one is (kh, kw, 1, C)) as an OIHW tensor
    of ``like``'s device and dtype."""
    return torch.tensor(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))), dtype=like.dtype,
                        device=like.device)


def _conv_float(sp: dict, x: torch.Tensor) -> torch.Tensor:
    """Float conv at x's dtype: SAME, a depthwise conv grouped by channel, a
    ``convT`` the plain stride-1 correlation Flax's ConvTranspose is here."""
    w = _oihw(sp["w"], x)
    y = _conv_nhwc(x, w, sp["stride"], w.shape[0] if sp["kind"] == "dw" else 1)
    if sp["b"] is not None:
        y = y + torch.tensor(sp["b"], dtype=y.dtype, device=y.device)
    return y


def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q, axis=0)`` with linear interpolation, in float32
    as JAX computes it: position q/100 * (n - 1), the two neighbours
    weighted by its fraction."""
    n = a.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * torch.tensor(n - 1, dtype=torch.float32)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    s = torch.sort(a, dim=0).values
    return s[int(lo)] * (1.0 - w_hi).to(a.device) + s[int(hi)] * w_hi.to(a.device)


def _stat(h: torch.Tensor) -> torch.Tensor:
    """Per-channel 99.95th percentile of |h| over (batch, H, W), after a 4x4
    spatial subsample where H >= 16 (the JAX module's ~50k samples a channel)."""
    a = torch.abs(h).float()
    if a.dim() == 4 and a.shape[1] >= 16:
        a = a[:, ::4, ::4, :]
    return _percentile(a.reshape(-1, a.shape[-1]), 99.95)


def forward_folded(folded, x, collect: bool = False):
    """float32 forward over the folded layers (NHWC in, probabilities out);
    with ``collect`` also the per-channel percentile |x| statistics at every
    conv input and residual-add site (the calibration pass)."""
    stats: Dict[str, torch.Tensor] = {}

    def conv(tag, h):
        if collect:
            stats[tag] = _stat(h)
        return _conv_float(folded[tag], h)

    def rec(tag, h):
        if collect:
            stats[tag] = _stat(h)
        return h

    with torch.no_grad():
        y = _structure(torch.as_tensor(x).float(), conv, folded["_n"]["down"], folded["_n"]["up"],
                       rec=rec)
    return (y, stats) if collect else y


# ---------------------------------------------------------------------------
# Calibration + weight quantization
# ---------------------------------------------------------------------------


def default_calibration_batch(patch_size: int, n: int = 16, seed: int = 7) -> np.ndarray:
    """Representative patches: synthetic vessels rescaled to [0, 1] (the
    production input contract), half of them zeroed outside a disk to mimic
    well masking."""
    from numpy.random import RandomState

    from tmat_torch.models.synthetic import synth_vessel_image

    rng = RandomState(seed)
    imgs = []
    yy, xx = np.mgrid[:patch_size, :patch_size]
    disk = ((yy - patch_size / 2) ** 2 + (xx - patch_size / 2) ** 2) < (patch_size * 0.55) ** 2
    for k in range(n):
        img, _ = synth_vessel_image(rng, size=patch_size)
        img = img.astype(np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-6)
        if k % 2:
            img = img * disk
        imgs.append(img[..., None])
    return np.stack(imgs).astype(np.float32)


@contextmanager
def _no_tf32():
    """cuDNN's default TF32 would move every scale by about 1e-3."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def calibrate(folded, batch: np.ndarray, device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Run the collection pass on ``device`` (None = CUDA) in float32 and
    return static per-input-channel activation scales."""
    dev = resolve_device(device)
    with _no_tf32():
        _, stats = forward_folded(folded, torch.as_tensor(np.asarray(batch, np.float32), device=dev),
                                  collect=True)
    return {tag: (np.maximum(v.cpu().numpy().astype(np.float64), 1e-6) / 127.0).astype(np.float32)
            for tag, v in stats.items()}


def _tensor_scales(scales: Dict[str, np.ndarray], n_down: int, n_up: int):
    """Storage scale of every int8 tensor in the integer-domain graph; each
    residual addend keeps its own per-channel scale, the add rescales both
    to the sum's."""

    def s(tag):
        return np.asarray(scales[tag], np.float64)

    t: Dict[str, np.ndarray] = {"img": s("entry")}
    t["entry_out"] = s("d0.dw1")  # post-relu entry output
    for i in range(n_down):
        t[f"d{i}.dw1_out"] = s(f"d{i}.pw1")
        t[f"d{i}.pw1_out"] = s(f"d{i}.dw2")  # post-relu
        t[f"d{i}.dw2_out"] = s(f"d{i}.pw2")
        t[f"d{i}.main"] = s(f"d{i}.main")
        t[f"d{i}.res_out"] = s(f"d{i}.res_out")
        t[f"d{i}.add"] = s(f"d{i}.sum")
    for j in range(n_up):
        t[f"u{j}.t1_out"] = s(f"u{j}.t2")  # post-relu
        t[f"u{j}.main"] = s(f"u{j}.main")
        t[f"u{j}.res_out"] = s(f"u{j}.res_out")
        t[f"u{j}.add"] = s(f"u{j}.sum")
    return t


def quantize_folded(
    folded,
    scales: Dict[str, np.ndarray],
    quantize_depthwise: bool = True,
    f32_tags: Tuple[str, ...] = (),
    float_tail: bool = True,
) -> Dict[str, dict]:
    """The integer-domain graph's parameters: every inter-op tensor int8
    at a static per-channel scale; each conv's epilogue
    ``clip(round(relu(i32 * m + c)))`` with m = s_w/s_out, c = b/s_out.
    ``float_tail``: the last up block's t2/res epilogues emit float
    (``sout``), and the last residual add and the head run in float."""
    n_down, n_up = folded["_n"]["down"], folded["_n"]["up"]
    ts = _tensor_scales(scales, n_down, n_up)

    # conv tag -> (input storage scale, output storage scale, relu folded)
    wiring: Dict[str, Tuple[np.ndarray, Optional[np.ndarray], bool]] = {
        "entry": (ts["img"], ts["entry_out"], True)
    }
    for i in range(n_down):
        s_prev = ts["entry_out"] if i == 0 else ts[f"d{i - 1}.add"]
        wiring[f"d{i}.dw1"] = (s_prev, ts[f"d{i}.dw1_out"], False)
        wiring[f"d{i}.pw1"] = (ts[f"d{i}.dw1_out"], ts[f"d{i}.pw1_out"], True)
        wiring[f"d{i}.dw2"] = (ts[f"d{i}.pw1_out"], ts[f"d{i}.dw2_out"], False)
        wiring[f"d{i}.pw2"] = (ts[f"d{i}.dw2_out"], ts[f"d{i}.main"], False)
        wiring[f"d{i}.res"] = (s_prev, ts[f"d{i}.res_out"], False)
    for j in range(n_up):
        s_prev = ts[f"d{n_down - 1}.add"] if j == 0 else ts[f"u{j - 1}.add"]
        wiring[f"u{j}.t1"] = (s_prev, ts[f"u{j}.t1_out"], True)
        wiring[f"u{j}.t2"] = (ts[f"u{j}.t1_out"], ts[f"u{j}.main"], False)
        wiring[f"u{j}.res"] = (s_prev, ts[f"u{j}.res_out"], False)
    wiring["head"] = (ts[f"u{n_up - 1}.add"], None, False)

    q: Dict[str, dict] = {
        "_n": folded["_n"],
        "_img_scale": ts["img"].astype(np.float32),
    }
    # residual-add rescale multipliers (per channel): operands at their own
    # epilogue scales -> sum at the sum's calibrated scale
    for i in range(n_down):
        q[f"_add.d{i}"] = {
            "mA": (ts[f"d{i}.main"] / ts[f"d{i}.add"]).astype(np.float32),
            "mB": (ts[f"d{i}.res_out"] / ts[f"d{i}.add"]).astype(np.float32),
        }
    for j in range(n_up):
        q[f"_add.u{j}"] = {
            "mA": (ts[f"u{j}.main"] / ts[f"u{j}.add"]).astype(np.float32),
            "mB": (ts[f"u{j}.res_out"] / ts[f"u{j}.add"]).astype(np.float32),
        }
    for tag, (s_in, s_out, relu) in wiring.items():
        sp = folded[tag]
        s_in = np.asarray(s_in, np.float64)
        w = sp["w"].astype(np.float64)
        if sp["kind"] == "dw":
            # kernel (kh, kw, 1, C): input channel c is output channel c
            w = w * s_in[None, None, None, :]
        else:
            w = w * s_in[None, None, :, None]
        b = np.zeros(w.shape[-1]) if sp["b"] is None else sp["b"].astype(np.float64)
        tail = float_tail and tag in (f"u{n_up - 1}.t2", f"u{n_up - 1}.res")
        if tag == "head" and float_tail:
            # head consumes the float tail directly: no input-scale folding
            q[tag] = {
                "quant": False,
                "w": sp["w"].astype(np.float32),
                "b": b.astype(np.float32),
                "inv_sout": None,
                "float_in": True,
                "relu": relu,
                "kind": sp["kind"],
                "stride": sp["stride"],
            }
            continue
        do_quant = (
            tag != "head"
            and tag not in f32_tags
            and not (sp["kind"] == "dw" and not quantize_depthwise)
        )
        if do_quant:
            s_w = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
            s_w = np.where(s_w == 0, 1.0, s_w)
            wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
            q[tag] = {
                "quant": True,
                "wq": wq,
                "m": (s_w / s_out).astype(np.float32),
                "c": (b / s_out).astype(np.float32),
                # float_out: skip the requant, emit float at true scale
                "sout": s_out.astype(np.float32) if tail else None,
                "relu": relu,
                "kind": sp["kind"],
                "stride": sp["stride"],
            }
        else:
            q[tag] = {
                "quant": False,
                "w": w.astype(np.float32),  # input scale already folded in
                "b": b.astype(np.float32),
                "inv_sout": None if (s_out is None or tail)
                else (1.0 / s_out).astype(np.float32),
                "float_in": False,
                "relu": relu,
                "kind": sp["kind"],
                "stride": sp["stride"],
            }
    return q


# ---------------------------------------------------------------------------
# The integer-domain forward
# ---------------------------------------------------------------------------


def _maxpool_q(q: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max pool of an int8 NHWC tensor, TF-SAME, padded with -128."""
    (pt, pb), (pl, pr) = same_pads(q.shape[1], 3, 2), same_pads(q.shape[2], 3, 2)
    p = F.pad(q, (0, 0, pl, pr, pt, pb), value=-128)
    ho, wo = -(-q.shape[1] // 2), -(-q.shape[2] // 2)
    out = None
    for dy in range(3):
        for dx in range(3):
            win = p[:, dy: dy + 2 * ho - 1: 2, dx: dx + 2 * wo - 1: 2]
            out = win if out is None else torch.maximum(out, win)
    return out.contiguous()


def _add_q(a, m_a, b, m_b):
    """Residual add of two int8 tensors, each at its own per-channel scale:
    a float32 multiply-add at the sum's scale, then round half to even and
    clip to [-127, 127]."""
    s = a.float() * m_a + b.float() * m_b
    return torch.clamp(torch.round(s), -127, 127).to(torch.int8)


def _depthwise_s8(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME depthwise conv of an int8 NHWC tensor with int32 (3, 3, C)
    taps: nine shifted int32 multiply-adds, exact."""
    b, h, wd, c = q.shape
    p = F.pad(q.to(torch.int32), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, h, wd, c), dtype=torch.int32, device=q.device)
    for dy in range(3):
        for dx in range(3):
            acc += p[:, dy: dy + h, dx: dx + wd] * w[dy, dx]
    return acc


def _device_params(qparams: dict, device: torch.device) -> dict:
    """``quantize_folded``'s parameters as tensors on ``device`` (packed
    int8 weights, float32 vectors), made once per device and kept in
    ``qparams["_device"]``."""
    cache = qparams.setdefault("_device", {})
    key = str(device)
    if key in cache:
        return cache[key]

    def t(a):
        return None if a is None else torch.tensor(np.ascontiguousarray(a), device=device)

    out = {"inv_img": t((1.0 / qparams["_img_scale"]).astype(np.float32))}
    for tag, sp in qparams.items():
        if tag.startswith("_add."):
            out[tag] = {"mA": t(sp["mA"]), "mB": t(sp["mB"])}
        elif not tag.startswith("_"):
            d = {k: sp[k] for k in ("quant", "relu", "kind", "stride")}
            if sp["quant"] and sp["kind"] == "dw":
                d.update(w=t(sp["wq"][:, :, 0, :].astype(np.int32)), m=t(sp["m"]), c=t(sp["c"]))
            elif sp["quant"]:
                d.update(packed=pack_weights(sp["wq"]).to(device), kh=sp["wq"].shape[0],
                         m=t(sp["m"]), c=t(sp["c"]), sout=t(sp["sout"]))
            else:
                d.update(w=t(np.transpose(sp["w"], (3, 2, 0, 1))), b=t(sp["b"]), inv_sout=t(sp["inv_sout"]))
            out[tag] = d
    cache[key] = out
    return out


def forward_quant(qparams, x, float_dtype=torch.bfloat16):
    """The integer-domain w8a8 forward (NHWC in, float32 probabilities out).

    Every inter-op tensor is int8 (relu = max(q, 0), max pool on int8;
    residual adds through ``_add_q``). Each conv is s8 x s8 -> s32 with the
    dequant + bias + relu + requant epilogue fused (``ops/int8_conv.py``;
    the depthwise ones ``_depthwise_s8``). Only the float tail and the head
    run in ``float_dtype``, the head's products summed in float32."""
    P = _device_params(qparams, x.device)
    n_down, n_up = qparams["_n"]["down"], qparams["_n"]["up"]

    def conv(tag, q):
        sp = P[tag]
        if sp["quant"]:
            out_dtype = torch.int8 if sp.get("sout") is None else float_dtype
            if sp["kind"] == "dw":
                return epilogue_plain(_depthwise_s8(q, sp["w"]), sp["m"], sp["c"], sp["relu"], out_dtype, None)
            return conv2d_s8(q.contiguous(), sp["packed"], sp["kh"], sp["stride"], sp["m"], sp["c"],
                             sp["relu"], out_dtype, sp["sout"])
        # float conv (the head, or a tag left out of quantization): the
        # input storage scale is already folded into w; inputs and weights
        # rounded to float_dtype, products summed in float32
        w = sp["w"].to(float_dtype).float()
        groups = w.shape[0] if sp["kind"] == "dw" else 1
        y = _conv_nhwc(q.to(float_dtype).float(), w, sp["stride"], groups) + sp["b"]
        if sp["relu"]:
            y = torch.clamp_min(y, 0.0)
        if sp["inv_sout"] is None:
            return y  # head: stays float
        return torch.clamp(torch.round(y * sp["inv_sout"]), -127, 127).to(torch.int8)

    with torch.no_grad():
        q = torch.clamp(torch.round(x.float() * P["inv_img"]), -127, 127).to(torch.int8)
        q = conv("entry", q)  # relu folded into the epilogue; prev is the post-relu output
        prev = q
        for i in range(n_down):
            h = torch.clamp_min(q, 0) if i != 0 else q
            h = conv(f"d{i}.pw1", conv(f"d{i}.dw1", h))  # pw1's epilogue applied relu
            h = _maxpool_q(conv(f"d{i}.pw2", conv(f"d{i}.dw2", h)))
            ad = P[f"_add.d{i}"]
            q = _add_q(h, ad["mA"], conv(f"d{i}.res", prev), ad["mB"])
            prev = q
        for j in range(n_up):
            h = conv(f"u{j}.t2", conv(f"u{j}.t1", torch.clamp_min(q, 0)))  # t1's epilogue applied relu
            h = _upsample2(h)
            res = _upsample2(conv(f"u{j}.res", prev))
            if h.dtype == torch.int8:
                au = P[f"_add.u{j}"]
                q = _add_q(h, au["mA"], res, au["mB"])
            else:  # float tail: operands already at true scale
                q = h + res
            prev = q
        return torch.sigmoid(conv("head", q).float())


# ---------------------------------------------------------------------------
# Mixed precision: int8 only at the deep up convs
# ---------------------------------------------------------------------------

# the sites where s8 x s8 beat bf16 on the TPU (the JAX module's choice,
# kept so that the two packages quantise the same convs)
DEFAULT_MIXED_TAGS = ("u0.t1", "u0.t2", "u1.t1", "u1.t2", "u2.t1", "u2.t2")


def quantize_mixed(
    folded, scales: Dict[str, np.ndarray],
    tags: Sequence[str] = DEFAULT_MIXED_TAGS,
) -> Dict[str, dict]:
    """Per-conv int8 parameters for the mixed forward: float storage
    everywhere; the listed convs requantize their input on the fly and
    dequantize exactly (no output rounding)."""
    q: Dict[str, dict] = {"_n": folded["_n"], "_mixed": True}
    for tag, sp in folded.items():
        if tag == "_n":
            continue
        if tag not in tags:
            q[tag] = {**sp, "quant": False}
            continue
        s_in = np.asarray(scales[tag], np.float64)
        w = sp["w"].astype(np.float64)
        if sp["kind"] == "dw":
            w = w * s_in[None, None, None, :]
        else:
            w = w * s_in[None, None, :, None]
        s_w = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        s_w = np.where(s_w == 0, 1.0, s_w)
        b = np.zeros(w.shape[-1]) if sp["b"] is None else sp["b"]
        q[tag] = {
            "quant": True,
            "wq": np.clip(np.round(w / s_w), -127, 127).astype(np.int8),
            "inv_sx": (1.0 / s_in).astype(np.float32),
            "eff": s_w.astype(np.float32),
            "b": b.astype(np.float32),
            "kind": sp["kind"],
            "stride": sp["stride"],
        }
    return q


def _unet_folded(qparams) -> dict:
    """``quantize_mixed``'s float layers in ``UNetXception``'s layout, an
    int8 up conv's float kernel None."""
    n_down, n_up = qparams["_n"]["down"], qparams["_n"]["up"]

    def w(tag):
        return qparams[tag]["w"]

    def up_kernel(tag):
        return None if qparams[tag]["quant"] else w(tag)

    down = [{"dw1": np.ascontiguousarray(w(f"d{i}.dw1")[:, :, 0, :].reshape(9, -1)),
             "w1": w(f"d{i}.pw1")[0, 0], "b1": qparams[f"d{i}.pw1"]["b"],
             "dw2": np.ascontiguousarray(w(f"d{i}.dw2")[:, :, 0, :].reshape(9, -1)),
             "w2": w(f"d{i}.pw2")[0, 0], "b2": qparams[f"d{i}.pw2"]["b"],
             "wr": w(f"d{i}.res")[0, 0], "br": qparams[f"d{i}.res"]["b"]} for i in range(n_down)]
    up = [{"k1": up_kernel(f"u{j}.t1"), "b1": qparams[f"u{j}.t1"]["b"],
           "k2": up_kernel(f"u{j}.t2"), "b2": qparams[f"u{j}.t2"]["b"],
           "wr": w(f"u{j}.res")[0, 0], "br": qparams[f"u{j}.res"]["b"]} for j in range(n_up)]
    return {"entry": {"k": w("entry"), "b": qparams["entry"]["b"]}, "down": down, "up": up,
            "head": {"k": w("head"), "b": qparams["head"]["b"]}}


class MixedUNetXception(UNetXception):
    """The port's ``UNetXception`` forward (its down blocks on the
    down-block kernel) with the int8 up convs of ``quantize_mixed``'s
    parameters: each requantises its input (``clip(round(h * inv_sx))``),
    then ``ops/int8_conv.py`` computes ``acc * eff + b`` in ``dtype``. Only
    up convs may be int8 here."""

    def __init__(self, qparams, dtype: torch.dtype = torch.float32):
        tags = {tag for tag, sp in qparams.items() if not tag.startswith("_") and sp["quant"]}
        up_tags = {f"u{j}.t{i}" for j in range(qparams["_n"]["up"]) for i in (1, 2)}
        if not tags <= up_tags:
            raise ValueError(f"the mixed forward takes int8 up convs only, not {sorted(tags - up_tags)}")
        super().__init__(_unet_folded(qparams), dtype)
        self.int8_tags = tags
        for tag in tags:
            sp, name = qparams[tag], tag.replace(".", "_")
            self.register_buffer(f"{name}_packed", pack_weights(sp["wq"]))
            for key in ("inv_sx", "eff", "b"):
                self.register_buffer(f"{name}_{key}", torch.tensor(sp[key], dtype=torch.float32))

    def up_conv(self, j: int, i: int, h: torch.Tensor) -> torch.Tensor:
        tag = f"u{j}.t{i}"
        if tag not in self.int8_tags:
            return super().up_conv(j, i, h)
        name = tag.replace(".", "_")
        hq = torch.clamp(torch.round(h.float() * getattr(self, f"{name}_inv_sx")), -127, 127).to(torch.int8)
        return conv2d_s8(hq, getattr(self, f"{name}_packed"), 3, 1, getattr(self, f"{name}_eff"),
                         getattr(self, f"{name}_b"), out_dtype=self.dtype)


def forward_mixed(qparams, x, float_dtype=torch.bfloat16):
    """The mixed forward of a batch (a ``MixedUNetXception`` made for it)."""
    return MixedUNetXception(qparams, float_dtype).to(x.device).eval()(x)


# ---------------------------------------------------------------------------
# Public entry + scale persistence
# ---------------------------------------------------------------------------


def ckpt_fingerprint(checkpoint_file) -> dict:
    """Content-stable checkpoint identity: size + blake2b of the first and
    last 64 KiB (``tmat_tpu/core/aot_cache.py::ckpt_fingerprint``, so both
    packages accept one sidecar)."""
    size = os.stat(checkpoint_file).st_size
    h = hashlib.blake2b(digest_size=16)
    with open(checkpoint_file, "rb") as fp:
        h.update(fp.read(65536))
        if size > 131072:
            fp.seek(-65536, os.SEEK_END)
        h.update(fp.read(65536))
    return {"size": size, "blake2b16": h.hexdigest()}


def scales_path_for(checkpoint_file) -> Path:
    return Path(str(checkpoint_file) + ".quant.json")


def load_scales(path) -> Optional[Dict[str, np.ndarray]]:
    path = Path(path)
    if not path.is_file():
        return None
    with open(path) as fp:
        return {
            k: np.asarray(v, np.float32)
            for k, v in json.load(fp).items()
            if not k.startswith("_")
        }


def save_scales(path, scales: Dict[str, np.ndarray], extra: Optional[dict] = None) -> None:
    doc = {k: np.asarray(v).tolist() for k, v in scales.items()}
    if extra:
        doc.update(extra)
    with open(path, "w") as fp:
        json.dump(doc, fp, indent=1, sort_keys=True)


def load_scales_for(checkpoint_file) -> Optional[Dict[str, np.ndarray]]:
    """Sidecar scales, but only if they were calibrated against the current
    checkpoint bytes: a retrained checkpoint must be recalibrated."""
    path = scales_path_for(checkpoint_file)
    if not path.is_file():
        return None
    with open(path) as fp:
        doc = json.load(fp)
    if doc.get("_ckpt") != ckpt_fingerprint(checkpoint_file):
        return None
    return {
        k: np.asarray(v, np.float32)
        for k, v in doc.items()
        if not k.startswith("_")
    }


def save_scales_for(checkpoint_file, scales: Dict[str, np.ndarray]) -> None:
    save_scales(
        scales_path_for(checkpoint_file), scales,
        extra={"_ckpt": ckpt_fingerprint(checkpoint_file)},
    )


def make_quant_pred_fn(
    variables,
    filter_counts: Sequence[int],
    scales: Optional[Dict[str, np.ndarray]] = None,
    calib_batch: Optional[np.ndarray] = None,
    patch_size: int = 320,
    quantize_depthwise: bool = True,
    float_dtype=torch.bfloat16,
    mode: str = "mixed",
    device: DeviceLike = None,
) -> Tuple[Callable, Dict[str, np.ndarray]]:
    """The quantized pred_fn on ``device`` (None = CUDA) and its scales.

    Scales: explicit ``scales`` > calibration on ``calib_batch`` >
    calibration on the default synthetic batch. ``mode``: "mixed" (a
    ``MixedUNetXception``, the default) or "int8" (``forward_quant``)."""
    dev = resolve_device(device)
    folded = extract_folded(variables, filter_counts)
    if scales is None:
        if calib_batch is None:
            calib_batch = default_calibration_batch(patch_size)
        scales = calibrate(folded, calib_batch, dev)
    if mode == "mixed":
        return MixedUNetXception(quantize_mixed(folded, scales), float_dtype).to(dev).eval(), scales
    if mode != "int8":
        raise ValueError(f"mode is 'mixed' or 'int8', not {mode!r}")
    qparams = quantize_folded(folded, scales, quantize_depthwise=quantize_depthwise)
    _device_params(qparams, dev)

    def pred_fn(batch):
        return forward_quant(qparams, batch, float_dtype=float_dtype)

    return pred_fn, scales
