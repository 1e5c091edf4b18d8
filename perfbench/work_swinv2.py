"""The work of the SwinV2 ensemble: each layer's operations a forward,
counted from the configuration's sizes, the least time of a window
attention call, counted from its shapes (peaks from ``work.py``), and the
kernels that make up such a call on the card (``attention_calls``).

The forward counts each layer's multiply-adds (two operations each) as
``work.py`` counts ResNet50's, so that a later change that fuses or
replaces the program's modules cannot change what a forward is worth:
normalisations, the softmax, rolls and gathers are not counted, nor the
position bias's MLP, which does not depend on the input.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# The kernels of one ``models/swin.py::window_attention`` call on the card,
# by a part of their names (any case): the first it launches (q's L2 norm,
# ``F.normalize``'s reduction) and the last (SDPA's fused kernel: cuDNN's,
# the memory-efficient or the flash one); between them k's norm, the
# divisions and the logit scale. A kernel that takes the place of either end
# (a fused window attention kernel: both) joins its list.
ATTN_FIRST_KERNELS = ("normtwoops",)
ATTN_LAST_KERNELS = ("sdpa", "fmha", "flash_fwd", "attention")

from perfbench.work import PEAK_BF16_TC, PEAK_BYTES, PEAK_F32


def blocks(config: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(stage, dim, heads, grid, window) of each block, in order: stage i
    at ``embed_dim·2^i`` on a ``(size/patch)/2^i`` grid, window ``min(
    window, grid)``."""
    grid = config["input_shape"][0] // config["patch"]
    for i, (depth, heads) in enumerate(zip(config["depths"], config["heads"])):
        dim = config["embed_dim"] * 2**i
        for _ in range(depth):
            yield i, dim, heads, grid, min(config["window"], grid)
        grid //= 2


def swinv2_layers(config: Dict) -> List[Tuple[str, int]]:
    """(layer, operations) of one image through the SwinV2 classifier:
    the patch embedding, per block the qkv, QKᵀ, AV, proj, fc1 and fc2
    products, per stage but the last the merge's reduction, then global
    average pooling (one addition an input) and the dense head."""
    p, c0, r = config["patch"], config["embed_dim"], config["mlp_ratio"]
    g0 = config["input_shape"][0] // p
    out = [("patch_embed", 2 * g0 * g0 * p * p * 3 * c0)]
    last_stage = len(config["depths"]) - 1
    for j, (i, c, _, g, w) in enumerate(blocks(config)):
        t, n = g * g, w * w
        out += [(f"block{j}.qkv", 2 * t * c * 3 * c), (f"block{j}.qk", 2 * t * n * c),
                (f"block{j}.av", 2 * t * n * c), (f"block{j}.proj", 2 * t * c * c),
                (f"block{j}.fc1", 2 * t * c * r * c), (f"block{j}.fc2", 2 * t * r * c * c)]
    g, c = g0, c0
    for i in range(last_stage):
        out.append((f"merge{i}", 2 * (g // 2) ** 2 * 4 * c * 2 * c))
        g, c = g // 2, 2 * c
    n_out = config.get("n_outputs", 1)
    out += [("gap", g * g * c), ("head", 2 * c * n_out)]
    return out


def swinv2_flops(config: Dict) -> int:
    """Operations of one image's forward through one member."""
    return sum(v for _, v in swinv2_layers(config))


def windows_per_image(config: Dict) -> int:
    """Windows through the window attention in one image's forward."""
    return sum((g // w) ** 2 for _, _, _, g, w in blocks(config))


def attention_bound_s(config: Dict, batch: int, itemsize: int = 2) -> float:
    """The least time of one forward's window attention calls on ``batch``
    images (``window_attn_work`` of each block's call): a block that shifts
    (an odd block where the grid exceeds the window) reads a table a window,
    the others one table."""
    total, prev = 0.0, None
    for stage, dim, heads, grid, w in blocks(config):
        j = 0 if stage != prev else j + 1
        prev = stage
        n_w = (grid // w) ** 2
        tables = n_w if j % 2 and grid > w else 1
        total += window_attn_work((batch * n_w, heads, w * w, dim // heads), (tables, heads, w * w, w * w), None,
                                  itemsize)["bound_s"]
    return total


def window_attn_work(q_shape: Sequence[int], bias_shape: Sequence[int], mask_shape: Optional[Sequence[int]],
                     itemsize: int) -> dict:
    """What one window attention call must do and move, and the least time
    the card could take for it: the QKᵀ and AV products of (B·nW, heads, N,
    d) windows (on the tensor cores in bf16, ``itemsize`` 2); q, k, v and
    the output each read or written once, and the bias table and the mask
    as the call is given them, read once."""
    bw, heads, n, d = q_shape
    flops = 2 * 2 * bw * heads * n * n * d
    nbytes = (4 * bw * heads * n * d + prod(bias_shape) + (prod(mask_shape) if mask_shape else 0)) * itemsize
    ops_s = flops / (PEAK_BF16_TC if itemsize == 2 else PEAK_F32)
    bytes_s = nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "ops_s": ops_s, "bytes_s": bytes_s, "bound_s": max(ops_s, bytes_s)}


def attention_calls(device_ops: Sequence[Tuple[float, float, str, object]]) -> List[float]:
    """The device seconds of each window attention call in ``device_ops``
    ((start µs, end µs, name, correlation) in device order, one stream, as
    ``trace.TraceSummary.device``): the kernels from one whose name has a
    part of ``ATTN_FIRST_KERNELS`` to the next with a part of
    ``ATTN_LAST_KERNELS``, both in."""
    calls, start = [], None
    for i, (_, _, name, _) in enumerate(device_ops):
        name = name.lower()
        if start is None and any(k in name for k in ATTN_FIRST_KERNELS):
            start = i
        if start is not None and any(k in name for k in ATTN_LAST_KERNELS):
            calls.append(sum(b - a for a, b, _, _ in device_ops[start:i + 1]) / 1e6)
            start = None
    return calls
