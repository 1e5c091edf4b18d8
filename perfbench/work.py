"""The benchmark's yardstick: peaks, the work of the kernels and of whole
forwards counted from the configurations' layer shapes, and the union of
device intervals.

Frozen copies, taken when the benchmark was written, of ``chip_smoke.py``'s
``block_work``, ``focus_work`` (with ``FOCUS_FLOPS``) and ``_union_us``.
The UNet and ResNet50 counts are new: they count each layer's
multiply-adds (two operations each) from the configuration, so that a
later change that fuses or replaces the program's modules cannot change
what a forward is worth.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, f32 on the
# CUDA cores, HBM3 bandwidth. The card's power limit is printed beside them.
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# focus stacking, per pixel and slice: multiply-adds of the taps (blur
# 2 x 5, Laplacian 2 x (3 + 5)), two operations each, and the compare
FOCUS_FLOPS = 2 * (2 * 5 + 2 * (3 + 5)) + 1


def block_work(b: int, h: int, c: int, f: int, itemsize: int = 2) -> dict:
    """What one down-block call must do and move, and the least time the
    card could take for it. Products (pw1, pw2, the residual) run on the
    tensor cores in bf16 (``itemsize`` 2); the depthwise taps and the pool
    are f32 work on the CUDA cores, side by side with them. Bytes: each
    input read once, the output written once."""
    hw, ho = h * h, (h // 2) ** 2
    products = (2 * hw * c * f + 2 * hw * f * f + 2 * ho * c * f) * b
    taps = (2 * 9 * hw * c + 2 * 9 * hw * f + 9 * ho * f) * b
    weights = (9 * c + c * f + 9 * f + f * f + c * f) * itemsize + 3 * f * 4
    nbytes = (b * hw * c + b * ho * f) * itemsize + weights
    if itemsize == 2:
        ops_s = max(products / PEAK_BF16_TC, taps / PEAK_F32)
    else:
        ops_s = (products + taps) / PEAK_F32
    bytes_s = nbytes / PEAK_BYTES
    return {"flops": products + taps, "bytes": nbytes, "ops_s": ops_s, "bytes_s": bytes_s,
            "bound_s": max(ops_s, bytes_s)}


def focus_work(z_counts: Sequence[int], h: int, w: int, itemsize: int) -> dict:
    """What one focus-stacking call must do and move: each stack's first
    ``z_count`` slices read once and one projection written, each in its
    own type; FOCUS_FLOPS float32 operations per pixel and slice read."""
    slices, stacks = int(sum(z_counts)), len(z_counts)
    nbytes = (slices + stacks) * h * w * itemsize + 4 * stacks
    flops = slices * h * w * FOCUS_FLOPS
    ops_s, bytes_s = flops / PEAK_F32, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "ops_s": ops_s, "bytes_s": bytes_s,
            "bound_s": max(ops_s, bytes_s)}


def _conv(h_out: int, w_out: int, k: int, cin: int, cout: int, groups: int = 1) -> int:
    return 2 * h_out * w_out * k * k * (cin // groups) * cout


def unet_layers(patch: int, filters: Sequence[int], channels: int = 1,
                n_outputs: int = 1) -> List[Tuple[str, int]]:
    """(layer, operations) of one patch through the UNet-Xception of the
    Keras example at these widths: the entry 3x3/2 conv, per down block two
    separable convs (depthwise 3x3 and pointwise), the 3x3/2 max pool (9
    compares an output) and the 1x1/2 residual, per up block two 3x3
    convs and the 1x1 residual (the x2 upsample copies), and the 3x3 head."""
    f = sorted(filters)
    s = patch // 2
    out = [("entry", _conv(s, s, 3, channels, f[0]))]
    prev = f[0]
    for i, width in enumerate(f[1:]):
        out += [(f"down{i}.dw1", _conv(s, s, 3, prev, prev, prev)),
                (f"down{i}.pw1", _conv(s, s, 1, prev, width)),
                (f"down{i}.dw2", _conv(s, s, 3, width, width, width)),
                (f"down{i}.pw2", _conv(s, s, 1, width, width)),
                (f"down{i}.pool", 9 * (s // 2) ** 2 * width),
                (f"down{i}.res", _conv(s // 2, s // 2, 1, prev, width))]
        prev, s = width, s // 2
    for j, width in enumerate(reversed(f)):
        out += [(f"up{j}.conv1", _conv(s, s, 3, prev, width)),
                (f"up{j}.conv2", _conv(s, s, 3, width, width)),
                (f"up{j}.res", _conv(s, s, 1, prev, width))]
        prev, s = width, 2 * s
    out.append(("head", _conv(s, s, 3, prev, n_outputs)))
    return out


def unet_flops(patch: int, filters: Sequence[int], channels: int = 1) -> int:
    """Operations of one patch's forward."""
    return sum(v for _, v in unet_layers(patch, filters, channels))


_STAGES = {2: (3, 64), 3: (4, 128), 4: (6, 256), 5: (3, 512)}


def resnet50_layers(hw: int, last_layer: str, n_outputs: int = 1) -> List[Tuple[str, int]]:
    """(layer, operations) of one image through Keras' ResNet50 v1 (He et
    al. 2015; the stride on a stage's first 1x1) up to ``last_layer``
    (``convS_blockB_out``), then global average pooling (counted as one
    addition an input) and the dense head."""
    last_stage, last_block = int(last_layer.split("_")[0][4:]), int(last_layer.split("_")[1][5:])
    s = (hw + 1) // 2
    out = [("conv1", _conv(s, s, 7, 3, 64)), ("pool1", 9 * ((s + 1) // 2) ** 2 * 64)]
    s, cin = (s + 1) // 2, 64
    for stage in range(2, last_stage + 1):
        blocks, width = _STAGES[stage]
        for block in range(1, (blocks if stage < last_stage else last_block) + 1):
            stride = 2 if (stage > 2 and block == 1) else 1
            so = (s + stride - 1) // stride
            name = f"conv{stage}_block{block}"
            if block == 1:
                out.append((f"{name}.0", _conv(so, so, 1, cin, 4 * width)))
            out += [(f"{name}.1", _conv(so, so, 1, cin, width)),
                    (f"{name}.2", _conv(so, so, 3, width, width)),
                    (f"{name}.3", _conv(so, so, 1, width, 4 * width))]
            s, cin = so, 4 * width
    out += [("gap", s * s * cin), ("head", 2 * cin * n_outputs)]
    return out


def resnet50_flops(hw: int, last_layer: str) -> int:
    """Operations of one image's forward through one member."""
    return sum(v for _, v in resnet50_layers(hw, last_layer))


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, stop) intervals."""
    total, end = 0.0, -float("inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total
