"""Convert Keras .h5 weight files into Flax-layout msgpack checkpoints.

Counterpart of ``tmat_tpu/models/convert.py``, on the port's own
templates (``layers.flax_variables`` of a freshly built trainable model,
whose tree has Flax's names and key order) and writer
(``params_io.save_params``): the same ``.h5`` gives the same tree and the
same file bytes in both packages. ``h5py`` is imported inside the
readers; conversion runs on the CPU.

Supports the reference's artifacts (best_finetune_weights_{i}.h5,
checkpoint_{n}.h5 / .weights.h5) saved by tf.keras save_weights: the legacy
HDF5 layout (top-level layer groups with a ``weight_names`` attribute).

Mapping rules:
- ResNet50-TL: by Keras layer NAME (conv{s}_block{b}_{k}_conv / _bn,
  conv1_conv/bn, dense head) onto the identically-named Flax modules.
- UNet-Xception: by (layer type, per-type creation index): the Keras
  builder and the Flax module create layers in the same order, so Conv2D
  #k maps to Conv_k, SeparableConv2D #k to SeparableConv_k, etc.

Kernel layout transposes: Conv2D and Dense match Flax natively;
Conv2DTranspose (kh, kw, out, in) -> (kh, kw, in, out); depthwise kernels
(kh, kw, in, 1) -> (kh, kw, 1, in).

Usage:
    python -m tmat_torch.models.convert unet INPUT.h5 OUTPUT.msgpack \\
        --patch-size 320 --filters 64 128 256 512
    python -m tmat_torch.models.convert resnet INPUT.h5 OUTPUT.msgpack \\
        --last-layer conv4_block6_out
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Tuple

import numpy as np

from tmat_torch.models.layers import flatten_tree, flax_variables, nest_tree
from tmat_torch.models.params_io import save_params


def _iter_h5_layers(h5file) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """(layer_name, {weight_name: array}) in creation order."""
    import h5py

    root = h5file["model_weights"] if "model_weights" in h5file else h5file
    if "layer_names" in root.attrs:
        layer_names = [n.decode() if isinstance(n, bytes) else n for n in root.attrs["layer_names"]]
    else:
        layer_names = list(root.keys())

    layers = []
    for name in layer_names:
        weights = {}

        def visit(key, obj):
            if isinstance(obj, h5py.Dataset):
                weights[key.split("/")[-1].replace(":0", "")] = np.array(obj)

        root[name].visititems(visit)
        if weights:
            layers.append((name, weights))
    return layers


def _read_layers(h5_path: str):
    import h5py

    with h5py.File(h5_path, "r") as f:
        return _iter_h5_layers(f)


_TYPE_PATTERNS = [
    ("separable_conv2d", "SeparableConv"),
    ("conv2d_transpose", "ConvTranspose"),
    ("conv2d", "Conv"),
    ("batch_normalization", "BatchNorm"),
    ("dense", "Dense"),
]


def _keras_layer_type(name: str, weights: Dict) -> str:
    for pattern, type_name in _TYPE_PATTERNS:
        if re.match(rf"{pattern}(_\d+)?$", name):
            return type_name
    # fall back on weight structure
    if "depthwise_kernel" in weights:
        return "SeparableConv"
    if "gamma" in weights:
        return "BatchNorm"
    if "kernel" in weights and weights["kernel"].ndim == 2:
        return "Dense"
    if "kernel" in weights:
        return "Conv"
    return "Unknown"


def _bn_params(w):
    return {"scale": w["gamma"], "bias": w["beta"]}, {"mean": w["moving_mean"],
                                                      "var": w["moving_variance"]}


def _flat(template_variables):
    return (flatten_tree(template_variables["params"]),
            flatten_tree(template_variables.get("batch_stats", {})))


def convert_unet_weights(h5_path: str, template_variables) -> Dict:
    """Map a Keras UNetXception .h5 onto a Flax variables template."""
    params, stats = _flat(template_variables)
    counters = {"Conv": 0, "BatchNorm": 0, "SeparableConv": 0, "ConvTranspose": 0}
    for name, w in _read_layers(h5_path):
        ltype = _keras_layer_type(name, w)
        if ltype not in counters:
            continue
        prefix = f"{ltype}_{counters[ltype]}"
        counters[ltype] += 1
        if ltype == "Conv":
            params[f"{prefix}.kernel"] = w["kernel"]
            if "bias" in w:
                params[f"{prefix}.bias"] = w["bias"]
        elif ltype == "ConvTranspose":
            params[f"{prefix}.kernel"] = np.transpose(w["kernel"], (0, 1, 3, 2))
            if "bias" in w:
                params[f"{prefix}.bias"] = w["bias"]
        elif ltype == "SeparableConv":
            params[f"{prefix}.depthwise.kernel"] = np.transpose(w["depthwise_kernel"], (0, 1, 3, 2))
            params[f"{prefix}.pointwise.kernel"] = w["pointwise_kernel"]
            if "bias" in w:
                params[f"{prefix}.pointwise.bias"] = w["bias"]
        else:
            p, s = _bn_params(w)
            params[f"{prefix}.scale"], params[f"{prefix}.bias"] = p["scale"], p["bias"]
            stats[f"{prefix}.mean"], stats[f"{prefix}.var"] = s["mean"], s["var"]

    _check_shapes(params, template_variables["params"])
    return {"params": nest_tree(params), "batch_stats": nest_tree(stats)}


def convert_resnet_weights(h5_path: str, template_variables) -> Dict:
    """Map a Keras ResNet50-TL .h5 (named layers) onto a Flax template."""
    params, stats = _flat(template_variables)

    def put(path, value, tree):
        if path in tree:
            tree[path] = value

    for name, w in _read_layers(h5_path):
        m = re.match(r"conv(\d)_block(\d+)_(\d|0)_(conv|bn)$", name)
        if name in ("conv1_conv", "conv1_bn"):
            base = f"base_model.{name}"
        elif m:
            base = f"base_model.conv{m.group(1)}_block{m.group(2)}.{m.group(3)}_{m.group(4)}"
        elif _keras_layer_type(name, w) == "Dense":
            base = "head"
        else:
            continue
        if "kernel" in w:
            put(f"{base}.kernel", w["kernel"], params)
            if "bias" in w:
                put(f"{base}.bias", w["bias"], params)
        if "gamma" in w:
            p, s = _bn_params(w)
            put(f"{base}.scale", p["scale"], params)
            put(f"{base}.bias", p["bias"], params)
            put(f"{base}.mean", s["mean"], stats)
            put(f"{base}.var", s["var"], stats)

    _check_shapes(params, template_variables["params"])
    return {"params": nest_tree(params), "batch_stats": nest_tree(stats)}


def _check_shapes(flat_params, template_params):
    template = flatten_tree(template_params)
    for key, val in flat_params.items():
        want, got = np.shape(template[key]), np.shape(val)
        if tuple(want) != tuple(got):
            raise ValueError(f"shape mismatch at {key.replace('.', '/')}: h5 {got} vs model {want}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["unet", "resnet"])
    p.add_argument("input_h5")
    p.add_argument("output_msgpack")
    p.add_argument("--patch-size", type=int, default=320)
    p.add_argument("--filters", type=int, nargs="+", default=[64, 128, 256, 512])
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--last-layer", type=str, default="conv4_block6_out")
    p.add_argument("--img-size", type=int, default=256)
    args = p.parse_args(argv)

    if args.kind == "unet":
        from tmat_torch.models.unet import build_unet_xception

        template = flax_variables(build_unet_xception(
            1, (args.patch_size, args.patch_size), channels=args.channels,
            filter_counts=tuple(args.filters), device="cpu"))
        variables = convert_unet_weights(args.input_h5, template)
    else:
        from tmat_torch.models.resnet import build_trainable_resnet50_tl

        template = flax_variables(build_trainable_resnet50_tl(
            1, (args.img_size, args.img_size, 3), base_last_layer=args.last_layer, device="cpu"))
        variables = convert_resnet_weights(args.input_h5, template)

    save_params(args.output_msgpack, variables)
    print(f"Converted {args.input_h5} -> {args.output_msgpack}")


if __name__ == "__main__":
    main()
