"""Flax conventions shared by the trainable UNet and ResNet.

The trainable models (``unet.TrainableUNetXception``,
``resnet.TrainableResNet50TL``) keep every weight in Flax's layout (conv
kernels ``(kh, kw, in, out)``, dense kernels ``(in, out)``) under a
state-dict name that is its Flax path: ``Conv_0.kernel``,
``SeparableConv_0.depthwise.kernel``, ``BatchNorm_0.mean``,
``base_model.conv2_block1.0_conv.kernel``. Registered in Flax's creation
order, that makes the ``{"params", "batch_stats"}`` tree of
``tmat_tpu``'s modules a one-to-one view of the state dict
(``flax_variables``, ``load_flax_variables``), names and key order included.

- ``BatchNorm``: ``flax.linen.BatchNorm`` over the last axis: batch
  statistics in float32 with the biased variance E[x²] − E[x]² (clipped at
  0), the running update ``ra = m·ra + (1 − m)·batch`` (PyTorch's
  ``BatchNorm2d`` keeps the unbiased variance and calls ``1 − m`` its
  momentum), and ``(x − mean)·(rsqrt(var + eps)·scale) + bias``. With
  ``use_running_average`` it always normalises with the running statistics,
  in training too.
- ``init_kernels``: Flax's ``model.init(PRNGKey(seed))`` for the kernels:
  each is lecun-normal (a normal truncated at ±2σ, σ = sqrt(1/fan_in)/0.8796…)
  drawn from the key Flax derives from its path and its place in its
  module (``core/prng.py``), so the same seed gives the JAX package's
  values.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn

from tmat_torch.core import prng

STATS = ("mean", "var")  # the batch_stats leaves; every other leaf is a param


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis (see the module doc)."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-3,
                 use_running_average: bool = False):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.use_running_average = use_running_average
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.use_running_average:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class Conv(nn.Module):
    """A Flax ``nn.Conv`` / ``nn.ConvTranspose`` / ``nn.Dense``'s weights:
    ``kernel`` of ``shape`` (the output features last) and an optional
    ``bias``. The model that owns it applies it."""

    def __init__(self, shape: Sequence[int], bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(tuple(shape)))
        self.bias = nn.Parameter(torch.zeros(shape[-1])) if bias else None

    def oihw(self) -> torch.Tensor:
        """The conv kernel as PyTorch's (out, in, kh, kw), stored channels
        last (the layout of the NHWC activations it meets); a float64 kernel
        (a reference model) in the default layout, the only one PyTorch's
        float64 convolution backward on the CPU takes."""
        fmt = torch.contiguous_format if self.kernel.dtype == torch.float64 else torch.channels_last
        return self.kernel.permute(3, 2, 0, 1).contiguous(memory_format=fmt)


def init_kernels(module: nn.Module, seed: int, zero: Sequence[str] = ()) -> None:
    """Draw every ``kernel`` of ``module`` as Flax's ``model.init(
    jax.random.PRNGKey(seed))`` does, on the kernel's device: lecun-normal
    from ``prng.flax_param_key(root, path, counter)``, where ``path`` is the
    module scope of its Flax name and ``counter`` its place among that
    scope's params in the Flax tree (kernel 1, bias 2; a BatchNorm's scale
    and bias count too). The kernels named in ``zero`` (state-dict names)
    start at zero."""
    root = prng.prng_key(seed)
    counters: Dict[str, int] = {}
    kernels, keys = [], []
    for key, t in module.state_dict(keep_vars=True).items():
        scope, leaf = key.rsplit(".", 1)
        if leaf in STATS:
            continue
        counters[scope] = counters.get(scope, 0) + 1
        if leaf == "kernel" and key not in zero:
            kernels.append(t)
            keys.append(prng.flax_param_key(root, scope.split("."), counters[scope]))
    if not kernels:
        return
    drawn = prng.lecun_normal(keys, [tuple(t.shape) for t in kernels], kernels[0].device)
    with torch.no_grad():
        for t, value in zip(kernels, drawn):
            t.copy_(value)


def nest_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": v} -> {"a": {"b": {"c": v}}}, in the keys' order."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of ``nest_tree``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def flax_variables(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The Flax ``{"params", "batch_stats"}`` tree of ``module``'s state, as
    float32 numpy arrays (copies), in Flax's names, layouts and key order."""
    params, stats = {}, {}
    for key, t in module.state_dict().items():
        (stats if key.rsplit(".", 1)[-1] in STATS else params)[key] = (
            t.detach().to("cpu", torch.float32).numpy().copy())
    return {"params": nest_tree(params), "batch_stats": nest_tree(stats)}


def load_flax_variables(module: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy a Flax ``{"params", "batch_stats"}`` tree into ``module``: every
    leaf must be present, with its shape; values are cast to float32."""
    flat = {**flatten_tree(variables.get("params", {})), **flatten_tree(variables.get("batch_stats", {}))}
    state = module.state_dict()
    if set(flat) != set(state):
        diff = sorted(set(flat) ^ set(state))
        raise ValueError(f"variables do not fit the model: {diff[:6]}")
    with torch.no_grad():
        for key, t in state.items():
            value = torch.tensor(np.asarray(flat[key], np.float32))
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)}, the model has {tuple(t.shape)}")
            t.copy_(value)
    return module
