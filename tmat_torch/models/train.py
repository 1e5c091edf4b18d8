"""Training harnesses: UNet segmentation and two-stage ResNet transfer learning.

Counterpart of ``tmat_tpu/models/train.py``: the thresholded smooth-IoU
metric and the weighted binary cross-entropy, the warmup and cosine-restart
schedules, the train state and its checkpoint, the steps, a Keras-style
``fit`` (early stopping, save-best), the two-stage transfer-learning recipe
(frozen base -> restore best -> fine-tune) and the UNet grid search.

What differs in form, not in result:

- A PyTorch module holds its weights, so a ``TrainState`` is the module,
  its ``torch.optim`` optimizer and the update count, and a step updates it
  in place (and returns it, as the JAX step returns the new state).
  ``fit``'s best state is a copy of the module taken at that epoch.
- ``adam`` and ``adamw`` stand for ``optax.adam`` and ``optax.adamw``
  (b1 0.9, b2 0.999, eps 1e-8 outside the square root; ``adamw``'s
  decoupled weight decay 1e-4 on every parameter, not PyTorch's 0.01). The
  learning rate of update n (counted from 0) is ``schedule(n)``: optax
  evaluates its schedule at the count before the update.
- ``make_tl_optimizer``'s frozen stage leaves the base out of the optimizer
  and out of autograd (optax's ``set_to_zero``): its tensors stay bit-equal.
- The UNet's forward is float32 and differentiates Flax's batch statistics
  as written (E[x²] − E[x]²); see ``layers.BatchNorm``.

Metrics stay on the device until an epoch ends. Checkpoints are Flax trees
(``params_io.save_params``): a best-weight checkpoint loads in either
package, and so does a train-state checkpoint, whose ``opt_state`` is the
state dict of the optax transformation the JAX trainer builds for the same
run (``Optimizer.state_tree``), with every dict's keys sorted as a jitted
JAX step leaves them: the file is byte-equal to
``flax.serialization.to_bytes`` of that JAX ``TrainState``.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from itertools import product as iter_product
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from tmat_torch.device import DeviceLike
from tmat_torch.models.layers import flatten_tree, flax_variables, load_flax_variables, nest_tree
from tmat_torch.models.params_io import load_variables, save_params


# --------------------------------------------------------------------------
# Metrics & losses
# --------------------------------------------------------------------------


def mean_iou_coef(y: torch.Tensor, yhat: torch.Tensor, smooth: float = 1.0,
                  obs_axes=(1, 2, 3), thresh: float = 0.5) -> torch.Tensor:
    """Thresholded smooth IoU, averaged over the batch."""
    y = y.float()
    yhat = (yhat.clamp(0, 1) > thresh).float()
    intersection = (y * yhat).sum(dim=obs_axes)
    union = y.sum(dim=obs_axes) + yhat.sum(dim=obs_axes) - intersection
    return ((intersection + smooth) / (union + smooth)).mean(dim=0)


def weighted_bce(probs: torch.Tensor, labels: torch.Tensor, sample_weights=None,
                 eps: float = 1e-7) -> torch.Tensor:
    """Binary cross-entropy on probabilities (Keras BinaryCrossentropy).
    Per-sample weights (B,) align on the batch axis."""
    probs = probs.clamp(eps, 1 - eps)
    losses = -(labels * torch.log(probs) + (1 - labels) * torch.log(1 - probs))
    if sample_weights is None:
        return losses.mean()
    w = torch.as_tensor(sample_weights, dtype=losses.dtype, device=losses.device)
    if w.dim() and w.dim() < losses.dim():
        w = w.reshape(tuple(w.shape) + (1,) * (losses.dim() - w.dim()))
    return (losses * w).sum() / torch.clamp(w.sum(), min=eps)


# --------------------------------------------------------------------------
# Schedules: step -> learning rate, in float32 as the JAX schedules compute
# --------------------------------------------------------------------------


def warmup_schedule(warmup_steps: int, after_warmup_lr) -> Callable[[int], np.float32]:
    """Linear warmup into a constant or another schedule."""
    warmup_steps = int(warmup_steps)
    if callable(after_warmup_lr):
        after = after_warmup_lr
        init = float(after_warmup_lr(0))
    else:
        lr = np.float32(after_warmup_lr)
        after = lambda step: lr  # noqa: E731
        init = float(after_warmup_lr)

    def schedule(step):
        step = np.float32(step)
        if step < warmup_steps:
            return np.float32(init * (step + 1) / max(warmup_steps, 1))
        return np.float32(after((step + 1) - warmup_steps))

    return schedule


def cosine_decay_restarts(initial_lr: float, first_decay_steps: int, t_mul: float = 2.0,
                          m_mul: float = 1.0, alpha: float = 0.0) -> Callable[[int], np.float32]:
    """Keras CosineDecayRestarts."""
    f32 = np.float32

    def schedule(step):
        ratio = f32(step) / f32(first_decay_steps)
        if t_mul == 1.0:
            i = np.floor(ratio)
            frac = ratio - i
        else:  # i = number of completed cycles
            i = np.floor(np.log1p(ratio * f32(t_mul - 1.0)) / np.log(f32(t_mul)))
            sum_prev = (f32(t_mul) ** i - f32(1.0)) / f32(t_mul - 1.0)
            frac = (ratio - sum_prev) / f32(t_mul) ** i
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        decayed = f32(1 - alpha) * cosine + f32(alpha)
        return f32(initial_lr) * f32(m_mul) ** i * decayed

    return schedule


# --------------------------------------------------------------------------
# Optimizers, train state & steps
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Optimizer:
    """Adam with decoupled weight decay under a learning rate or schedule:
    what an optax ``adam`` / ``adamw`` transformation names (``transform``).
    ``frozen`` names a submodule whose parameters it does not train: optax's
    ``multi_transform`` of the adam and ``set_to_zero``."""

    learning_rate: Union[float, Callable[[int], float]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    frozen: Optional[str] = None
    transform: str = "adam"

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def state_tree(self, adam_state: Dict[str, Any]) -> Dict[str, Any]:
        """The state dict of this optax transformation around ``adam_state``
        (``scale_by_adam``'s ``{"count", "mu", "nu"}``): ``adam`` is
        ``chain(scale_by_adam, scale_by_learning_rate)``, ``adamw`` puts
        ``add_decayed_weights`` between them; a schedule's state is its
        count, a constant rate's is empty."""
        schedule = {"count": adam_state["count"]} if callable(self.learning_rate) else {}
        if self.frozen is not None:
            return {"inner_states": {"freeze": {"inner_state": {}},
                                     "train": {"inner_state": {"0": adam_state, "1": schedule}}}}
        if self.transform == "adamw":
            return {"0": adam_state, "1": {}, "2": schedule}
        return {"0": adam_state, "1": schedule}

    def adam_state(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """``scale_by_adam``'s state out of a ``state_tree``; a tree of
        another transformation raises."""
        marker = {"count": None}
        found = []

        def fits(expected, got) -> bool:
            if expected is marker:
                found.append(got)
                return isinstance(got, dict) and set(got) == {"count", "mu", "nu"}
            if isinstance(expected, dict):
                return (isinstance(got, dict) and set(got) == set(expected)
                        and all(fits(expected[k], got[k]) for k in expected))
            return not isinstance(got, dict)  # the schedule's count

        if not fits(self.state_tree(marker), tree):
            name = "multi_transform" if self.frozen is not None else self.transform
            raise ValueError(f"the optimizer state is not that of optax's {name} with this learning rate")
        return found[0]

    def init(self, module: nn.Module) -> torch.optim.Optimizer:
        """A fresh optimizer (moments 0, count 0) over ``module``'s trained
        parameters; the frozen ones stop requiring gradients."""
        params = []
        for name, p in module.named_parameters():
            trained = self.frozen is None or not name.startswith(self.frozen + ".")
            p.requires_grad_(trained)
            if trained:
                params.append(p)
        return torch.optim.AdamW(params, lr=self.lr(0), betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam``."""
    return Optimizer(learning_rate, b1, b2, eps)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw``."""
    return Optimizer(learning_rate, b1, b2, eps, weight_decay, transform="adamw")


@dataclass
class TrainState:
    """A module, its optimizer (and the ``Optimizer`` that made it) and the
    number of updates made."""

    module: nn.Module
    opt: Optional[torch.optim.Optimizer]
    step: int = 0
    tx: Optional[Optimizer] = None

    def copy(self) -> "TrainState":
        """The module's weights and statistics as they are now (a deep copy,
        without gradients); no optimizer."""
        module = copy.deepcopy(self.module)
        for p in module.parameters():
            p.grad = None
        return TrainState(module, None, self.step)


def init_train_state(module: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(module, tx.init(module), 0, tx)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=torch.float32)


def _update(state: TrainState, tx: Optimizer, loss: torch.Tensor) -> None:
    for group in state.opt.param_groups:
        group["lr"] = tx.lr(state.step)
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.step += 1


def make_unet_train_step(tx: Optimizer):
    """The UNet's step: weighted BCE of the train-mode forward (BatchNorm
    on batch statistics, its running statistics updated), one update."""

    def step_fn(state: TrainState, x, y, sample_weights=None):
        dev = _device(state.module)
        x, y = _tensor(x, dev), _tensor(y, dev)
        w = None if sample_weights is None else _tensor(sample_weights, dev)
        state.module.train()
        out = state.module(x)
        loss = weighted_bce(out, y, w)
        _update(state, tx, loss)
        with torch.no_grad():
            iou = mean_iou_coef(y, out)
        return state, {"loss": loss.detach(), "mean_iou_coef": iou}

    return step_fn


def make_unet_eval_step():
    """The UNet's evaluation: loss and IoU of the eval-mode forward."""

    @torch.no_grad()
    def eval_fn(state: TrainState, x, y):
        dev = _device(state.module)
        x, y = _tensor(x, dev), _tensor(y, dev)
        state.module.eval()
        out = state.module(x)
        return {"loss": weighted_bce(out, y), "mean_iou_coef": mean_iou_coef(y, out)}

    return eval_fn


def make_tl_optimizer(learning_rate, beta_1: float = 0.9, beta_2: float = 0.999,
                      base_trainable: bool = False, base_name: str = "base_model") -> Optimizer:
    """Adam that trains only the head while the base is frozen."""
    return Optimizer(learning_rate, beta_1, beta_2, frozen=None if base_trainable else base_name)


def _binary_accuracy(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((out > 0.5).float() == y).float().mean()


def make_classifier_train_step(tx: Optimizer):
    """The ResNet classifier's step (its base BatchNorm on running statistics)."""

    def step_fn(state: TrainState, x, y, sample_weights=None):
        dev = _device(state.module)
        x, y = _tensor(x, dev), _tensor(y, dev)
        w = None if sample_weights is None else _tensor(sample_weights, dev)
        state.module.train()
        out = state.module(x)
        loss = weighted_bce(out, y, w)
        _update(state, tx, loss)
        with torch.no_grad():
            acc = _binary_accuracy(out, y)
        return state, {"loss": loss.detach(), "binary_accuracy": acc}

    return step_fn


def make_classifier_eval_step():
    @torch.no_grad()
    def eval_fn(state: TrainState, x, y):
        dev = _device(state.module)
        x, y = _tensor(x, dev), _tensor(y, dev)
        state.module.eval()
        out = state.module(x)
        return {"loss": weighted_bce(out, y), "binary_accuracy": _binary_accuracy(out, y)}

    return eval_fn


# --------------------------------------------------------------------------
# Resumable checkpoints
# --------------------------------------------------------------------------


def _trained(state: TrainState):
    names = {p: n for n, p in state.module.named_parameters()}
    return [(names[p], p) for group in state.opt.param_groups for p in group["params"]]


def _sorted(tree: Any) -> Any:
    """``tree`` with every dict's keys sorted, as a jitted JAX step returns
    its state."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _count(n: int) -> np.ndarray:
    """A count as a JAX step leaves it: a 0-d int32 array."""
    return np.asarray(n, np.int32)


def save_train_state(path, state: TrainState) -> None:
    """Params, BN statistics, the optimizer's state and the step, in one
    file: the bytes of ``flax.serialization.to_bytes`` of the JAX
    ``TrainState`` that holds the same values after a step. The moments sit
    under the parameters' Flax paths; a frozen parameter's are optax's
    masked node, an empty map."""
    if state.tx is None:
        raise ValueError("the train state has no Optimizer (make it with init_train_state)")
    trained = dict(_trained(state))
    mu, nu, count = {}, {}, 0
    for name, p in state.module.named_parameters():
        if name not in trained:
            mu[name] = nu[name] = {}
            continue
        s = state.opt.state.get(p)
        if s:
            mu[name], nu[name], count = s["exp_avg"], s["exp_avg_sq"], int(s["step"])
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    adam_state = {"count": _count(count), "mu": nest_tree(mu), "nu": nest_tree(nu)}
    variables = flax_variables(state.module)
    # the JAX save_train_state's own order, each part as a jitted step leaves it
    save_params(path, {"params": _sorted(variables["params"]),
                       "batch_stats": _sorted(variables["batch_stats"]),
                       "opt_state": _sorted(state.tx.state_tree(adam_state)),
                       "step": _count(state.step)})


def load_train_state(path, template_state: TrainState) -> TrainState:
    """Load a train-state file of either package into ``template_state`` (a
    module of the same architecture and the optimizer ``init_train_state``
    made from the ``Optimizer`` that wrote the file)."""
    if template_state.tx is None:
        raise ValueError("the template state has no Optimizer (make it with init_train_state)")
    tree = load_variables(path)
    load_flax_variables(template_state.module, tree)
    adam_state = template_state.tx.adam_state(tree["opt_state"])
    mu, nu = flatten_tree(adam_state["mu"]), flatten_tree(adam_state["nu"])
    count = float(adam_state["count"])
    sd = template_state.opt.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(count), "exp_avg": torch.tensor(mu[name]),
            "exp_avg_sq": torch.tensor(nu[name])}
        for i, (name, _) in enumerate(_trained(template_state)) if name in mu
    }
    template_state.opt.load_state_dict(sd)
    template_state.step = int(tree["step"])
    return template_state


# --------------------------------------------------------------------------
# Fit loops
# --------------------------------------------------------------------------


@dataclass
class FitResult:
    history: Dict[str, list] = field(default_factory=dict)
    best_metric: float = np.inf
    best_epoch: int = -1


def _epoch_means(metrics: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The mean of each metric over the epoch's steps: one copy to the host."""
    if not metrics:
        return {}
    keys = list(metrics[0])
    values = torch.stack([torch.stack([m[k].float() for k in keys]) for m in metrics]).cpu().numpy()
    return {k: float(np.mean(values[:, j])) for j, k in enumerate(keys)}


def fit(
    state: TrainState,
    train_step,
    eval_step,
    train_batches: Callable[[], Any],
    val_batches: Optional[Callable[[], Any]] = None,
    epochs: int = 1,
    monitor: str = "loss",
    mode: str = "min",
    patience: Optional[int] = None,
    min_delta: float = 0.0,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
) -> Tuple[TrainState, FitResult, Optional[TrainState]]:
    """Keras-style fit: epochs over batch generators, early stopping and a
    save-best checkpoint (the Flax ``{"params", "batch_stats"}`` tree). The
    best state is a copy taken when the monitored metric improved."""
    sign = 1.0 if mode == "min" else -1.0
    result = FitResult(best_metric=np.inf)
    best_state = None
    wait = 0

    for epoch in range(epochs):
        epoch_metrics = _epoch_means([train_step(state, *batch)[1] for batch in train_batches()])
        if val_batches is not None:
            val = _epoch_means([eval_step(state, *batch[:2]) for batch in val_batches()])
            epoch_metrics.update({f"val_{k}": v for k, v in val.items()})

        for k, v in epoch_metrics.items():
            result.history.setdefault(k, []).append(v)
        if verbose:
            print(f"epoch {epoch}: {epoch_metrics}", flush=True)

        raw = epoch_metrics.get(monitor)
        # an absent monitor (an empty validation set) ranks worst in either mode
        current = sign * raw if raw is not None else np.inf
        if current < result.best_metric - min_delta:
            result.best_metric = current
            result.best_epoch = epoch
            best_state = state.copy()
            wait = 0
            if checkpoint_path is not None:
                save_params(checkpoint_path, flax_variables(state.module))
        else:
            wait += 1
            if patience is not None and wait > patience:
                break

    return state, result, best_state


def two_stage_tl_fit(
    module: nn.Module,
    train_batches,
    val_batches,
    frozen_lr: float,
    fine_tune_lr: float,
    beta_1: float = 0.9,
    beta_2: float = 0.999,
    frozen_epochs: int = 1,
    fine_tune_epochs: int = 1,
    patience: Optional[int] = None,
    min_delta: float = 1e-4,
    checkpoint_dir: Optional[str] = None,
    verbose: bool = False,
):
    """Frozen fit -> restore best -> unfreeze -> fine-tune with a fresh Adam
    at step 0. Returns (state, frozen result, fine-tune result)."""
    frozen_tx = make_tl_optimizer(frozen_lr, beta_1, beta_2, False)
    state = init_train_state(module, frozen_tx)
    eval_step = make_classifier_eval_step()
    monitor = "val_loss" if val_batches is not None else "loss"
    state, frozen_result, best_state = fit(
        state, make_classifier_train_step(frozen_tx), eval_step, train_batches, val_batches,
        epochs=frozen_epochs, monitor=monitor, patience=patience, min_delta=min_delta,
        verbose=verbose,
    )
    if best_state is not None:
        state = best_state  # the best frozen weights

    ft_tx = make_tl_optimizer(fine_tune_lr, beta_1, beta_2, True)
    state = init_train_state(state.module, ft_tx)
    ckpt = str(Path(checkpoint_dir) / "best_finetune.msgpack") if checkpoint_dir else None
    state, ft_result, best_ft = fit(
        state, make_classifier_train_step(ft_tx), eval_step, train_batches, val_batches,
        epochs=fine_tune_epochs, monitor=monitor, patience=patience, min_delta=min_delta,
        checkpoint_path=ckpt, verbose=verbose,
    )
    return (best_ft if best_ft is not None else state), frozen_result, ft_result


# --------------------------------------------------------------------------
# Grid search
# --------------------------------------------------------------------------


class UNetXceptionGridSearch:
    """Grid search over filter-count x optimizer configurations."""

    def __init__(
        self,
        save_dir: str,
        filter_counts_options: Sequence[Tuple[int, ...]],
        optimizer_factories: Sequence[Callable[[], Optimizer]],
        n_outputs: int,
        img_shape: Tuple[int, int],
        channels: int = 1,
        output_act: str = "sigmoid",
        seed: int = 0,
        bn_momentum: float = 0.99,
        device: DeviceLike = None,
    ):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.filter_counts_options = filter_counts_options
        self.optimizer_factories = optimizer_factories
        self.n_outputs = n_outputs
        self.img_shape = img_shape
        self.channels = channels
        self.output_act = output_act
        self.seed = seed
        self.bn_momentum = bn_momentum
        self.device = device
        self.best_score = np.nan
        self.best_filter_counts = None
        self.best_optimizer_idx = 0
        self.best_score_idx = 0
        self.histories = []

    def search(self, objective: str, comparison: str, train_batches, val_batches=None,
               epochs: int = 1):
        from tmat_torch.models.unet import build_unet_xception

        if comparison not in ("min", "max"):
            raise ValueError(f"comparison must be 'min' or 'max', not {comparison!r}")
        get_best = np.min if comparison == "min" else np.max
        better = (lambda a, b: a < b) if comparison == "min" else (lambda a, b: a > b)
        self.best_score = np.inf if comparison == "min" else -np.inf

        hp_gen = iter_product(self.filter_counts_options, range(len(self.optimizer_factories)))
        for i, (fc, opt_idx) in enumerate(hp_gen):
            module = build_unet_xception(
                self.n_outputs, self.img_shape, channels=self.channels, filter_counts=fc,
                output_act=self.output_act, seed=self.seed, bn_momentum=self.bn_momentum,
                device=self.device,
            )
            tx = self.optimizer_factories[opt_idx]()
            ckpt = self.save_dir / f"best_weights_config_{i}.msgpack"
            _, result, _ = fit(
                init_train_state(module, tx), make_unet_train_step(tx), make_unet_eval_step(),
                train_batches, val_batches, epochs=epochs, monitor=objective, mode=comparison,
                checkpoint_path=str(ckpt),
            )
            self.histories.append(result.history)
            scores = result.history.get(objective, [])
            if not scores:
                continue
            cur_best = float(get_best(scores))
            if better(cur_best, self.best_score):
                self.best_score = cur_best
                self.best_filter_counts = tuple(fc)
                self.best_optimizer_idx = opt_idx
                self.best_score_idx = i
                with open(self.save_dir / "best_model_hps.json", "w") as fp:
                    json.dump({
                        "search_objective": objective,
                        "best_score": self.best_score,
                        "best_hps": {"filter_counts": list(self.best_filter_counts),
                                     "optimizer_idx": opt_idx},
                        "best_weights_file": str(ckpt),
                    }, fp)
        return self.best_filter_counts, self.best_score
