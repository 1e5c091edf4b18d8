"""Hyperparameter search for the invasion-depth classifier.

Counterpart of ``tmat_tpu/models/hp_search.py``: the search space of the
shipped ``invasion_depth_hp_space.json`` (Adam betas, frozen and
fine-tune learning rates sampled log-uniform, the truncation layer), each
trial a short two-stage fit (``models/train.py::two_stage_tl_fit``) scored
by its best validation loss. The default method is Gaussian-process
Bayesian optimization (``models/bo.py``) after ``num_initial_points``
random trials; ``method="random"`` is the quasi-random searcher with local
refinement around the incumbent. The same seeds draw the same trials as
the JAX package.

Usage:
    python -m tmat_torch.models.hp_search IMG_DIR [--trials 50] [--frozen-epochs 3]
writes the best configuration to MODEL_TRAINING_DIR/invasion_depth_best_hp.json
(the file ``train_invasion`` and ``compute_inv_depth`` read). Trials run on
CUDA; from Python, ``main(argv, device="cpu")`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import json
from glob import glob
from pathlib import Path
from typing import Dict

import numpy as np

from tmat_torch.core import defs
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models import train as T
from tmat_torch.models.data import InvasionDataGenerator, get_train_val_split
from tmat_torch.models.resnet import build_trainable_resnet50_tl


def sample_hp(space: Dict, rng: np.random.RandomState, incumbent=None, shrink=1.0):
    """Draw one configuration; log-uniform for LRs/betas, choice for layer.

    With an incumbent and shrink < 1, samples from a narrowed log-range
    around the incumbent (local refinement).
    """

    def log_uniform(lo, hi, center=None):
        llo, lhi = np.log(lo), np.log(hi)
        if center is not None and shrink < 1.0:
            c = np.log(center)
            half = (lhi - llo) * shrink / 2
            llo, lhi = max(llo, c - half), min(lhi, c + half)
        return float(np.exp(rng.uniform(llo, lhi)))

    inc = incumbent or {}
    return {
        "adam_beta_1": log_uniform(*space["adam_beta_1_range"], inc.get("adam_beta_1")),
        "adam_beta_2": log_uniform(*space["adam_beta_2_range"], inc.get("adam_beta_2")),
        "frozen_lr": log_uniform(*space["frozen_lr_range"], inc.get("frozen_lr")),
        "fine_tune_lr": log_uniform(*space["fine_tune_lr_range"], inc.get("fine_tune_lr")),
        "last_resnet_layer": (
            inc.get("last_resnet_layer")
            if inc and shrink < 1.0 and rng.rand() < 0.5
            else space["last_layer_options"][rng.randint(len(space["last_layer_options"]))]
        ),
    }


def evaluate_hp(hp: Dict, class_paths, class_labels, img_hw, batch_size, frozen_epochs,
                fine_tune_epochs, seed, device: DeviceLike = None) -> float:
    """Train one candidate (a short two-stage fit); its best val_loss."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    train_paths, val_paths = get_train_val_split(class_paths, 0.2)
    train_gen = InvasionDataGenerator(train_paths, class_labels, batch_size, img_hw, rs,
                                      class_weights=True, device=dev)
    val_gen = InvasionDataGenerator(val_paths, class_labels, batch_size, img_hw, rs,
                                    shuffle=False, device=dev)
    module = build_trainable_resnet50_tl(1, (*img_hw, 3), base_last_layer=hp["last_resnet_layer"],
                                         seed=seed, device=dev)
    _, frozen_res, ft_res = T.two_stage_tl_fit(
        module, lambda: iter(train_gen), lambda: iter(val_gen),
        frozen_lr=hp["frozen_lr"], fine_tune_lr=hp["fine_tune_lr"],
        beta_1=hp["adam_beta_1"], beta_2=hp["adam_beta_2"],
        frozen_epochs=frozen_epochs, fine_tune_epochs=fine_tune_epochs,
    )
    losses = ft_res.history.get("val_loss") or frozen_res.history.get("val_loss")
    return float(np.min(losses)) if losses else np.inf


def search(class_paths, class_labels, img_hw=(64, 64), batch_size=8, trials=10,
           initial_points=None, frozen_epochs=1, fine_tune_epochs=1, seed=0, space=None,
           verbose=True, method="bo", device: DeviceLike = None):
    """(best hp, best val_loss) over ``trials`` trials."""
    space = space or json.loads(
        Path(defs.model_training_path("invasion_depth_hp_space.json")).read_text())
    initial_points = initial_points or max(trials // 2, 1)
    trial_counter = [0]

    def objective(hp):
        t = trial_counter[0]
        trial_counter[0] += 1
        loss = evaluate_hp(hp, class_paths, class_labels, img_hw, batch_size,
                           frozen_epochs, fine_tune_epochs, seed + t, device=device)
        if verbose:
            print(f"trial {t}: val_loss={loss:.4f} hp={hp}", flush=True)
        return loss

    if method == "bo":
        from tmat_torch.models import bo

        return bo.minimize(objective, space, trials, num_initial_points=initial_points, seed=seed)

    rng = np.random.RandomState(seed)
    best_hp, best_loss = None, np.inf
    for trial in range(trials):
        if trial < initial_points or best_hp is None:
            hp = sample_hp(space, rng)
        else:
            hp = sample_hp(space, rng, incumbent=best_hp, shrink=0.3)
        loss = objective(hp)
        if loss < best_loss:
            best_hp, best_loss = hp, loss
    return best_hp, best_loss


def main(argv=None, device: DeviceLike = None) -> Path:
    """Run the search and write its best configuration; returns the file."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img_dir", type=str)
    p.add_argument("--trials", type=int, default=None)
    p.add_argument("--initial-points", type=int, default=None)
    p.add_argument("--frozen-epochs", type=int, default=3)
    p.add_argument("--fine-tune-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--method", choices=("bo", "random"), default="bo",
        help="bo = GP-EI Bayesian optimization (default, the reference's keras-tuner "
        "oracle family); random = quasi-random + local refinement",
    )
    args = p.parse_args(argv)
    dev = resolve_device(device)

    space = json.loads(Path(defs.model_training_path("invasion_depth_hp_space.json")).read_text())
    with open(defs.model_training_path("invasion_depth_training_values.json")) as fp:
        tv = json.load(fp)
    class_labels = tv["class_labels"]
    class_paths = {label: sorted(glob(str(Path(args.img_dir) / name / "*")))
                   for name, label in class_labels.items()}

    best_hp, best_loss = search(
        class_paths, class_labels, img_hw=(args.img_size, args.img_size),
        batch_size=args.batch_size, trials=args.trials or space["max_opt_trials"],
        initial_points=args.initial_points or space["num_initial_points"],
        frozen_epochs=args.frozen_epochs, fine_tune_epochs=args.fine_tune_epochs,
        seed=args.seed, space=space, method=args.method, device=dev,
    )

    out = Path(defs.MODEL_TRAINING_DIR) / "invasion_depth_best_hp.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(best_hp))
    print(f"Best val_loss {best_loss:.4f}; saved {out}")
    return out


if __name__ == "__main__":
    main()
