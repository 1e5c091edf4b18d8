"""Train the invasion-depth ResNet50-TL classifier ensemble.

Counterpart of ``tmat_tpu/models/train_invasion.py``: for each member a
reshuffled train/val split, class-balanced weights, flips and rotations,
then the two-stage fit (frozen base -> restore best -> fine-tune; or
``--single-stage``) with early stopping, every value not given on the
command line taken from the shipped ``invasion_depth_training_values.json``
and ``invasion_depth_best_hp.json``. Each member is written as
``best_ensemble/best_finetune_weights_{i}.msgpack`` (the Flax tree, float16
by default: it loads in either package) beside
``best_model_history_{i}.csv`` (the ranking contract of
``compute_inv_depth``).

Expected data layout: IMG_DIR/<class_name>/*.tif with class names matching
the class_labels ({"no_invasion": 0, "invasion": 1}).

Usage:
    python -m tmat_torch.models.train_invasion IMG_DIR [--n-models 5]
        [--frozen-epochs 50] [--fine-tune-epochs 50] [--batch-size 32]
The trainer runs on CUDA; from Python, ``main(argv, device="cpu")`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
from glob import glob
from pathlib import Path

import numpy as np

from tmat_torch.core import defs
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models import train as T
from tmat_torch.models.augment import augment_invasion_imgs
from tmat_torch.models.data import InvasionDataGenerator, get_train_val_split
from tmat_torch.models.layers import flax_variables
from tmat_torch.models.params_io import save_params
from tmat_torch.models.resnet import build_trainable_resnet50_tl


def main(argv=None, device: DeviceLike = None) -> Path:
    """Train every member; returns the ensemble directory."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img_dir", type=str)
    p.add_argument("--n-models", type=int, default=None)
    p.add_argument("--frozen-epochs", type=int, default=None)
    p.add_argument("--fine-tune-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--last-layer", type=str, default=None)
    p.add_argument(
        "--ckpt-dtype", choices=("float32", "float16"), default="float16",
        help="Storage dtype for saved member checkpoints; float16 halves "
        "artifact size and the readers cast back to float32.",
    )
    p.add_argument(
        "--single-stage", action="store_true",
        help="Train all parameters in one stage. The frozen->fine-tune recipe "
        "assumes an ImageNet-pretrained base; with a randomly initialized base "
        "(no pretrained weights are shipped) the frozen stage trains a head "
        "on random features.",
    )
    args = p.parse_args(argv)
    dev = resolve_device(device)

    with open(defs.model_training_path("invasion_depth_best_hp.json")) as fp:
        best_hp = json.load(fp)
    with open(defs.model_training_path("invasion_depth_training_values.json")) as fp:
        tv = json.load(fp)

    n_models = args.n_models or tv["n_models"]
    frozen_epochs = args.frozen_epochs or tv["frozen_epochs"]
    fine_tune_epochs = args.fine_tune_epochs or tv["fine_tune_epochs"]
    batch_size = args.batch_size or tv["batch_size"]
    img_hw = (args.img_size, args.img_size) if args.img_size else tuple(tv["resnet_inp_shape"][:2])
    last_layer = args.last_layer or best_hp["last_resnet_layer"]
    class_labels = tv["class_labels"]

    class_paths = {
        label: sorted(glob(str(Path(args.img_dir) / name / "*")))
        for name, label in class_labels.items()
    }
    for name, label in class_labels.items():
        if not class_paths[label]:
            raise FileNotFoundError(f"No images for class '{name}' under {args.img_dir}/{name}/")

    out_dir = Path(defs.MODEL_TRAINING_DIR) / "best_ensemble"
    out_dir.mkdir(parents=True, exist_ok=True)

    for member in range(n_models):
        rs = np.random.RandomState(args.seed + member)
        shuffled = {k: list(np.array(v)[rs.permutation(len(v))]) for k, v in class_paths.items()}
        train_paths, val_paths = get_train_val_split(shuffled, tv["val_split"])

        train_gen = InvasionDataGenerator(
            train_paths, class_labels, batch_size, img_hw, rs, class_weights=True,
            augmentation_function=lambda x, r: augment_invasion_imgs(x, r), device=dev,
        )
        val_gen = InvasionDataGenerator(val_paths, class_labels, batch_size, img_hw, rs,
                                        shuffle=False, device=dev)

        module = build_trainable_resnet50_tl(1, (*img_hw, 3), base_last_layer=last_layer,
                                             seed=args.seed + member, device=dev)
        print(f"=== Training ensemble member {member} ===", flush=True)
        state, frozen_res, ft_res = T.two_stage_tl_fit(
            module,
            lambda: iter(train_gen),
            lambda: iter(val_gen),
            frozen_lr=best_hp["frozen_lr"],
            fine_tune_lr=best_hp["fine_tune_lr"],
            beta_1=best_hp["adam_beta_1"],
            beta_2=best_hp["adam_beta_2"],
            frozen_epochs=0 if args.single_stage else frozen_epochs,
            fine_tune_epochs=(frozen_epochs + fine_tune_epochs if args.single_stage
                              else fine_tune_epochs),
            patience=tv["early_stopping_patience"],
            min_delta=tv["early_stopping_min_delta"],
            verbose=True,
        )

        save_params(out_dir / f"best_finetune_weights_{member}.msgpack",
                    flax_variables(state.module), dtype=np.dtype(args.ckpt_dtype))

        # the history CSV with the reference's schema (the ranking contract)
        with open(out_dir / f"best_model_history_{member}.csv", "w", newline="") as fp:
            writer = csv.DictWriter(fp, fieldnames=["loss", "binary_accuracy", "val_loss",
                                                    "val_binary_accuracy", "training_stage"])
            writer.writeheader()
            for stage, res in (("frozen", frozen_res), ("finetune", ft_res)):
                n_epochs = len(res.history.get("loss", []))
                for e in range(n_epochs):
                    writer.writerow({
                        "loss": res.history["loss"][e],
                        "binary_accuracy": res.history.get("binary_accuracy", [0] * n_epochs)[e],
                        "val_loss": res.history.get("val_loss", [""] * n_epochs)[e],
                        "val_binary_accuracy": res.history.get("val_binary_accuracy",
                                                               [""] * n_epochs)[e],
                        "training_stage": stage,
                    })
        print(f"Member {member} saved to {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
