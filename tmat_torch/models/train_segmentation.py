"""Train the UNet-Xception microvessel segmentor.

Counterpart of ``tmat_tpu/models/train_segmentation.py``, with the same
flags and defaults: image/mask pairing, a seeded split, augmented batches
(flips, rot90, brightness/contrast, noise, elastic mesh; on the host) with
fg/bg sample weights, an optional filter-count grid search, then AdamW
(weight decay 1e-4) under a linear warmup into cosine restarts, float32,
early stopping on the validation IoU. It writes the best weights as
``checkpoint_{n}.msgpack`` (the Flax tree: it loads in either package)
and registers ``unet_patch_segmentor_{n}.json`` in the user base dir.

Usage:
    python -m tmat_torch.models.train_segmentation IMG_DIR [--mask-dir ...]
        [--patch-size 320] [--filters 64 128 256 512] [--epochs 50]
        [--batch-size 16] [--lr 1e-3] [--ds-ratio 0.625] [--grid-search]
The trainer runs on CUDA; from Python, ``main(argv, device="cpu")`` runs it
on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tmat_torch.core import defs
from tmat_torch.core.io import get_img_mask_paths
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models import train as T
from tmat_torch.models.augment import get_elastic_dual_transform, random_flip_rotate_crop
from tmat_torch.models.data import BinaryMaskSequence, load_x, load_y
from tmat_torch.models.registry import get_last_exp_num, save_unet_patch_segmentor_cfg
from tmat_torch.models.unet import build_unet_xception


def load_x_rescaled(batch_img_paths):
    """Images min-max rescaled to [0, 1] per image: the segmentor's
    inference contract (the branches tool rescales to [0, 1] before predict)."""
    batch = load_x(batch_img_paths).astype(np.float32)
    lo = batch.min(axis=(1, 2), keepdims=True)
    hi = batch.max(axis=(1, 2), keepdims=True)
    return (batch - lo) / np.maximum(hi - lo, 1e-38)


def make_augmentor(rs, patch_size, crop_size=None):
    geo = random_flip_rotate_crop(rs, crop_size=crop_size, out_size=patch_size)
    elastic = get_elastic_dual_transform(rs=rs, p=0.85)

    def batch_aug(images, masks):
        images, masks = geo(images, masks)
        out_i, out_m = [], []
        for img, msk in zip(images, masks):
            res = elastic(img, msk)
            out_i.append(res["image"])
            out_m.append(res["mask"])
        return np.array(out_i), np.array(out_m)

    return batch_aug


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img_dir", type=str)
    p.add_argument("--mask-dir", type=str, default=None)
    p.add_argument("--img-suffix", type=str, default=".tif")
    p.add_argument("--mask-suffix", type=str, default="_mask.tif")
    p.add_argument("--patch-size", type=int, default=320)
    p.add_argument("--filters", type=int, nargs="+", default=[64, 128, 256, 512])
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--ds-ratio", type=float, default=0.625)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--fg-weight", type=float, default=1.0)
    p.add_argument("--bg-weight", type=float, default=1.0)
    p.add_argument("--grid-search", action="store_true")
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--bn-momentum", type=float, default=0.9)
    return p.parse_args(argv)


def make_sequences(args: argparse.Namespace, rs: np.random.RandomState):
    """The seeded split and the (train, validation) batch sequences."""
    pairs = get_img_mask_paths(args.img_dir, args.mask_dir, args.img_suffix, args.mask_suffix)
    rs.shuffle(pairs)
    n_val = max(1, round(len(pairs) * args.val_split))
    val_pairs, train_pairs = pairs[:n_val], pairs[n_val:]
    print(f"{len(train_pairs)} training / {len(val_pairs)} validation pairs")
    train_seq = BinaryMaskSequence(
        args.batch_size, [a for a, _ in train_pairs], [b for _, b in train_pairs], rs,
        load_x_rescaled, load_y, augmentation_function=make_augmentor(rs, args.patch_size),
        sample_weights=(args.bg_weight, args.fg_weight),
    )
    # the validation batch cannot exceed the split (else no batch, and the
    # monitored metric disappears)
    val_seq = BinaryMaskSequence(
        min(args.batch_size, max(len(val_pairs), 1)), [a for a, _ in val_pairs],
        [b for _, b in val_pairs], rs, load_x_rescaled, load_y, shuffle=False,
    )
    return train_seq, (val_seq if val_pairs else None)


def make_schedule(args: argparse.Namespace, steps_per_epoch: int):
    return T.warmup_schedule(
        args.warmup_steps,
        T.cosine_decay_restarts(args.lr, max(args.epochs * steps_per_epoch // 3, 1),
                                t_mul=1.0, m_mul=0.5),
    )


def main(argv=None, device: DeviceLike = None) -> Path:
    """Train, write the checkpoint, register its config; returns the config path."""
    args = parse_args(argv)
    dev = resolve_device(device)
    rs = np.random.RandomState(args.seed)
    train_seq, val_seq = make_sequences(args, rs)
    schedule = make_schedule(args, len(train_seq))

    def make_tx():
        return T.adamw(schedule)

    train_batches = lambda: iter(train_seq)  # noqa: E731
    val_batches = (lambda: iter(val_seq)) if val_seq is not None else None
    monitor = "val_mean_iou_coef" if val_seq is not None else "mean_iou_coef"
    if args.grid_search:
        search = T.UNetXceptionGridSearch(
            str(Path(defs.MODEL_TRAINING_DIR) / "binary_segmentation" / "search"),
            [tuple(args.filters), tuple(f // 2 for f in args.filters)], [make_tx], 1,
            (args.patch_size, args.patch_size), bn_momentum=args.bn_momentum, device=dev,
        )
        best_fc, best = search.search(monitor, "max", train_batches, val_batches,
                                      epochs=max(args.epochs // 5, 1))
        print(f"Grid search best filters: {best_fc} (score {best})")
        filters = best_fc
    else:
        filters = tuple(args.filters)

    module = build_unet_xception(1, (args.patch_size, args.patch_size), channels=1,
                                 filter_counts=filters, bn_momentum=args.bn_momentum, device=dev)
    tx = make_tx()
    ckpt_dir = Path(defs.MODEL_TRAINING_DIR) / "binary_segmentation" / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    ckpt_path = ckpt_dir / f"checkpoint_{get_last_exp_num() + 1}.msgpack"

    _, result, _ = T.fit(
        T.init_train_state(module, tx), T.make_unet_train_step(tx), T.make_unet_eval_step(),
        train_batches, val_batches, epochs=args.epochs, monitor=monitor, mode="max",
        patience=args.patience, checkpoint_path=str(ckpt_path), verbose=True,
    )

    cfg_path = save_unet_patch_segmentor_cfg({
        "patch_size": args.patch_size,
        "checkpoint_file": ckpt_path.name,
        "filter_counts": list(filters),
        "ds_ratio": args.ds_ratio,
        "channels": 1,
    })
    print(f"Saved checkpoint {ckpt_path} and config {cfg_path}")
    print(f"Best epoch {result.best_epoch}: {result.best_metric}")
    return cfg_path


if __name__ == "__main__":
    main()
