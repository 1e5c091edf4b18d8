"""Training data pipelines: batch generators, splits, class weights.

A copy of ``tmat_tpu/models/data.py`` (PIL imported inside the loaders):
the same ``RandomState`` draws in the same order give the same batches.
``InvasionDataGenerator`` prepares its images on the training device
(``models/preprocess.py::prep_inv_depth_imgs``) and hands the batch to its
augmentation there, as a torch tensor.

Reference targets:
- BinaryMaskSequence (models_util.py:232-332): path-pair batching with
  oversampling, pair-integrity checks, shuffling, per-pixel fg/bg sample
  weights
- InvasionDataGenerator (data_prep.py:87-213): class-paths -> flat lists,
  balanced class weights, epoch shuffling
- get_train_val_split (data_prep.py:64-84)
- balanced_class_weights_from_counts (preprocessing.py:278-292)
- load_x / load_y (models_util.py:219-229)
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from numpy.random import RandomState

from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.preprocess import prep_inv_depth_imgs


def load_y(batch_mask_paths) -> np.ndarray:
    """Binary segmentation masks as {0,1} arrays (models_util.py:219-223)."""
    from PIL import Image

    y = np.array([np.asarray(Image.open(p).convert("L")) for p in batch_mask_paths])
    y = y.copy()
    y[y > 0] = 1
    return y


def load_x(batch_img_paths) -> np.ndarray:
    """Input images at native bit depth (models_util.py:226-229)."""
    from PIL import Image

    return np.array([np.asarray(Image.open(p)) for p in batch_img_paths])


def balanced_class_weights_from_counts(class_counts: Dict) -> Dict:
    """n / (k * n_c) weights (preprocessing.py:278-292)."""
    n = np.sum(list(class_counts.values()))
    n_c = len(class_counts)
    return {ci: n / (n_c * n_ci) for ci, n_ci in class_counts.items()}


def get_train_val_split(
    tv_class_paths: Dict[int, Sequence[str]], val_split: float = 0.2
) -> Tuple[Dict[int, Sequence[str]], Dict[int, Sequence[str]]]:
    """Per-class head/tail split (data_prep.py:64-84)."""
    val_counts = {k: round(len(v) * val_split) for k, v in tv_class_paths.items()}
    train = {k: v[val_counts[k]:] for k, v in tv_class_paths.items()}
    val = {k: v[: val_counts[k]] for k, v in tv_class_paths.items()}
    return train, val


class BinaryMaskSequence:
    """Iterable of (x, y[, sample_weights]) batches from image/mask paths."""

    def __init__(
        self,
        batch_size: int,
        img_paths: Sequence[str],
        seg_paths: Sequence[str],
        random_state: RandomState,
        load_x_fn: Callable = load_x,
        load_y_fn: Callable = load_y,
        augmentation_function: Optional[Callable] = None,
        sample_weights: Optional[Tuple[float, float]] = None,
        repeat_n_times: int = 1,
        shuffle: bool = True,
    ):
        self.batch_size = batch_size
        self.img_paths = list(img_paths)
        self.seg_paths = list(seg_paths)
        self.rs = random_state
        self.load_x = load_x_fn
        self.load_y = load_y_fn
        self.sample_weights = sample_weights
        if sample_weights:
            self.bg_weight, self.fg_weight = sample_weights
        self.repeat_n_times = repeat_n_times
        self.shuffle = shuffle
        self.augmentation_function = augmentation_function

    def __len__(self):
        return (len(self.seg_paths) * self.repeat_n_times) // self.batch_size

    def __getitem__(self, idx):
        if self.repeat_n_times > 1:
            i = (idx * self.batch_size) % len(self.img_paths)
        else:
            i = idx * self.batch_size

        batch_img_paths = self.img_paths[i : i + self.batch_size]
        batch_seg_paths = self.seg_paths[i : i + self.batch_size]

        if self.shuffle or self.repeat_n_times > 1:
            remaining = len(self.img_paths) - i
            if remaining < self.batch_size:
                batch_img_paths += self.img_paths[: self.batch_size - remaining]
                batch_seg_paths += self.seg_paths[: self.batch_size - remaining]

        if self.shuffle:
            indices = self.rs.permutation(len(self.img_paths))
            self.img_paths = [self.img_paths[j] for j in indices]
            self.seg_paths = [self.seg_paths[j] for j in indices]

        for j, im_path in enumerate(batch_img_paths):
            if Path(im_path).name != Path(batch_seg_paths[j]).name.replace(
                "_mask", ""
            ):
                raise ValueError(
                    f"Image {im_path} and mask {batch_seg_paths[j]} do not match"
                )

        x = self.load_x(batch_img_paths)
        y = self.load_y(batch_seg_paths)

        if self.augmentation_function is not None:
            x, y = self.augmentation_function(x, y)

        x = x[..., np.newaxis].astype(np.float32)
        y = y[..., np.newaxis].astype(np.float32)

        if self.sample_weights:
            w = np.zeros(y.shape, np.float32)
            w[y == 1] = self.fg_weight
            w[y != 1] = self.bg_weight
            return x, y, w
        return x, y

    def __iter__(self):
        for idx in range(len(self)):
            yield self[idx]


class InvasionDataGenerator:
    """Batches of preprocessed invasion images (a float32 tensor on
    ``device``, None = CUDA) + labels (+ weights) as numpy arrays."""

    def __init__(
        self,
        class_paths: Dict[int, Sequence[str]],
        class_labels: Dict[str, int],
        batch_size: int,
        img_shape: Tuple[int, int],
        random_state: RandomState,
        class_weights=False,
        shuffle: bool = True,
        augmentation_function: Optional[Callable] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.class_paths = {k: list(v) for k, v in class_paths.items()}
        self.class_labels = dict(class_labels)
        self.batch_size = batch_size
        self.img_shape = img_shape
        self.rand_state = random_state
        self.shuffle = shuffle
        self.augmentation_function = augmentation_function

        self.class_counts = {c: len(p) for c, p in self.class_paths.items()}
        self.img_paths = []
        self.img_labels = []
        for key, paths in self.class_paths.items():
            self.img_paths.extend(paths)
            self.img_labels.extend([key] * len(paths))
        self.indices = np.arange(len(self.img_paths))

        if isinstance(class_weights, dict):
            self.class_weights = dict(class_weights)
        elif class_weights:
            self.class_weights = balanced_class_weights_from_counts(self.class_counts)
        else:
            self.class_weights = None

        if self.shuffle:
            self.shuffle_indices()

    def __len__(self):
        return len(self.img_paths) // self.batch_size

    def __getitem__(self, index):
        sel = self.indices[index * self.batch_size : (index + 1) * self.batch_size]
        paths = [self.img_paths[i] for i in sel]
        labels = np.array([self.img_labels[i] for i in sel])

        from PIL import Image

        imgs = np.array(
            [np.asarray(Image.open(p).convert("F"), np.float32) for p in paths]
        )
        x = prep_inv_depth_imgs(torch.from_numpy(imgs).to(self.device), self.img_shape)

        if self.augmentation_function is not None:
            x = self.augmentation_function(x, self.rand_state)

        if self.class_weights is not None:
            w = np.array([self.class_weights[y_] for y_ in labels])
            return x, labels[:, np.newaxis].astype(np.float32), w
        return x, labels[:, np.newaxis].astype(np.float32)

    def __iter__(self):
        for idx in range(len(self)):
            yield self[idx]
        # Keras calls on_epoch_end after each pass (data_prep.py:209-213):
        # reshuffle so the next epoch sees different batch composition
        self.on_epoch_end()

    def shuffle_indices(self):
        self.rand_state.shuffle(self.indices)

    def on_epoch_end(self):
        self.indices = np.arange(len(self.img_paths))
        if self.shuffle:
            self.shuffle_indices()
