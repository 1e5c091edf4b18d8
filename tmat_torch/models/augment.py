"""Training augmentations.

A copy of ``tmat_tpu/models/augment.py`` (host numpy; PIL's MESH warp with
bicubic resampling and its resizes, imported inside the functions that
use them): the same ``RandomState`` gives the same draws, in the same
order, and the same arrays. ``augment_invasion_imgs`` also takes a torch
tensor (the invasion batches, prepared on the training device) and flips
and rotates it there. The disk(2) median of the elastic mask is
``topo/transforms.py::median_filter_footprint``.

Reference targets:
- augment_invasion_imgs (preprocessing.py:226-275): random flips + 90-degree
  rotations per image (the reference's dask path is dead code with a
  signature bug, SURVEY §7 known-bugs; this is the working semantics)
- the segmentation pipeline's albumentations stack (rotate, random crop +
  resize, flips, brightness/contrast, multiplicative noise) and the
  Augmentor elastic mesh distortion + paired image/mask wrapper
  (transforms.py:16-167, train_binary_segmentation.ipynb cell 22)
"""

from __future__ import annotations

from math import floor
from typing import List, Optional, Tuple

import numpy as np
import torch
from numpy.random import RandomState

from tmat_torch.ops.morphology import disk
from tmat_torch.topo.transforms import median_filter_footprint


def augment_invasion_imgs(
    images: np.ndarray,
    rand_state: RandomState,
    rot_options=(0, 90, 180, 270),
    expand_dims: bool = False,
) -> np.ndarray:
    """Random flips + axis-aligned rotations (preprocessing.py:226-275) of a
    numpy batch, or of a torch batch on its device."""
    num = len(images)
    rots = rand_state.choice(rot_options, size=num)
    hflips = rand_state.choice([True, False], size=num)
    vflips = rand_state.choice([True, False], size=num)

    on_torch = isinstance(images, torch.Tensor)
    out = []
    for i in range(num):
        img = images[i]
        if hflips[i]:
            img = img.flip(1) if on_torch else img[:, ::-1]
        if vflips[i]:
            img = img.flip(0) if on_torch else img[::-1, :]
        k = int(rots[i]) // 90
        if k:
            img = torch.rot90(img, k, (0, 1)) if on_torch else np.rot90(img, k)
        if expand_dims:
            img = img[:, :, None]
        out.append(img)
    return torch.stack(out) if on_torch else np.array(out)


def get_augmentor(augmentations):
    """Compose image/mask augmentations (preprocessing.py:186-200)."""

    def augmentor(image, mask):
        assert image.shape == mask.shape, "Image and mask must have the same shape."
        for aug in augmentations:
            transformed = aug(image=image, mask=mask)
            image, mask = transformed["image"], transformed["mask"]
        return image, mask

    return augmentor


def get_batch_augmentor(augmentations):
    """Batch version of get_augmentor (preprocessing.py:203-223)."""
    augmentor = get_augmentor(augmentations)

    def batch_augmentor(images, masks):
        assert images.shape == masks.shape, "Images and masks must have the same shape."
        pairs = [augmentor(images[i], masks[i]) for i in range(images.shape[0])]
        xs, ys = zip(*pairs)
        return np.array(xs), np.array(ys)

    return batch_augmentor


def elastic_distortion(
    images: List[np.ndarray],
    grid_width: int = None,
    grid_height: int = None,
    magnitude: int = 8,
    rs: Optional[RandomState] = None,
) -> List[np.ndarray]:
    """Augmentor-style elastic mesh distortion (transforms.py:50-167).

    Distorts all images with the SAME random mesh (so image/mask stay
    aligned), via PIL's MESH transform with bicubic resampling.
    """
    from PIL import Image

    rs = rs or RandomState()
    extra_dim = [False] * len(images)
    redundant_dims = [False] * len(images)
    dtypes = [img.dtype for img in images]
    max_vals = [img.max() for img in images]

    pil_images = []
    for i, img in enumerate(images):
        if img.ndim == 3 and img.shape[2] > 1:
            redundant_dims[i] = True
            img = img[:, :, 0]
        elif img.ndim == 3:
            extra_dim[i] = True
        pil_images.append(Image.fromarray(np.squeeze(img.astype(np.float32)), mode="F"))

    width, height = pil_images[0].size
    horizontal_tiles, vertical_tiles = grid_width, grid_height
    width_of_square = floor(width / float(horizontal_tiles))
    height_of_square = floor(height / float(vertical_tiles))
    width_of_last = width - width_of_square * (horizontal_tiles - 1)
    height_of_last = height - height_of_square * (vertical_tiles - 1)

    dimensions = []
    for v in range(vertical_tiles):
        for h in range(horizontal_tiles):
            x1 = h * width_of_square
            y1 = v * height_of_square
            x2 = (width_of_last if h == horizontal_tiles - 1 else width_of_square) + x1
            y2 = (
                height_of_last + height_of_square * v
                if v == vertical_tiles - 1
                else height_of_square + height_of_square * v
            )
            dimensions.append([x1, y1, x2, y2])

    last_column = [(horizontal_tiles - 1) + horizontal_tiles * i
                   for i in range(vertical_tiles)]
    last_row = range(
        horizontal_tiles * vertical_tiles - horizontal_tiles,
        horizontal_tiles * vertical_tiles,
    )

    polygons = np.array(
        [[x1, y1, x1, y2, x2, y2, x2, y1] for x1, y1, x2, y2 in dimensions]
    )
    polygon_indices = [
        [i, i + 1, i + horizontal_tiles, i + 1 + horizontal_tiles]
        for i in range((vertical_tiles * horizontal_tiles) - 1)
        if i not in last_row and i not in last_column
    ]

    for a, b, c, d in polygon_indices:
        dx = rs.randint(-magnitude, magnitude)
        dy = rs.randint(-magnitude, magnitude)
        polygons[a][4:6] += (dx, dy)
        polygons[b][2:4] += (dx, dy)
        polygons[c][6:8] += (dx, dy)
        polygons[d][0:2] += (dx, dy)

    mesh = [[dim, polygons[i].tolist()] for i, dim in enumerate(dimensions)]

    augmented = []
    for i, pil_img in enumerate(pil_images):
        warped = pil_img.transform(
            pil_img.size, Image.MESH, mesh, resample=Image.Resampling.BICUBIC
        )
        arr = np.asarray(warped)
        if extra_dim[i]:
            arr = np.expand_dims(arr, 2)
        elif redundant_dims[i]:
            arr = np.repeat(arr[:, :, np.newaxis], 3, axis=2)
        arr = np.clip(arr, 0, max_vals[i])
        if np.issubdtype(dtypes[i], np.integer):
            arr = np.round(arr)
        augmented.append(arr.astype(dtypes[i]))
    return augmented


def get_elastic_dual_transform(
    grid_width_range=(4, 8),
    grid_height_range=(4, 8),
    magnitude_range=(7, 9),
    rs: Optional[RandomState] = None,
    p: float = 0.9,
):
    """Paired image/mask elastic distortion + median-blurred mask
    (transforms.py:16-47)."""
    rs = rs or RandomState()

    def transform(image, mask):
        if rs.rand() > p:
            return {"image": image, "mask": mask}
        gw = rs.randint(grid_width_range[0], grid_width_range[1] + 1)
        gh = rs.randint(grid_height_range[0], grid_height_range[1] + 1)
        mag = rs.randint(magnitude_range[0], magnitude_range[1] + 1)
        image, mask = elastic_distortion([image, mask], gw, gh, mag, rs)
        median = median_filter_footprint(torch.from_numpy(np.ascontiguousarray(mask)), disk(2))
        mask = median.numpy().astype(mask.dtype)
        return {"image": image, "mask": mask}

    return transform


def random_flip_rotate_crop(
    rs: RandomState,
    crop_size: Optional[int] = None,
    out_size: Optional[int] = None,
    brightness: float = 0.2,
    contrast: float = 0.2,
    noise_range: Tuple[float, float] = (0.9, 1.1),
    p_noise: float = 0.5,
):
    """The segmentation training stack: flips, rot90, random crop + resize,
    brightness/contrast, multiplicative noise (train notebook cell 22
    semantics, re-expressed without albumentations)."""

    def aug(image, mask):
        from PIL import Image

        if rs.rand() < 0.5:
            image, mask = image[:, ::-1], mask[:, ::-1]
        if rs.rand() < 0.5:
            image, mask = image[::-1], mask[::-1]
        k = rs.randint(4)
        if k:
            image, mask = np.rot90(image, k), np.rot90(mask, k)
        if crop_size is not None and image.shape[0] > crop_size:
            top = rs.randint(image.shape[0] - crop_size + 1)
            left = rs.randint(image.shape[1] - crop_size + 1)
            image = image[top : top + crop_size, left : left + crop_size]
            mask = mask[top : top + crop_size, left : left + crop_size]
        if out_size is not None and image.shape[0] != out_size:
            pil = Image.fromarray(image.astype(np.float32), mode="F")
            image = np.asarray(pil.resize((out_size, out_size), Image.BILINEAR))
            pilm = Image.fromarray(mask.astype(np.float32), mode="F")
            mask = (np.asarray(pilm.resize((out_size, out_size), Image.NEAREST)) > 0.5)
            mask = mask.astype(np.float32)
        scale = 1.0 + rs.uniform(-contrast, contrast)
        shift = rs.uniform(-brightness, brightness) * (image.max() or 1.0)
        image = image * scale + shift
        if rs.rand() < p_noise:
            image = image * rs.uniform(*noise_range, size=image.shape)
        return image, mask

    def batch_aug(images, masks):
        pairs = [aug(images[i].copy(), masks[i].copy()) for i in range(len(images))]
        xs, ys = zip(*pairs)
        return np.array(xs), np.array(ys)

    return batch_aug
