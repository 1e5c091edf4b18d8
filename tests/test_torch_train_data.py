"""The port's training augmentations and data pipelines against the JAX
package (``tmat_tpu/models/augment.py``, ``data.py``).

The same ``RandomState`` seed goes to both: every array is equal, apart
from the invasion batches, whose Lanczos resize rounds differently in the
two packages (within 1e-6 of the 0-255 scale: 1.4e-4 apart on the values
here); their labels, weights and flips are equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tmat_tpu.models import augment as JA, data as JD
from tmat_torch.models import augment as TA, data as TD


def _pairs(tmp_path, n=6, hw=24, seed=0):
    rng = np.random.RandomState(seed)
    imgs, masks = [], []
    for i in range(n):
        img = (rng.rand(hw, hw) * 255).astype(np.uint8)
        mask = np.zeros((hw, hw), np.uint8)
        mask[4 + i: 14 + i, 6:12] = 255
        Image.fromarray(img).save(tmp_path / f"s{i}.tif")
        Image.fromarray(mask).save(tmp_path / f"s{i}_mask.tif")
        imgs.append(str(tmp_path / f"s{i}.tif"))
        masks.append(str(tmp_path / f"s{i}_mask.tif"))
    return imgs, masks


def _assert_equal_batches(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("expand_dims", [False, True])
def test_augment_invasion_imgs_numpy_and_torch(expand_dims):
    rng = np.random.RandomState(0)
    imgs = rng.rand(8, 12, 12, 3).astype(np.float32)
    ref = JA.augment_invasion_imgs(imgs[..., 0] if expand_dims else imgs, np.random.RandomState(3),
                                   expand_dims=expand_dims)
    out = TA.augment_invasion_imgs(imgs[..., 0] if expand_dims else imgs, np.random.RandomState(3),
                                   expand_dims=expand_dims)
    np.testing.assert_array_equal(out, ref)
    # the same draws flip and rotate a torch batch in place on its device
    on_torch = TA.augment_invasion_imgs(torch.tensor(imgs[..., 0] if expand_dims else imgs),
                                        np.random.RandomState(3), expand_dims=expand_dims)
    assert isinstance(on_torch, torch.Tensor)
    np.testing.assert_array_equal(on_torch.numpy(), ref)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_elastic_distortion_equal(dtype):
    rng = np.random.RandomState(1)
    img = (rng.rand(40, 36) * 200).astype(dtype)
    mask = np.zeros((40, 36), np.uint8)
    mask[8:30, 10:20] = 1
    ref = JA.elastic_distortion([img, mask], 4, 5, 6, np.random.RandomState(2))
    out = TA.elastic_distortion([img, mask], 4, 5, 6, np.random.RandomState(2))
    _assert_equal_batches(out, ref)
    assert not np.array_equal(out[0], img)


def test_dual_transform_and_flip_rotate_crop_equal():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 32, 32).astype(np.float32)
    y = (rng.rand(3, 32, 32) > 0.5).astype(np.float32)
    for p in (0.0, 1.0):
        ref = JA.get_elastic_dual_transform(rs=np.random.RandomState(5), p=p)(x[0], y[0])
        out = TA.get_elastic_dual_transform(rs=np.random.RandomState(5), p=p)(x[0], y[0])
        _assert_equal_batches([out["image"], out["mask"]], [ref["image"], ref["mask"]])
    ref = JA.random_flip_rotate_crop(np.random.RandomState(6), crop_size=24, out_size=16)(x, y)
    out = TA.random_flip_rotate_crop(np.random.RandomState(6), crop_size=24, out_size=16)(x, y)
    _assert_equal_batches(out, ref)
    assert out[0].shape == (3, 16, 16)


def test_binary_mask_sequence_equal_over_epochs(tmp_path):
    """Shuffled, oversampled, augmented, weighted: the same batches, epoch
    after epoch (the shuffle consumes the shared RandomState)."""
    from tmat_tpu.models.train_segmentation import make_augmentor as jaug
    from tmat_torch.models.train_segmentation import make_augmentor as taug

    imgs, masks = _pairs(tmp_path)
    seqs = []
    for D, aug in ((JD, jaug), (TD, taug)):
        rs = np.random.RandomState(9)
        seqs.append(D.BinaryMaskSequence(4, imgs, masks, rs, augmentation_function=aug(rs, 16),
                                         sample_weights=(0.5, 2.0), repeat_n_times=2))
    ref_seq, seq = seqs
    assert len(seq) == len(ref_seq) == 3
    for _ in range(2):
        for ref, out in zip(ref_seq, seq):
            assert len(out) == 3 and out[0].shape == (4, 16, 16, 1)
            _assert_equal_batches(out, ref)
    plain = TD.BinaryMaskSequence(2, imgs, list(reversed(masks)), np.random.RandomState(0),
                                  shuffle=False)
    with pytest.raises(ValueError, match="do not match"):
        plain[0]


def test_invasion_generator_within_rounding(tmp_path):
    rng = np.random.RandomState(0)
    class_paths = {}
    for label, cls in enumerate(("no_invasion", "invasion")):
        (tmp_path / cls).mkdir()
        for i in range(3 + label):
            Image.fromarray((rng.rand(20, 24) * 255).astype(np.uint8)).save(tmp_path / cls / f"{i}.tif")
        class_paths[label] = sorted(str(p) for p in (tmp_path / cls).glob("*"))
    labels = {"no_invasion": 0, "invasion": 1}
    gens = [D.InvasionDataGenerator(class_paths, labels, 3, (16, 16), np.random.RandomState(2),
                                    class_weights=True, augmentation_function=A.augment_invasion_imgs,
                                    **kw)
            for D, A, kw in ((JD, JA, {}), (TD, TA, {"device": "cpu"}))]
    ref_gen, gen = gens
    assert len(gen) == len(ref_gen) == 2
    for _ in range(2):  # two epochs: the reshuffle draws from the same state
        batches = list(gen)
        ref_batches = list(ref_gen)
        for (x, y, w), (rx, ry, rw) in zip(batches, ref_batches):
            assert isinstance(x, torch.Tensor) and x.shape == (3, 16, 16, 3)
            np.testing.assert_allclose(x.numpy(), rx, atol=1e-6 * 255, rtol=0)
            np.testing.assert_array_equal(y, ry)
            np.testing.assert_array_equal(w, rw)


def test_split_weights_and_loaders_equal(tmp_path):
    paths = {0: [f"a{i}" for i in range(10)], 1: [f"b{i}" for i in range(5)]}
    assert TD.get_train_val_split(paths, 0.2) == JD.get_train_val_split(paths, 0.2)
    assert TD.balanced_class_weights_from_counts({0: 10, 1: 5}) == \
        JD.balanced_class_weights_from_counts({0: 10, 1: 5})
    imgs, masks = _pairs(tmp_path, n=2)
    np.testing.assert_array_equal(TD.load_x(imgs), JD.load_x(imgs))
    np.testing.assert_array_equal(TD.load_y(masks), JD.load_y(masks))
    assert set(np.unique(TD.load_y(masks))) == {0, 1}
