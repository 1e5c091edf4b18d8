"""The port's synthetic training data against ``tmat_tpu/models/synthetic.py``:
the same seed gives equal arrays and byte-equal files."""

import filecmp

import numpy as np
from numpy.random import RandomState

from tmat_tpu.models import synthetic as J
from tmat_torch.models import synthetic as S


def _same_trees(a, b):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b and files_a
    for rel in files_a:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


def test_synth_vessel_image_equal():
    for seed, size, n in ((0, 64, None), (3, 48, 4)):
        img, mask = S.synth_vessel_image(RandomState(seed), size, n)
        ref_img, ref_mask = J.synth_vessel_image(RandomState(seed), size, n)
        np.testing.assert_array_equal(img, ref_img)
        np.testing.assert_array_equal(mask, ref_mask)
        assert img.dtype == np.uint8 and set(np.unique(mask)) <= {0, 255} and mask.any()


def test_generate_datasets_byte_equal(tmp_path):
    S.generate_dataset(tmp_path / "port", n=3, size=40, seed=5)
    J.generate_dataset(tmp_path / "jax", n=3, size=40, seed=5)
    _same_trees(tmp_path / "port", tmp_path / "jax")
    S.generate_invasion_dataset(tmp_path / "port_inv", n_per_class=2, size=32, seed=1)
    J.generate_invasion_dataset(tmp_path / "jax_inv", n_per_class=2, size=32, seed=1)
    _same_trees(tmp_path / "port_inv", tmp_path / "jax_inv")
    assert {p.name for p in (tmp_path / "port_inv").iterdir()} == {"invasion", "no_invasion"}


def test_main_writes_both_kinds(tmp_path, capsys):
    S.main([str(tmp_path / "v"), "--n", "2", "--size", "32"])
    S.main([str(tmp_path / "i"), "--n", "1", "--size", "32", "--kind", "invasion", "--seed", "2"])
    J.main([str(tmp_path / "jv"), "--n", "2", "--size", "32"])
    J.main([str(tmp_path / "ji"), "--n", "1", "--size", "32", "--kind", "invasion", "--seed", "2"])
    _same_trees(tmp_path / "v", tmp_path / "jv")
    _same_trees(tmp_path / "i", tmp_path / "ji")
    assert "Wrote 2 image/mask pairs" in capsys.readouterr().out
