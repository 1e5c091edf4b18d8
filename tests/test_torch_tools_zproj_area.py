"""The port's ``compute_zproj`` and ``compute_cell_area`` against the JAX
tools, both run on the same temp directory of inputs with ``device="cpu"``.

Held to: the same file names and byte-equal files (projections of all five
methods, ``_thresholded.png``, ``cell_area.csv``). With ``-w``, on wells
where no Canny tie decides (see tests/test_torch_wellmask.py), the well
masks and the CSV are byte-equal too: with the port's own unit draws, which
are JAX's, and with the JAX package's passed in (``unit_draws`` patched).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from test_nd2 import write_nd2
from tmat_tpu.tools import compute_cell_area as j_area, compute_zproj as j_zproj
from tmat_torch.core import io as tio
from tmat_torch.ops import wellmask
from tmat_torch.tools import args as su, compute_cell_area, compute_zproj


def _write_plate(root, dtype=np.uint8, n_wells=2, n_z=4, size=96, seed=0):
    """Numbered slice TIFFs, a bright patch sharpest in one slice per well."""
    rng = np.random.RandomState(seed)
    in_dir = root / "in"
    in_dir.mkdir()
    scale = 1 if dtype == np.uint8 else 200
    for w in range(n_wells):
        stack = rng.randint(10, 60, size=(n_z, size, size)).astype(dtype) * scale
        stack[w % n_z, 20:50, 20 + 10 * w : 50 + 10 * w] = 220 * scale
        for z, sl in enumerate(stack):
            Image.fromarray(sl).save(in_dir / f"A{w + 1:02d}_z{z:02d}.tif")
    return in_dir


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _assert_same_tree(out, ref):
    assert _files(out) == _files(ref) and _files(ref)
    for rel in _files(ref):
        assert filecmp.cmp(out / rel, ref / rel, shallow=False), f"{rel} differs"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("method", ["max", "min", "med", "avg", "fs"])
def test_zproj_files_byte_equal(tmp_path, method, dtype):
    in_dir = _write_plate(tmp_path, dtype)
    j_zproj.main(argv=[str(in_dir), str(tmp_path / "jax"), "-m", method])
    compute_zproj.main(argv=[str(in_dir), str(tmp_path / "torch"), "-m", method], device="cpu")
    assert _files(tmp_path / "torch") == [f"A01_{method}.tif", f"A02_{method}.tif"]
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")


def test_zproj_fs_picks_the_sharp_slice(tmp_path):
    in_dir = _write_plate(tmp_path)
    compute_zproj.main(argv=[str(in_dir), str(tmp_path / "out"), "-m", "fs"], device="cpu")
    got = np.asarray(Image.open(tmp_path / "out" / "A02_fs.tif"))
    # along the patch's edge, where the sharp slice has the Laplacian; the
    # flat inside has none and goes to whichever slice's noise is largest
    assert got.dtype == np.uint8 and (got[20, 32:58] == 220).all() and (got[22:48, 30] == 220).all()


@pytest.mark.parametrize("method", ["max", "fs"])
def test_zproj_area_chain(tmp_path, method):
    in_dir = _write_plate(tmp_path)
    j_zproj.main(argv=[str(in_dir), str(tmp_path / "jax"), "-m", method, "--area"])
    compute_zproj.main(argv=[str(in_dir), str(tmp_path / "torch"), "-m", method, "--area"], device="cpu")
    assert os.path.join("calculations", "cell_area.csv") in _files(tmp_path / "torch")
    assert os.path.join("thresholded", f"A01_{method}_thresholded.png") in _files(tmp_path / "torch")
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")


def test_project_is_file_free():
    stack = np.random.RandomState(1).randint(0, 255, (5, 40, 44)).astype(np.uint8)
    for method in ("max", "min"):
        out = compute_zproj.project(stack, method, "cpu")
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, getattr(stack, method)(0))
    assert compute_zproj.project(stack, "avg", "cpu").dtype == np.float32
    fs = compute_zproj.project(stack.astype(np.uint16) * 200, "fs", "cpu")
    assert fs.dtype == np.uint16 and fs.shape == (40, 44)


def _write_projections(root, n=5, seed=2):
    """2-D images of two shapes (two shape buckets) with a bright square."""
    rng = np.random.RandomState(seed)
    in_dir = root / "projs"
    in_dir.mkdir()
    for w in range(n):
        size = (96, 96) if w % 2 == 0 else (80, 112)
        img = rng.randint(10, 40, size=size).astype(np.uint8)
        img[10:40, 10 + 5 * w : 40 + 5 * w] = rng.randint(180, 220, size=(30, 30))
        Image.fromarray(img).save(in_dir / f"B{w}.tif")
    return in_dir


@pytest.mark.parametrize("extra", [["--sd-coef=-2"], [], ["--sd-coef=1.5"]])
def test_cell_area_files_byte_equal(tmp_path, extra):
    in_dir = _write_projections(tmp_path)
    j_area.main(argv=[str(in_dir), str(tmp_path / "jax"), *extra])
    compute_cell_area.main(argv=[str(in_dir), str(tmp_path / "torch"), *extra], device="cpu")
    assert len(_files(tmp_path / "torch")) == 6
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    if extra == ["--sd-coef=-2"]:
        rows = (tmp_path / "torch" / "calculations" / "cell_area.csv").read_text().splitlines()
        assert rows[0] == "image_id,area_pct" and len(rows) == 6
        for row, size in zip(rows[1:], [96 * 96, 80 * 112] * 3):
            assert abs(float(row.split(",")[1]) - 30 * 30 / size * 100) < 1.0, row


def test_cell_area_downsamples_and_max_projects(tmp_path):
    """Z stacks are max-projected; a config with a small ``dsamp_size``
    makes the linear downsample run."""
    in_dir = _write_plate(tmp_path)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"dsamp_size": 64, "sd_coef": -1.5, "rs_seed": null, "batch_size": 1}')
    j_area.main(argv=[str(in_dir), str(tmp_path / "jax"), "-c", str(cfg)])
    compute_cell_area.main(argv=[str(in_dir), str(tmp_path / "torch"), "-c", str(cfg)], device="cpu")
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    assert np.asarray(Image.open(tmp_path / "torch" / "thresholded" / "A01_thresholded.png")).shape == (64, 64)


def _write_wells(tmp_path):
    """Two bright elliptic wells with a bright square at the centre."""
    rng = np.random.RandomState(3)
    in_dir = tmp_path / "wells"
    in_dir.mkdir()
    for w, (h, wd) in enumerate([(150, 150), (180, 260)]):
        rr, cc = np.mgrid[0:h, 0:wd]
        inside = ((rr - h / 2) / (0.42 * h)) ** 2 + ((cc - wd / 2) / (0.42 * wd)) ** 2 <= 1
        img = rng.randint(5, 15, size=(h, wd)).astype(np.uint8)
        img[inside] += 60
        img[h // 2 - 10 : h // 2 + 10, wd // 2 - 10 : wd // 2 + 10] = 220
        Image.fromarray(img).save(in_dir / f"w{w}.tif")
    return in_dir


def test_cell_area_with_well_detection(tmp_path, monkeypatch):
    """-w with the JAX package's draws: byte-equal masks, rasters and CSV."""
    monkeypatch.setattr(
        wellmask, "unit_draws",
        lambda seed, num_iters=25000: np.asarray(
            jax.random.uniform(jax.random.PRNGKey(seed), (num_iters, 6), jnp.float32)))
    in_dir = _write_wells(tmp_path)
    j_area.main(argv=[str(in_dir), str(tmp_path / "jax"), "-w", "--sd-coef=-2"])
    compute_cell_area.main(argv=[str(in_dir), str(tmp_path / "torch"), "-w", "--sd-coef=-2"], device="cpu")
    assert os.path.join("thresholded", "w0_well_mask.png") in _files(tmp_path / "torch")
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    rows = (tmp_path / "torch" / "calculations" / "cell_area.csv").read_text().splitlines()
    pct = float(rows[1].split(",")[1])
    # of the well (about 55% of the frame), not of the frame
    assert abs(pct - 20 * 20 / (np.pi * (0.42 * 150) ** 2) * 100) < 3.0, pct


def test_cell_area_with_default_well_detection(tmp_path):
    """-w with the port's own draws, nothing patched: the same files as the
    JAX tool, byte for byte."""
    in_dir = _write_wells(tmp_path)
    j_area.main(argv=[str(in_dir), str(tmp_path / "jax"), "-w", "--sd-coef=-2"])
    compute_cell_area.main(argv=[str(in_dir), str(tmp_path / "torch"), "-w", "--sd-coef=-2"], device="cpu")
    assert os.path.join("thresholded", "w1_well_mask.png") in _files(tmp_path / "torch")
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")


def test_analyze_images_is_file_free():
    rng = np.random.RandomState(4)
    imgs = [rng.randint(10, 40, size=(64, 64)).astype(np.uint8) for _ in range(3)]
    for img in imgs:
        img[8:24, 8:24] = 200
    thresholded, masks, areas = compute_cell_area.analyze_images(imgs, -2.0, device="cpu")
    assert masks == [None] * 3 and all(t.dtype == np.uint8 and set(np.unique(t)) == {0, 255} for t in thresholded)
    assert all(abs(a - 16 * 16 / 64 ** 2) < 0.01 for a in areas)
    for img, t in zip(imgs, thresholded):  # batching changes nothing
        np.testing.assert_array_equal(compute_cell_area.mask_and_threshold(img, -2.0, device="cpu"), t)


def test_nd2_input(tmp_path):
    """An ND2 stack (written as tests/test_nd2.py writes one) loads through
    the port's chunk parser and projects to the JAX tool's file."""
    stack = np.random.RandomState(5).randint(0, 4000, (5, 24, 32)).astype(np.uint16)
    in_dir = tmp_path / "nd2"
    in_dir.mkdir()
    write_nd2(in_dir / "well.nd2", stack)
    img, sizes = tio.load_image(str(in_dir / "well.nd2"))
    np.testing.assert_array_equal(img, stack)
    assert abs(sizes.X - 0.65) < 1e-9 and abs(sizes.Z - 2.0) < 1e-9
    assert tio.get_image_dims(str(in_dir / "well.nd2")).Z == 5
    for method in ("max", "fs"):
        j_zproj.main(argv=[str(in_dir), str(tmp_path / "jax"), "-m", method])
        compute_zproj.main(argv=[str(in_dir), str(tmp_path / "torch"), "-m", method], device="cpu")
    _assert_same_tree(tmp_path / "torch", tmp_path / "jax")
    (in_dir / "bad.nd2").write_bytes(b"not an nd2 file")
    with pytest.raises(SystemExit) as exc:
        tio.load_image(str(in_dir / "bad.nd2"))
    assert exc.value.code == 1


@pytest.mark.parametrize("case", ["zproj_missing_input", "zproj_mixed_input", "zproj_empty_input",
                                  "area_missing_input", "area_missing_config", "output_is_a_file"])
def test_exit_1_paths(tmp_path, case):
    in_dir = _write_plate(tmp_path, n_wells=1)
    out = str(tmp_path / "out")
    if case == "zproj_missing_input":
        call = lambda: compute_zproj.main(argv=[str(tmp_path / "none"), out], device="cpu")
    elif case == "zproj_mixed_input":
        (in_dir / "sub").mkdir()
        call = lambda: compute_zproj.main(argv=[str(in_dir), out], device="cpu")
    elif case == "zproj_empty_input":
        (tmp_path / "empty").mkdir()
        call = lambda: compute_zproj.main(argv=[str(tmp_path / "empty"), out], device="cpu")
    elif case == "area_missing_input":
        call = lambda: compute_cell_area.main(argv=[str(tmp_path / "none"), out], device="cpu")
    elif case == "area_missing_config":
        call = lambda: compute_cell_area.main(
            argv=[str(in_dir), out, "-c", str(tmp_path / "none.json")], device="cpu")
    else:
        (tmp_path / "out").write_text("a file")
        call = lambda: compute_zproj.main(argv=[str(in_dir), out], device="cpu")
    with pytest.raises(SystemExit) as exc:
        call()
    assert exc.value.code == 1


def test_unique_output_paths_and_save_image(tmp_path):
    first = tmp_path / "a.png"
    assert tio.get_unique_output_filepath(str(first)) == str(first)
    for arr in (np.arange(12, dtype=np.uint8).reshape(3, 4), np.eye(4, dtype=bool),
                np.arange(12, dtype=np.uint16).reshape(3, 4) * 999):
        path = tio.get_unique_output_filepath(first)
        tio.save_image(path, arr)
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back, arr.astype(np.uint8) * 255 if arr.dtype == bool else arr)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a-2.png", "a-3.png", "a.png"]
    tio.save_image(tmp_path / "f.tif", np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4))
    assert np.asarray(Image.open(tmp_path / "f.tif")).dtype == np.float32
    assert su.parse_zproj_args(["i", "o", "-m", "fs", "-a"]).area
