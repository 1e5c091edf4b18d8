"""Image I/O: TIFF/PNG loading with TCZYX dimension handling and pixel sizes.

A copy of the tools' and the trainers' part of ``tmat_tpu/core/io.py``
(load_image, get_image_dims, probe_image_header, probe_image_dims,
save_image, get_unique_output_filepath, get_img_mask_paths). TIFF and PNG are read and written with PIL,
imported inside the loaders and savers only; Nikon ND2 goes through the
chunk parser ``core/nd2.py`` (an installed ``nd2`` package is preferred
when present). Returned layout: ZYX (or YX when Z==1) plus
PhysicalPixelSizes.
"""

from __future__ import annotations

import os.path as osp
import sys
from glob import glob
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
from numpy.typing import NDArray

from tmat_torch.core.defs import SUPPORTED_IMAGE_FORMATS
from tmat_torch.core.log import SFM


class PhysicalPixelSizes(NamedTuple):
    """Physical pixel sizes in microns (None if unparsable)."""

    Z: Optional[float]
    Y: Optional[float]
    X: Optional[float]


class ImageDims(NamedTuple):
    """TCZYX dimensions of an image file."""

    T: int
    C: int
    Z: int
    Y: int
    X: int


_UNIT_TO_MICRON = {
    "um": 1.0,
    "µm": 1.0,
    "micron": 1.0,
    "microns": 1.0,
    "micrometer": 1.0,
    "mm": 1000.0,
    "millimeter": 1000.0,
    "cm": 10000.0,
    "nm": 0.001,
    "m": 1e6,
    "inch": 25400.0,
}


def _parse_imagej_description(desc: str) -> dict:
    """Parse ImageJ-style key=value ImageDescription metadata."""
    meta = {}
    for line in desc.replace("\r", "\n").split("\n"):
        if "=" in line:
            key, _, val = line.partition("=")
            meta[key.strip()] = val.strip()
    return meta


def _tiff_pixel_sizes(img, meta: dict) -> PhysicalPixelSizes:
    """Derive pixel sizes (microns) from TIFF resolution tags + ImageJ metadata."""
    unit_scale = None
    unit = meta.get("unit", "").lower()
    if unit in _UNIT_TO_MICRON:
        unit_scale = _UNIT_TO_MICRON[unit]
    else:
        # TIFF ResolutionUnit tag: 2 = inch, 3 = cm
        res_unit = img.tag_v2.get(296) if hasattr(img, "tag_v2") else None
        if res_unit == 2:
            unit_scale = _UNIT_TO_MICRON["inch"]
        elif res_unit == 3:
            unit_scale = _UNIT_TO_MICRON["cm"]

    size_x = size_y = size_z = None
    if unit_scale is not None and hasattr(img, "tag_v2"):
        xres = img.tag_v2.get(282)  # pixels per unit
        yres = img.tag_v2.get(283)
        if xres:
            xres = float(xres)
            if xres > 0:
                size_x = unit_scale / xres
        if yres:
            yres = float(yres)
            if yres > 0:
                size_y = unit_scale / yres
    if "spacing" in meta:
        try:
            spacing = float(meta["spacing"])
            size_z = spacing * (unit_scale if unit_scale is not None else 1.0)
        except ValueError:
            pass
    return PhysicalPixelSizes(Z=size_z, Y=size_y, X=size_x)


def _read_pages(img) -> np.ndarray:
    """Read all pages of a (possibly multi-page) PIL image to (N, Y, X)."""
    from PIL import ImageSequence

    # RGB(A) pages come back (Y, X, S); the caller moves S to a channel axis
    pages = [np.asarray(frame) for frame in ImageSequence.Iterator(img)]
    return np.stack(pages) if len(pages) > 1 else pages[0][None]


def _dims_from_pages(total_pages: int, samples: int, meta: dict) -> Tuple[int, int, int]:
    """(T, C, Z) from a page count + ImageJ metadata.

    Single source of truth for the hyperstack arithmetic: the decoding
    path (_load_single_file) and the header-only probe (probe_image_header)
    must agree or streaming plate loaders would size batches wrong. Page
    order in ImageJ files is XYCZT: page_index = t * (Z*C) + z * C + c.
    """
    n_c = int(meta.get("channels", samples) or 1)
    n_z = int(meta.get("slices", 0) or 0)
    n_t = int(meta.get("frames", 1) or 1)
    if n_z == 0:
        n_z = max(total_pages // max(n_c * n_t, 1), 1)
    if n_c * n_z * n_t != total_pages:
        # Metadata doesn't add up; fall back to pages-as-Z.
        n_c, n_t, n_z = 1, 1, total_pages
    return n_t, n_c, n_z


def _load_nd2(file_path: str) -> Tuple[np.ndarray, PhysicalPixelSizes, ImageDims]:
    """Load a Nikon .nd2 Z stack. Prefers an installed ``nd2`` package;
    otherwise uses the pure-Python chunk parser (core/nd2.py). The sequence
    axis is read as Z (the tools' .nd2 inputs are single-position stacks)."""
    try:
        import nd2 as _nd2_ext  # optional external backend

        with _nd2_ext.ND2File(file_path) as f:
            arr = np.asarray(f.asarray())
            vs = f.voxel_size()  # (x, y, z) in microns
            sizes = PhysicalPixelSizes(Z=vs.z, Y=vs.y, X=vs.x)
            # normalise to (Z, C, Y, X)
            if arr.ndim == 2:
                arr = arr[None, None]
            elif arr.ndim == 3:
                arr = arr[:, None]
    except ImportError:
        from tmat_torch.core.nd2 import ND2ParseError, read_nd2

        try:
            arr, px = read_nd2(file_path)  # (Z, C, Y, X)
        except (ND2ParseError, OSError) as e:
            print(f"{SFM.failure} Could not parse ND2 file {file_path}: {e}\n", flush=True)
            sys.exit(1)
        sizes = PhysicalPixelSizes(Z=px["Z"], Y=px["Y"], X=px["X"])

    n_z, n_c, height, width = arr.shape
    tczyx = arr.transpose(1, 0, 2, 3)[None]  # (1, C, Z, Y, X)
    dims = ImageDims(T=1, C=n_c, Z=n_z, Y=height, X=width)
    return tczyx, sizes, dims


def _load_single_file(file_path: str) -> Tuple[np.ndarray, PhysicalPixelSizes, ImageDims]:
    """Load one file to a TCZYX array with metadata."""
    ext = Path(file_path).suffix.lower().lstrip(".")
    fmt_name = {"tif": "TIFF", "tiff": "TIFF", "png": "PNG", "jpg": "JPEG", "jpeg": "JPEG"}.get(ext)
    if ext == "nd2":
        return _load_nd2(file_path)
    if fmt_name is None:
        print(
            f"{SFM.failure} Unsupported image format: {file_path}\n"
            f"Supported formats: {SUPPORTED_IMAGE_FORMATS}\n"
        )
        sys.exit(1)

    from PIL import Image

    with Image.open(file_path) as img:
        desc = ""
        if hasattr(img, "tag_v2"):
            desc = img.tag_v2.get(270, "") or ""
        meta = _parse_imagej_description(str(desc))
        pixel_sizes = (
            _tiff_pixel_sizes(img, meta)
            if fmt_name == "TIFF"
            else PhysicalPixelSizes(None, None, None)
        )
        pages = _read_pages(img)  # (N, Y, X) or (N, Y, X, S)

    if pages.ndim == 4:
        # Color pages: move samples to a channel axis (C)
        n_pages, height, width, samples = pages.shape
        pages = np.moveaxis(pages, -1, 1).reshape(n_pages * samples, height, width)
        n_channels_from_color = samples
    else:
        n_channels_from_color = 1

    n_t, n_c, n_z = _dims_from_pages(len(pages), n_channels_from_color, meta)
    height, width = pages.shape[-2:]
    tczyx = pages.reshape(n_t, n_z, n_c, height, width).transpose(0, 2, 1, 3, 4)
    dims = ImageDims(T=n_t, C=n_c, Z=n_z, Y=height, X=width)
    return tczyx, pixel_sizes, dims


def load_image(
    file_path: Union[str, Path, List[str]],
    T: Optional[int] = None,
    C: Optional[int] = None,
) -> Tuple[NDArray, PhysicalPixelSizes]:
    """Load a ZYX (or YX if single-slice) image plus physical pixel sizes.

    Mirrors helper.py:23-95: a list of paths is stacked into a Z stack;
    time-series/multichannel files require explicit T / C indices.
    """
    if isinstance(file_path, (list, tuple)):
        images, sizes = zip(*[load_image(fp, T, C) for fp in file_path])
        return np.array(images), sizes[0]

    file_path = str(file_path)
    tczyx, pixel_sizes, dims = _load_single_file(file_path)

    if T is None:
        if dims.T > 1:
            raise ValueError(
                f"{file_path} is a time series image but no time index was specified."
            )
        T = 0
    elif T >= dims.T or T < 0:
        raise ValueError(
            f"Time {T} is out of range for {file_path} with times: 0 - {dims.T - 1}"
        )

    if C is None:
        if dims.C > 1:
            raise ValueError(
                f"{file_path} is a multi channel image but no color channel index "
                "was specified."
            )
        C = 0
    elif C >= dims.C or C < 0:
        raise ValueError(
            f"Color channel {C} is out of range for {file_path} "
            f"with color channels: 0 - {dims.C - 1}"
        )

    image = tczyx[T, C]
    if len(image) == 1:
        return image[0], pixel_sizes
    return image, pixel_sizes


def get_image_dims(file_path: str) -> ImageDims:
    """TCZYX dimensions from file metadata (helper.py:123-139)."""
    _, _, dims = _load_single_file(str(file_path))
    return dims


def probe_image_header(file_path: str) -> Optional[Tuple[ImageDims, str]]:
    """Header-only (TCZYX dims, PIL mode) from ONE file open: page count +
    ImageJ metadata, NO pixel decode (PIL's n_frames walks TIFF IFDs
    without decompressing). Used by streaming plate loaders to size the
    padded batch — dims AND dtype — before any well is decoded. Returns
    None when the header needs a full decode (ND2, unreadable headers).
    """
    file_path = str(file_path)
    ext = Path(file_path).suffix.lower().lstrip(".")
    if ext not in ("tif", "tiff", "png", "jpg", "jpeg"):
        return None
    from PIL import Image

    try:
        with Image.open(file_path) as img:
            n_pages = getattr(img, "n_frames", 1)
            desc = ""
            if hasattr(img, "tag_v2"):
                desc = img.tag_v2.get(270, "") or ""
            meta = _parse_imagej_description(str(desc))
            height, width = img.height, img.width
            samples = len(img.getbands())
            mode = img.mode
    except (OSError, ValueError):
        return None

    n_t, n_c, n_z = _dims_from_pages(n_pages * samples, samples, meta)
    return ImageDims(T=n_t, C=n_c, Z=n_z, Y=height, X=width), mode


def probe_image_dims(file_path: str) -> Optional[ImageDims]:
    """Header-only TCZYX dims (see probe_image_header); None when dims
    need a full decode: callers fall back to get_image_dims."""
    probed = probe_image_header(file_path)
    return probed[0] if probed else None


def save_image(file_path: Union[str, Path], img: np.ndarray) -> None:
    """Save a 2-D image, preserving dtype semantics like cv2.imwrite.

    uint8/uint16 are written natively; bool is scaled to uint8; floats are
    written as 32-bit float TIFF (or clipped uint8 for PNG, where float has
    no representation).
    """
    from PIL import Image

    file_path = str(file_path)
    ext = Path(file_path).suffix.lower()
    img = np.asarray(img)
    if img.dtype == bool:
        img = img.astype(np.uint8) * 255
    if np.issubdtype(img.dtype, np.floating):
        if ext in (".tif", ".tiff"):
            Image.fromarray(img.astype(np.float32), mode="F").save(file_path)
            return
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    if img.dtype == np.uint16:
        Image.fromarray(img, mode="I;16").save(file_path)
        return
    if img.dtype not in (np.uint8,):
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(file_path)


def get_unique_output_filepath(file: Union[str, Path]) -> Union[str, Path]:
    """Suffix ``-N`` until the path doesn't collide."""
    is_pathlib = isinstance(file, Path)
    file = Path(file)
    dirname = Path(osp.dirname(file))
    name, ext = osp.splitext(osp.basename(file))
    file_num = 1
    while file.exists():
        file_num += 1
        file = dirname / f"{name}-{file_num}{ext}"
    return file if is_pathlib else str(file)


def get_img_mask_paths(
    img_dir: str,
    mask_dir: Optional[str] = None,
    img_suffix_pattern: str = ".tif",
    label_suffix_pattern: str = "_mask.tif",
) -> List[Tuple[str, str]]:
    """Pair image and mask paths 1:1 with strict validation."""
    if mask_dir is None:
        mask_dir = img_dir

    same_dir = img_dir == mask_dir
    if same_dir and img_suffix_pattern == label_suffix_pattern:
        raise ValueError("directories and suffixes for images and labels are identical")
    exclude_mask_suffix = same_dir and label_suffix_pattern.endswith(img_suffix_pattern)
    exclude_img_suffix = same_dir and img_suffix_pattern.endswith(label_suffix_pattern)

    img_paths = glob(osp.join(img_dir, f"*{img_suffix_pattern}"))
    if exclude_mask_suffix:
        img_paths = [fp for fp in img_paths if not fp.endswith(label_suffix_pattern)]

    mask_filenames = [Path(fp).name for fp in glob(osp.join(mask_dir, f"*{label_suffix_pattern}"))]
    if exclude_img_suffix:
        mask_filenames = [fn for fn in mask_filenames if not fn.endswith(img_suffix_pattern)]

    if len(img_paths) != len(mask_filenames):
        raise ValueError(
            f"number of images ({len(img_paths)}) and labels "
            f"({len(mask_filenames)}) is different"
        )
    img_paths = sorted(img_paths)
    mask_paths = []
    for img_path in img_paths:
        sample_name = Path(img_path).name.replace(img_suffix_pattern, "")
        mask_fname = sample_name + label_suffix_pattern
        if mask_fname not in mask_filenames:
            raise ValueError(f"label {mask_fname} not found for image {Path(img_path).name}")
        mask_paths.append(osp.join(mask_dir, mask_fname))

    return [*zip(img_paths, mask_paths)]
