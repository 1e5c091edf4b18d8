"""Compute cell coverage area in a directory of Z stacks or Z projections.

Counterpart of ``tmat_tpu/tools/compute_cell_area.py``: 3-D inputs are
max-projected, every image is downsampled to ``dsamp_size``, rescaled to
[0, 1], optionally masked to its detected well, thresholded by the
2-component GMM and written as ``thresholded/{id}_thresholded.png``
(``{id}_well_mask.png`` with ``-w``), the covered fraction going to
``calculations/cell_area.csv`` (image_id, area_pct). Same flags, prints,
file names and exit codes. Under torchrun each process analyses a
round-robin stripe of the images and writes their PNGs; the primary
writes the CSV from every process's rows (``parallel/distributed.py``).
The device work is ``analyze_images``, which takes and returns arrays and
touches no file.

Usage:
    python -m tmat_torch.tools.compute_cell_area IN_DIR OUT_DIR [-w] [--sd-coef X]
"""

from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tmat_torch.core import defs, io as tio
from tmat_torch.core.log import END_SEPARATOR, SFM, section_footer, section_header
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import downsample_max_dim_shape, resize
from tmat_torch.ops.threshold import exec_threshold_batch
from tmat_torch.ops.wellmask import generate_well_mask
from tmat_torch.parallel.distributed import (
    is_multiprocess, is_primary, maybe_initialize_from_env, merge_striped_rows, process_index, stripe,
    sync_processes)
from tmat_torch.tools import args as su

THRESH_SUBDIR = "thresholded"
CALC_SUBDIR = "calculations"
DEFAULT_CONFIG_NAME = "default_cell_area_computation.json"


def downsample(img: np.ndarray, dsamp_size: int, device: DeviceLike = None) -> np.ndarray:
    """Resize a 2-D image so that its longer side is ``dsamp_size``
    (linear, float32; on ``device``, None = CUDA)."""
    target = downsample_max_dim_shape(img.shape, dsamp_size)
    x = torch.from_numpy(img.astype(np.float32)).to(resolve_device(device))
    return resize(x, target, "linear").cpu().numpy()


def load_img(img_path, dsamp_size=None, T=None, C=None, device: DeviceLike = None) -> np.ndarray:
    """Load, max-project if 3-D, and downsample to ``dsamp_size``."""
    img = tio.load_image(img_path, T, C)[0]
    if img.ndim == 3:
        img = img.max(0)
    if dsamp_size is not None:
        img = downsample(img, dsamp_size, device)
    return img


def _threshold_batch(imgs: torch.Tensor, sd_coef: float, well_masks: Optional[torch.Tensor]
                     ) -> np.ndarray:
    """uint8 {0, 255} rasters of a same-shape (B, H, W) batch."""
    x = rescale_intensity(imgs.float(), dims=(-2, -1))
    if well_masks is not None:
        x = torch.where(well_masks > 0, x, 0.0)
    out = exec_threshold_batch(x, well_masks, float(sd_coef))
    return ((out > 0).to(torch.uint8) * defs.MAX_UINT8).cpu().numpy()


def mask_and_threshold(img, sd_coef, well_mask=None, device: DeviceLike = None) -> np.ndarray:
    """Rescale to [0, 1], mask, GMM-threshold and binarise one image."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(img).astype(np.float32)).to(dev)[None]
    wm = None if well_mask is None else torch.from_numpy(np.asarray(well_mask)).to(dev)[None]
    return _threshold_batch(x, sd_coef, wm)[0]


def analyze_images(imgs: Sequence[np.ndarray], sd_coef: float, detect_well: bool = False,
                   seed: int = 0, device: DeviceLike = None
                   ) -> Tuple[List[np.ndarray], List[Optional[np.ndarray]], List[float]]:
    """The tool's device work on 2-D arrays: (thresholded uint8 rasters,
    well masks or Nones, covered fractions). The fraction is of the well's
    pixels with ``detect_well``, else of the frame. Images of one shape are
    thresholded as one batch; each image's fit stops on its own, so the
    batching does not change a result."""
    dev = resolve_device(device)
    imgs = [np.asarray(img) for img in imgs]
    well_masks: List[Optional[np.ndarray]] = [None] * len(imgs)
    if detect_well:
        well_masks = [generate_well_mask(img, mask_val=defs.MAX_UINT8, seed=seed, device=dev)
                      for img in imgs]

    buckets = defaultdict(list)
    for i, img in enumerate(imgs):
        buckets[img.shape].append(i)
    thresholded: List[Optional[np.ndarray]] = [None] * len(imgs)
    for idxs in buckets.values():
        batch = torch.from_numpy(np.stack([imgs[i].astype(np.float32) for i in idxs])).to(dev)
        wms = None
        if detect_well:
            wms = torch.from_numpy(np.stack([well_masks[i] for i in idxs])).to(dev)
        for i, out in zip(idxs, _threshold_batch(batch, sd_coef, wms)):
            thresholded[i] = out

    areas = []
    for timg, wm in zip(thresholded, well_masks):
        ref_area = timg.size if wm is None else int((wm > 0).sum())
        areas.append(float((timg > 0).sum()) / ref_area)
    return thresholded, well_masks, areas


def main(args=None, argv=None, device: DeviceLike = None):
    """Computes cell area and saves to output directory.
    ``device=None`` means CUDA."""
    maybe_initialize_from_env()
    default_config_path = str(defs.default_config_path(DEFAULT_CONFIG_NAME))
    if args is None:
        args = su.parse_cell_area_args({"default_config_path": default_config_path}, argv)
        args_prespecified = False
    else:
        args_prespecified = True
    dev = resolve_device(device)

    all_img_paths = su.cell_area_verify_input_dir(args.in_root)
    # every process lists the input before any creates the output's subdirs:
    # the zproj --area chain reads and writes the same directory
    sync_processes("cell_area input discovered")

    try:
        su.verify_output_dir(args.out_root, [THRESH_SUBDIR, CALC_SUBDIR])
    except PermissionError as error:
        print(f"{SFM.failure} {error}", flush=True)
        sys.exit(1)

    config_path = (
        default_config_path
        if args_prespecified or getattr(args, "config", None) is None
        else args.config
    )
    try:
        config = su.verify_config_file(config_path)
    except FileNotFoundError as error:
        print(f"{SFM.failure} {error}", flush=True)
        sys.exit(1)

    section_header("Performing Analysis")

    dsamp_size = config["dsamp_size"]
    cli_sd_coef = getattr(args, "sd_coef", None)
    sd_coef = config["sd_coef"] if cli_sd_coef is None else cli_sd_coef
    batch_size = config["batch_size"]
    detect_well = getattr(args, "detect_well", False)
    rs_seed = config.get("rs_seed", 0)
    rs_seed = 0 if rs_seed in (None, "None") else int(rs_seed)

    # each process analyses its stripe and writes its PNGs; the primary
    # writes the CSV from every process's rows, in discovery order
    su.check_striped_discovery(list(all_img_paths))
    indexed_items = stripe(enumerate(all_img_paths.items()))
    global_idxs = [i for i, _ in indexed_items]
    img_ids = [k for _, (k, _) in indexed_items]
    img_path_list = [v for _, (_, v) in indexed_items]

    if img_path_list:
        test_img_path = np.atleast_1d(img_path_list[0])[0]
        if tio.get_image_dims(test_img_path).Z > 1:
            print(
                f"{SFM.warning} Input images are Z stacks. Creating maximum "
                "intensity Z projections prior to cell area calculation.",
                flush=True,
            )

    area_prop = []
    gmm_thresh_all = []
    all_well_masks = []
    stripe_error = None
    for start in range(0, len(img_path_list), batch_size):
        try:
            imgs = [
                load_img(p, dsamp_size=dsamp_size, T=args.time, C=args.channel, device=dev)
                for p in img_path_list[start : start + batch_size]
            ]
        except OSError as error:
            print(f"{SFM.failure}{error}", flush=True)
            if is_multiprocess():
                # fail together after the row gather: exiting alone would
                # leave the peers waiting in it
                stripe_error = f"process {process_index()}: {error}"
                break
            sys.exit(1)
        thresholded, well_masks, areas = analyze_images(imgs, sd_coef, detect_well, rs_seed, dev)
        gmm_thresh_all.extend(thresholded)
        all_well_masks.extend(well_masks)
        area_prop.extend(areas)

    print("... Areas computed successfully.", flush=True)
    print(SFM.success, flush=True)
    section_footer()

    section_header("Saving Results...")
    clean_ids = [i.replace("/", "_").replace("\\", "_") for i in img_ids]
    # after a caught failure, the images analysed before it
    clean_ids = clean_ids[: len(gmm_thresh_all)]
    for i, img_id in enumerate(clean_ids):
        if detect_well:
            file = os.path.join(args.out_root, THRESH_SUBDIR, f"{img_id}_well_mask.png")
            tio.save_image(tio.get_unique_output_filepath(file), all_well_masks[i])
        file = os.path.join(args.out_root, THRESH_SUBDIR, f"{img_id}_thresholded.png")
        tio.save_image(tio.get_unique_output_filepath(file), gmm_thresh_all[i])

    rows = [(gi, img_id, np.float64(prop) * 100)
            for gi, img_id, prop in zip(global_idxs, clean_ids, area_prop)]
    merged, errors = merge_striped_rows(rows, stripe_error)
    if errors:
        for e in errors:
            print(f"{SFM.failure} {e}", flush=True)
        sys.exit(1)
    if is_primary():
        area_out_path = os.path.join(args.out_root, CALC_SUBDIR, "cell_area.csv")
        area_out_path = tio.get_unique_output_filepath(area_out_path)
        with open(area_out_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["image_id", "area_pct"])
            for _, img_id, pct in merged:
                writer.writerow([img_id, pct])
        print(f"... Area calculations saved to:{os.linesep}\t{area_out_path}", flush=True)
    print(SFM.success, flush=True)
    print(END_SEPARATOR, flush=True)


if __name__ == "__main__":
    main()
