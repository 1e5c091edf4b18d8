"""Compute Z projections from image stacks.

Counterpart of ``tmat_tpu/tools/compute_zproj.py``: one projection per
stack by one of five methods (min/max/med/avg/focus stacking), saved as
``{id}_{method}{ext}``, optionally chained into the cell-area tool on the
output directory. Same flags, prints, file names and exit codes. Under
torchrun each process projects a round-robin stripe of the stacks
(``parallel/distributed.py``). The device work is ``project``, which takes
and returns arrays and touches no file.

Usage:
    python -m tmat_torch.tools.compute_zproj IN_DIR OUT_DIR [-m fs] [--area]
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from tmat_torch.core import defs, io as tio
from tmat_torch.core.log import END_SEPARATOR, SFM, section_header
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.ops.zproj import PROJ_METHODS
from tmat_torch.parallel.distributed import (
    gather_objects, is_multiprocess, maybe_initialize_from_env, process_index, stripe, sync_processes)
from tmat_torch.tools import args as su


def project(img: np.ndarray, method: str, device: DeviceLike = None) -> np.ndarray:
    """The ``method`` projection of a (Z, H, W) array on ``device``
    (None = CUDA), back on the host. min/max/fs keep the dtype; med and avg
    of integer stacks are float32."""
    dev = resolve_device(device)
    img = np.ascontiguousarray(img)
    return PROJ_METHODS[method](torch.from_numpy(img).to(dev)).cpu().numpy()


def main(args=None, argv=None, device: DeviceLike = None):
    """Computes z projections and saves to output directory.
    ``device=None`` means CUDA."""
    maybe_initialize_from_env()
    if args is None:
        args = su.parse_zproj_args(argv)
        args_prespecified = False
    else:
        args_prespecified = True
    dev = resolve_device(device)

    compute_area_after = getattr(args, "area", False)

    su.check_input_dir_structure(args.in_root)

    zstack_paths = su.resolve_image_paths(args.in_root)
    if not zstack_paths:
        print(f"{SFM.failure} No Z stacks found in {args.in_root}", flush=True)
        sys.exit(1)

    su.verify_output_dir(args.out_root)

    section_header("Constructing Z Projections")
    print("Loading and computing Z stacks...", flush=True)

    # each process projects its stripe of the stacks; every output is a file
    # of its own stack, so nothing is gathered but the errors
    su.check_striped_discovery(list(zstack_paths))
    stripe_error = None
    for zs_id, zs_path in stripe(zstack_paths.items()):
        print(f"Processing {zs_id}...", flush=True)
        try:
            img, _ = tio.load_image(zs_path, args.time, args.channel)
        except OSError as error:
            print(f"{SFM.failure}{error}", flush=True)
            if is_multiprocess():
                # fail together after the gather below: exiting alone would
                # leave the peers waiting in it
                stripe_error = f"process {process_index()}: {error}"
                break
            sys.exit(1)
        # med/avg of integer stacks produce floats; save_image keeps them as
        # float TIFFs
        zproj = project(img, args.method, dev)
        out_ext = Path(np.atleast_1d(zs_path)[0]).suffix.lower()
        if out_ext not in (".tif", ".tiff", ".png"):
            out_ext = ".tiff"
        save_path = os.path.join(args.out_root, f"{zs_id}_{args.method}{out_ext}")
        save_path = tio.get_unique_output_filepath(save_path)
        tio.save_image(save_path, zproj)
        print(f"Z projection saved to {save_path}", flush=True)

    if is_multiprocess():
        errors = [e for e in gather_objects(stripe_error) if e]
        if errors:
            for e in errors:
                print(f"{SFM.failure} {e}", flush=True)
            sys.exit(1)

    print("... Projections saved.", flush=True)
    print(SFM.success, flush=True)
    print(END_SEPARATOR, flush=True)

    if compute_area_after:
        from tmat_torch.tools import compute_cell_area

        # every process's projections are written before the area tool
        # lists the output directory
        sync_processes("zproj->area")
        if args_prespecified:
            compute_cell_area.main(args, device=dev)
        else:
            # chain the area computation with out_root as input and output
            chained_argv = [args.out_root, args.out_root]
            if args.channel is not None:
                chained_argv += ["--channel", str(args.channel)]
            if args.time is not None:
                chained_argv += ["--time", str(args.time)]
            area_args = su.parse_cell_area_args(
                {"default_config_path": str(
                    defs.default_config_path("default_cell_area_computation.json"))},
                chained_argv,
            )
            compute_cell_area.main(area_args, device=dev)


if __name__ == "__main__":
    main()
