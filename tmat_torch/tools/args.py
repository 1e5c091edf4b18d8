"""Argument parsers and input/output directory checks of the port's tools.

A copy of what the plate, zproj, cell-area, inv_depth and branches tools
use from ``tmat_tpu/tools/args.py``: the same flags per tool,
files-XOR-dirs input validation, Z-stack vs 2-D input resolution,
create-or-warn output verification, the config-file echo and the
multi-process discovery check.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
from glob import glob
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

from tmat_torch.core import io as tio, zdiscovery as zd
from tmat_torch.core.log import SFM, section_footer, section_header


def check_striped_discovery(ids) -> None:
    """Exit 1 unless every process discovered the same ordered work list.

    A multi-process run stripes its work over the discovered inputs
    (``parallel/distributed.py::stripe``), which is coherent only when
    every process sees the same list, that is, when the input (and any
    chained) directory is on storage that they share. A process that
    cannot see an item it owns would drop it without a word. No-op in
    one process."""
    from tmat_torch.parallel.distributed import gather_objects, is_multiprocess

    if not is_multiprocess():
        return
    listings = gather_objects(list(ids))
    if any(listing != listings[0] for listing in listings[1:]):
        print(
            f"{SFM.failure} Input discovery differs across processes "
            "(multi-process runs need their input and output directories on "
            "shared storage); refusing to stripe a divergent work list.",
            flush=True,
        )
        sys.exit(1)


def _input_dir_help() -> None:
    print(
        "Input directory must contain either:\n"
        "  - image files (2-D images or single-file Z stacks), or\n"
        "  - one subdirectory per Z stack holding numbered slice images\n",
        flush=True,
    )


def check_input_dir_structure(input_path: str) -> None:
    """Files XOR dirs, no nesting; exits 1 otherwise."""
    if not osp.isdir(input_path):
        print(
            f"{SFM.failure} Input data directory not found:{os.linesep}\t{input_path}",
            flush=True,
        )
        _input_dir_help()
        sys.exit(1)

    files = list(filter(osp.isfile, glob(osp.join(input_path, "*"))))
    dirs = list(filter(osp.isdir, glob(osp.join(input_path, "*"))))

    if not files and not dirs:
        print(f"{SFM.failure} Input directory is empty: {input_path}", flush=True)
        _input_dir_help()
        sys.exit(1)
    if files and dirs:
        print(
            f"{SFM.failure} Input directory contains both files and subfolders: "
            f"{input_path}",
            flush=True,
        )
        _input_dir_help()
        sys.exit(1)

    nested = list(filter(osp.isdir, glob(osp.join(input_path, "*", "*"))))
    if nested:
        print(
            f"{SFM.failure} Input directory contains nested subfolders:\n"
            + "  \n".join(nested),
            flush=True,
        )
        _input_dir_help()
        sys.exit(1)


def resolve_image_paths(input_path: str) -> Dict[str, Union[str, List[str]]]:
    """Map image IDs to paths: Z-stack sequences, stack files, or 2-D images."""
    test_path = sorted(glob(osp.join(input_path, "*")))[0]
    if os.path.isdir(test_path) or tio.get_image_dims(test_path).Z == 1:
        try:
            img_paths: Dict[str, Union[str, List[str]]] = (
                zd.find_zstack_image_sequences(input_path)
            )
            if any(len(seq) == 1 for seq in img_paths.values()):
                img_paths = {}  # single images: probably projections, not stacks
        except zd.ZStackInputError:
            img_paths = {}
    else:
        try:
            img_paths = zd.find_zstack_files(input_path)
        except zd.ZStackInputError as exc:
            print(f"{SFM.failure} {exc}", flush=True)
            _input_dir_help()
            sys.exit(1)

    if len(img_paths) == 0:
        img_paths = {
            Path(fp).stem: fp
            for fp in sorted(glob(osp.join(input_path, "*")))
            if tio.get_image_dims(fp).Z == 1
        }
    return img_paths


def cell_area_verify_input_dir(input_path: str) -> Dict[str, Union[str, List[str]]]:
    section_header("Verifying Input Directory")
    check_input_dir_structure(input_path)
    img_paths = resolve_image_paths(input_path)
    if len(img_paths) == 0:
        print(f"{SFM.failure}No images found in {input_path}", flush=True)
        _input_dir_help()
        sys.exit(1)
    print(f"Found {len(img_paths)} images in:{os.linesep}\t{input_path}", flush=True)
    print(SFM.success, flush=True)
    section_footer()
    return img_paths


def verify_output_dir(output_path: str, subdirs: Sequence[str] = ()) -> None:
    """Create the output dir (and ``subdirs``), or warn that it is not empty."""
    section_header("Verifying Output Directory")
    if not osp.isdir(output_path):
        if osp.isfile(output_path):
            print(f"{SFM.failure} Output path is a file: {output_path}")
            sys.exit(1)
        print(f"Did not find output dir:{os.linesep}\t{output_path}", flush=True)
        os.makedirs(output_path, exist_ok=True)
        print(f"... Created dir:{os.linesep}\t{output_path}", flush=True)
    elif len(glob(osp.join(output_path, "*"))) > 0:
        print(
            f"{SFM.warning}Output directory is not empty:{os.linesep}\t{output_path}\n"
            f"{SFM.warning}This will add to the existing contents, which might "
            "not be desired.",
            flush=True,
        )
    for sub in subdirs:
        os.makedirs(osp.join(output_path, sub), exist_ok=True)
    print(SFM.success, flush=True)
    section_footer()


def _add_common_io_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("in_root", type=str, help="Root directory of input images.")
    parser.add_argument("out_root", type=str, help="Root directory for output.")
    parser.add_argument(
        "--channel", type=int, default=None,
        help="Index of color channel to read (required for multichannel images).",
    )
    parser.add_argument(
        "--time", type=int, default=None,
        help="Index of time to read (required for time-series images).",
    )


def parse_zproj_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Compute Z projections from image stacks.")
    _add_common_io_args(parser)
    parser.add_argument(
        "-m", "--method", type=str, default="max", choices=["min", "max", "med", "avg", "fs"],
        help="Z projection method.",
    )
    parser.add_argument(
        "-a", "--area", action="store_true", help="Compute cell area after Z projection.",
    )
    return parser.parse_args(argv)


def parse_cell_area_args(arg_defaults: Dict[str, Any], argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Compute cell coverage area of Z projections or 2-D images."
    )
    _add_common_io_args(parser)
    parser.add_argument(
        "-w", "--detect-well", action="store_true",
        help="Auto detect the well boundary and exclude regions outside it.",
    )
    parser.add_argument(
        "--sd-coef", type=float, default=None,
        help="Threshold = foreground mean + sd_coef * foreground SD.",
    )
    parser.add_argument(
        "-c", "--config", type=str, default=arg_defaults["default_config_path"],
        help="Path to the cell-area configuration file.",
    )
    return parser.parse_args(argv)


def parse_inv_depth_args(arg_defaults: Dict[str, Any], argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Predict depth of invasion for each Z slice of input stacks."
    )
    _add_common_io_args(parser)
    parser.add_argument(
        "-c", "--config", type=str, default=arg_defaults["default_config_path"],
        help="Path to the invasion-depth configuration file.",
    )
    return parser.parse_args(argv)


def parse_branching_args(arg_defaults: Dict[str, Any], argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Analyze microvessel branching in Z stacks or projections."
    )
    _add_common_io_args(parser)
    parser.add_argument(
        "-w", "--detect-well", action="store_true",
        help="Auto detect the well boundary and exclude regions outside it.",
    )
    parser.add_argument(
        "--image-width-microns", type=float, default=None,
        help="Physical width in microns of the imaged region.",
    )
    parser.add_argument(
        "--graph-thresh-1", nargs="+", type=float, default=None,
        help="Morse-graph simplification threshold(s); multiple values sweep.",
    )
    parser.add_argument(
        "--graph-thresh-2", nargs="+", type=float, default=None,
        help="Branch connection threshold(s); multiple values sweep.",
    )
    parser.add_argument(
        "--min-branch-length", type=float, default=None,
        help="Minimum branch length (microns) to keep.",
    )
    parser.add_argument(
        "--max-branch-length", type=float, default=None,
        help="Maximum branch length (microns) to keep.",
    )
    parser.add_argument(
        "--remove-isolated-branches", action="store_true",
        help="Remove branches not connected to any other branch.",
    )
    parser.add_argument(
        "--graph-smoothing-window", type=float, default=None,
        help="Window size (microns) for smoothing branch paths.",
    )
    parser.add_argument(
        "--model-cfg-path", type=str, default=None,
        help="Path to a UNet patch segmentor config JSON.",
    )
    parser.add_argument(
        "--no-vis", action="store_true",
        help=(
            "Skip saving visualization PNGs (original/prediction/barcode/"
            "Morse tree) and route branch statistics through the native "
            "C++ Morse engine. Faster for large batches; CSV outputs are "
            "identical."
        ),
    )
    parser.add_argument(
        "--tta", type=int, choices=(1, 4, 8), default=None,
        help=(
            "Dihedral test-time-augmentation variants for the tiled UNet "
            "on the 2-D path (default: the model config's 'tta' key, else "
            "8). Ignored on the 3-D Sato path."
        ),
    )
    parser.add_argument(
        "-c", "--config", type=str, default=arg_defaults["default_config_path"],
        help="Path to the branching configuration file.",
    )
    args = parser.parse_args(argv)
    if not args.remove_isolated_branches:
        # None: the config file's value stands (store_true's False would
        # otherwise override a config-file true)
        args.remove_isolated_branches = None
    return args


def verify_config_file(config_path: str) -> Dict[str, Any]:
    """Load and echo a tool config."""
    section_header("Verifying Config File")
    if not osp.isfile(config_path):
        raise FileNotFoundError(f"Config file not found: {config_path}")
    with open(config_path, "r", encoding="utf8") as fp:
        config = json.load(fp)
    for key, val in config.items():
        print(f"{key}: {val}", flush=True)
    print(SFM.success, flush=True)
    section_footer()
    return config
