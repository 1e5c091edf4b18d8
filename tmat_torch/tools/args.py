"""Input/output directory checks of the plate CLI.

A copy of the three helpers ``tmat_torch.tools.plate_pipeline.main``
calls from ``tmat_tpu/tools/args.py``: files-XOR-dirs input validation,
Z-stack vs 2-D input resolution, and create-or-warn output verification.
The multi-process discovery check is not ported (single process only).
"""

from __future__ import annotations

import os
import os.path as osp
import sys
from glob import glob
from pathlib import Path
from typing import Dict, List, Union

from tmat_torch.core import io as tio, zdiscovery as zd
from tmat_torch.core.log import SFM, section_footer, section_header


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


def verify_output_dir(output_path: str) -> None:
    """Create the output dir, or warn that it is not empty."""
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
    print(SFM.success, flush=True)
    section_footer()
