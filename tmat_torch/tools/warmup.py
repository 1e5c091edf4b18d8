"""Build the native libraries and run each tool once, for fast cold starts.

Counterpart of ``tmat_tpu/tools/warmup.py``. The port compiles no program
at run time, so its cold start is the build of its native libraries
(``build.py``): the four CUDA kernels and the three host engines, each
kept in the build cache under a key of its source, command line and
toolchain. This tool builds them all (compilers started together), so a
later process finds every library in the cache and builds none; then it
runs each chosen tool once on synthetic stacks at the user's geometry,
which also takes each tool's first-call costs in this process (cuDNN's
algorithm setup on the card, the ensemble and segmentor loads). Only the
libraries outlive the process.

``--size`` (pixels per side) and ``--z`` (slices per stack) set the
synthetic stacks; the libraries do not depend on them. One stack is
written per process, so that under torchrun every process runs each tool
on a stack of its own. The branches run skips the pictures (``--no-vis``):
nobody looks at them, and the rows are the same.

Usage: tmat-torch warmup [--size 1024] [--z 8] [--tools zproj area branches inv_depth plate]
"""

from __future__ import annotations

import argparse
import hashlib
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from tmat_torch import build
from tmat_torch.core import io as tio
from tmat_torch.core.log import SFM
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.parallel.distributed import maybe_initialize_from_env, process_count

TOOL_CHOICES = ("zproj", "area", "branches", "inv_depth", "plate")


def _parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="warmup",
        description="Build the native libraries into the build cache and run each tool "
        "once at a fixed geometry.",
    )
    parser.add_argument("--size", type=int, default=1024,
                        help="Image side length in pixels of the synthetic stacks.")
    parser.add_argument("--z", type=int, default=8, help="Z slices per synthetic stack.")
    parser.add_argument("--tools", nargs="+", choices=TOOL_CHOICES, default=list(TOOL_CHOICES),
                        help="Subset of tools to run (default: all).")
    parser.add_argument("--image-width-microns", type=float, default=1000.0,
                        help="Physical width passed to the branches and plate runs.")
    return parser.parse_args(argv)


def build_libraries(device: torch.device) -> Dict[str, Path]:
    """Every native library that ``device``'s paths load, all compilers
    started together: the host engines, and on CUDA the four kernels (the
    int8 conv of the opt-in quantized segmentor among them)."""
    from tmat_torch.ops import focus_stack, int8_conv, resize_lanczos4

    jobs = {name: (lambda n=name: build.host_library(n)) for name in build.HOST_LIBRARIES}
    if device.type == "cuda":
        jobs["down_block"] = lambda: build.cuda_library("down_block")
        jobs["focus_stack"] = focus_stack.library_path
        jobs["int8_conv"] = int8_conv.library_path
        jobs["resize_lanczos4"] = resize_lanczos4.library_path
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def _write_stack(dirpath: Path, n_z: int, size: int, rng: np.random.RandomState) -> None:
    """One synthetic Z stack as a ``W1_z{i}.tif`` slice sequence."""
    dirpath.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for z in range(n_z):
        sl = rng.randint(10, 40, size=(size, size)).astype(np.uint8)
        # a few bright line segments, so that every stage sees structure
        for k in range(4):
            c = (k + 1) * size // 5
            band = (np.abs(yy - xx + c - size // 2) < 2) | (np.abs(xx - c) < 1)
            sl[band] = 200
        tio.save_image(dirpath / f"W1_z{z:02d}.tif", sl)


def output_digest(root: Path) -> str:
    """sha256 of every file under ``root``: relative paths and bytes."""
    h = hashlib.sha256()
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(root)).encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def main(args=None, argv=None, device: DeviceLike = None):
    """Warm the build cache and each tool. ``device=None`` means CUDA."""
    maybe_initialize_from_env()
    args = args if args is not None else _parse(argv)
    dev = resolve_device(device)

    print(f"{SFM.info} Build cache: {build.build_dir()}", flush=True)
    before, t0 = build.builds, time.perf_counter()
    libraries = build_libraries(dev)
    print(f"{SFM.success} {build.builds - before} of {len(libraries)} native libraries built "
          f"in {time.perf_counter() - t0:.1f}s, the rest found in the cache.", flush=True)
    print(f"{SFM.info} Warming {', '.join(args.tools)} at size={args.size} z={args.z}", flush=True)

    rng = np.random.RandomState(0)
    tmp = Path(tempfile.mkdtemp(prefix="tmat_warmup_"))
    try:
        in_dir = tmp / "in"
        for w in range(process_count()):
            _write_stack(in_dir / f"stack_W{w + 1}", args.z, args.size, rng)
        width = str(args.image_width_microns)
        runs = []
        if "zproj" in args.tools:
            from tmat_torch.tools import compute_zproj

            runs.append(("zproj", lambda out: compute_zproj.main(
                argv=[str(in_dir), str(out), "-m", "fs"], device=dev)))
        if "area" in args.tools:
            from tmat_torch.tools import compute_cell_area

            runs.append(("area", lambda out: compute_cell_area.main(
                argv=[str(in_dir), str(out), "-w"], device=dev)))
        if "inv_depth" in args.tools:
            from tmat_torch.tools import compute_inv_depth

            runs.append(("inv_depth", lambda out: compute_inv_depth.main(
                argv=[str(in_dir), str(out)], device=dev)))
        if "branches" in args.tools:
            from tmat_torch.tools import compute_branches

            runs.append(("branches", lambda out: compute_branches.main(
                argv=[str(in_dir), str(out), "--image-width-microns", width, "--no-vis"],
                device=dev)))
        if "plate" in args.tools:
            from tmat_torch.tools import plate_pipeline

            runs.append(("plate", lambda out: plate_pipeline.main(
                argv=[str(in_dir), str(out), "--image-width-microns", width], device=dev)))

        for name, run in runs:
            out = tmp / f"out_{name}"
            out.mkdir()
            t0 = time.perf_counter()
            run(out)
            print(f"{SFM.success} {name} warmed in {time.perf_counter() - t0:.1f}s "
                  f"(outputs sha256 {output_digest(out)})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
