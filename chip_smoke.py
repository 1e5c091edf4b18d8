"""Drive the PyTorch/CUDA port (tmat_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--wells 8] [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name, count and power limit (no CUDA device: exit 1);
2. build: the two CUDA kernels and the three host libraries, from the
   sources in this checkout, all compilers started together, into an
   empty build cache (``TMAT_TORCH_BUILD_DIR``, a temporary directory);
3. kernel: the fused down block against its plain PyTorch version at the
   three production block shapes (B=8, f32 and bf16) and at an odd-width
   block, so that both forms of the kernel (the warpgroup form of the bf16
   production blocks, and the general form) are held, then timed at B=200
   (CUDA events) beside its plain version and its bound on this card;
4. unet: the shipped segmentor's forward on a 200 x 320^2 bf16 patch
   batch of a synthetic well, kernel path against plain path (mask IoU),
   with exactly 3 kernel launches;
5. plate: ``run_plate`` on a synthetic 1024^2, Z=8 uint8 plate with the
   shipped checkpoint and TTA 8, warmed on one plate, then timed twice;
6. focus_check: the focus-stacking kernel against its plain version for
   uint8 (equal), uint16 and float32 (near-tie rule), ragged depths,
   partial tiles and images smaller than the kernel's support;
7. focus_time: that kernel at uint8 (1, 8, 1024, 1024) and (8, 8, 1024,
   1024), at full depth (nothing uploaded) and with host ``z_counts``,
   beside its plain version, the conv2d (cuDNN) composition, an
   empty-sized launch and its bound on this card;
8. zproj: eight 8 x 1024^2 stacks through ``compute_zproj.project`` (all
   five methods) and the ``fs`` projections through
   ``compute_cell_area.analyze_images`` without and with well detection;
9. plate_fs: ``run_plate(proj_method="fs", detect_well=True)`` on those
   stacks with ragged depths, warmed once, timed once;
10. branches: ``compute_branches.analyze_branches`` with the shipped
   segmentor and the default branching config on the 2-D path (the ``max``
   projections of a new synthetic plate, and the ``fs`` projections of the
   focus plate with well detection) and on the 3-D Sato path (the focus
   plate's stacks), each warmed once and run twice; the kernel path's
   masks against the plain path's, the ``--no-vis`` statistics against
   the Morse graph's, and one stack's vesselness on the card against the
   CPU;
11. inv_depth: the shipped invasion ensemble (3 of 5 members ranked by
   history, 256^2 input, bf16) through ``compute_inv_depth.predict_rows`` on
   eight uint8 8 x 1024^2 stacks, warmed once and run twice (stacks/sec,
   then a stage split with the card synchronised at each stage's end), the
   seed-5 quality slices (not invaded, invaded), bf16 against f32 on the
   card, the card's f32 against the CPU's, the prep tail on the card
   against the CPU, and the ensemble forward timed with CUDA events beside
   its bound on this card;
12. cli: ``tmat_torch.cli.main(["compute_inv_depth", IN, OUT])`` on two of
   those stacks written as ND2 files; its CSV rows against
   ``predict_stack``'s; ``-h`` and an unknown subcommand;
13. profile: a ``max`` plate run (8 new wells) under
   ``core/profiling.py::maybe_profile``; the card's busy share over the
   run, from the kernels and copies in the trace, and the run's time
   without the profiler;
14. warmup: ``python -m tmat_torch.cli warmup`` in a fresh process on an
   empty build cache, then in a second fresh process: 5 libraries built,
   then 0, and the same outputs; both processes' wall times;
15. distributed: ``compute_inv_depth`` (the eight stacks of phase 11),
   ``compute_branches`` on eight 2-D images (``--no-vis``) and
   ``process_plate`` on eight wells, all as ND2 files, each by one process
   and by two on this card (``parallel/validation.py::
   run_coordinated_workers``): CSVs byte-equal, items per second of both,
   the host's cores and BLAS.

Phase 4 also holds the bf16 kernel path's mask against an f32 forward of
the plain path. The launch counts of phases 5, 8, 9, 10, 13 and 15 go into
the kernels line; phases 11 and 12 and the inv_depth runs of 15 launch
neither kernel. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tmat_torch.tools.timing import BLOCK_SHAPES, card_line, cuda_ms, stack_pool

# H100 SXM dense peaks and memory rate (NVIDIA data sheet): bf16 products on
# the tensor cores, f32 on the CUDA cores
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SHIPPED_CFG = "model_training/binary_segmentation/configs/unet_patch_segmentor_1.json"
# (B, H, C, F) of a block that only the kernel's general form takes (odd widths)
ODD_BLOCK = (3, 10, 5, 12)
TOL = {torch.float32: 2e-5}  # bf16: 2**-6 of the output's largest magnitude
# focus stacking, per pixel and slice: multiply-adds of the taps (blur 2 x 5,
# Laplacian 2 x (3 + 5)), two operations each, and the compare
FOCUS_FLOPS = 2 * (2 * 5 + 2 * (3 + 5)) + 1
# (dtype, (B, Z, H, W), z_counts, largest value) held against the plain version
FOCUS_CASES = [
    ("uint8", (1, 8, 1024, 1024), None, 255), ("uint8", (4, 8, 512, 512), (8, 5, 1, 3), 255),
    ("uint16", (1, 12, 1024, 1024), None, 4095), ("uint16", (1, 4, 40, 40), None, 65535),
    ("float32", (1, 5, 100, 150), None, 255), ("float32", (1, 3, 64, 64), None, 255),
    ("float32", (1, 8, 33, 257), None, 255), ("float32", (1, 3, 5, 5), None, 1),
    ("float32", (1, 3, 2, 3), None, 1),
]
PLATE_FS_Z_COUNTS = (8, 8, 6, 8, 5, 8, 8, 7)
INV_STACKS = 8  # uint8 (8, 1024, 1024) stacks of the inv_depth phase
INV_TOL = 0.02  # bf16 against f32 probabilities, and the margin around cls_thresh


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": time.perf_counter() - _START, **fields}), flush=True)


def block_work(b: int, h: int, c: int, f: int, dtype: torch.dtype) -> dict:
    """What one down-block call must do and move, and the least time the
    card could take for it. Products (pw1, pw2, the residual) run on the
    tensor cores in bf16; the depthwise taps and the pool are f32 work on
    the CUDA cores, side by side with them. Bytes: each input read once,
    the output written once."""
    hw, ho = h * h, (h // 2) ** 2
    products = (2 * hw * c * f + 2 * hw * f * f + 2 * ho * c * f) * b
    taps = (2 * 9 * hw * c + 2 * 9 * hw * f + 9 * ho * f) * b
    size = torch.finfo(dtype).bits // 8
    weights = (9 * c + c * f + 9 * f + f * f + c * f) * size + 3 * f * 4
    nbytes = (b * hw * c + b * ho * f) * size + weights
    if dtype == torch.bfloat16:
        ops_ms = max(products / PEAK_BF16_TC, taps / PEAK_F32) * 1e3
    else:
        ops_ms = (products + taps) / PEAK_F32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"flops": products + taps, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms)}


def phase_build():
    from tmat_torch import build

    from tmat_torch.ops import focus_stack

    jobs = {"down_block": lambda: build.cuda_library("down_block"),
            "focus_stack": focus_stack.library_path}
    for name in ("labeling", "dmtgraph", "morse"):
        jobs[name] = lambda n=name: build.host_library(n)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        paths = {name: str(f.result()) for name, f in futures.items()}
    seconds = time.perf_counter() - t0
    if build.builds != len(jobs):
        raise AssertionError(f"{build.builds} libraries built into an empty cache, not {len(jobs)}")
    ptxas = [ln.strip() for name in ("down_block", "focus_stack")
             for ln in build.logs.get(name, "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(seconds, 3), built=build.builds, libraries=paths, ptxas=ptxas)


def phase_kernel(rng, device):
    from tmat_torch.ops import down_block as db

    errors = []
    for b, h, c, f in [(8, *shape) for shape in BLOCK_SHAPES] + [ODD_BLOCK]:
        for dtype in (torch.float32, torch.bfloat16):
            x, blk = db.random_block(rng, b, h, c, f, dtype, device)
            for first in (True, False):
                out = db.down_block(x, blk, first)
                form = db.last_launch()[0]  # what was launched for these tensors
                ref = db.down_block_plain(x, blk, first)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL.get(dtype, 2.0 ** -6 * ref.float().abs().max().item())
                errors.append({"shape": [b, h, h, c, f], "dtype": str(dtype), "first": first,
                               "form": form, "max_abs_err": err, "tol": tol})
                if not (err <= tol and torch.isfinite(out.float()).all()):
                    raise AssertionError(f"down block kernel disagrees with its plain version: {errors[-1]}")
    forms = {(e["form"], e["dtype"]) for e in errors}
    if not {("wgmma", "torch.bfloat16"), ("wmma", "torch.bfloat16"), ("wmma", "torch.float32")} <= forms:
        raise AssertionError(f"a form of the down-block kernel was not held against the plain version: {forms}")
    if any(e["form"] != "wgmma" for e in errors
           if e["dtype"] == "torch.bfloat16" and tuple(e["shape"][2:]) in BLOCK_SHAPES):
        raise AssertionError("a production block was not launched in the warpgroup form")
    emit("kernel_check", cases=errors)

    timings = []
    for h, c, f in BLOCK_SHAPES:
        x, blk = db.random_block(rng, 200, h, c, f, torch.bfloat16, device)
        first = h == BLOCK_SHAPES[0][0]
        kernel_ms = cuda_ms(lambda: db.down_block(x, blk, first), 10)
        form, tile, staged = db.last_launch()  # of the launches that were timed
        plain_ms = cuda_ms(lambda: db.down_block_plain(x, blk, first), 10)
        timings.append({"shape": [200, h, h, c, f], "dtype": "bfloat16", "ms": kernel_ms,
                        "plain_ms": plain_ms, **block_work(200, h, c, f, torch.bfloat16),
                        "tile": [tile, staged], "form": form})
    emit("kernel_time", blocks=timings)
    return errors, timings


def synthetic_plate(n_wells: int, rng, size: int = 1024, n_z: int = 8) -> np.ndarray:
    """bench.py's vessel-like plate recipe (uint8)."""
    rr, cc = np.mgrid[0:size, 0:size]
    plate = rng.rand(n_wells, n_z, size, size).astype(np.float32) * 10
    for i in range(n_wells):
        ring = np.abs(np.sqrt((rr - size / 2) ** 2 + (cc - size / 2) ** 2) - (size / 3 + 10 * i)) < 4
        plate[i, n_z // 2][ring] += 180
        plate[i, n_z // 2, size // 2 - 2 : size // 2 + 2, 100:-100] += 150
    return np.clip(plate, 0, 255).astype(np.uint8)


def phase_unet(seg, well: np.ndarray, device):
    from tmat_torch.core import defs
    from tmat_torch.models.params_io import from_flax_variables, load_variables
    from tmat_torch.models.unet import UNetXception
    from tmat_torch.ops import down_block as db
    from tmat_torch.ops.rescale import rescale_intensity
    from tmat_torch.ops.resize import resize
    from tmat_torch.ops.tiled import tile_patches

    proj = torch.tensor(well.max(axis=0), device=device).float()
    small = rescale_intensity(resize(proj, (640, 640), "lanczos"))
    batch = tile_patches(small[..., None], seg.patch_size, 2, seg.tta)
    assert tuple(batch.shape) == (200, 320, 320, 1), batch.shape
    before = db.launches
    pred = seg.model(batch)
    torch.cuda.synchronize()
    launched = db.launches - before
    if launched != 3:
        raise AssertionError(f"the UNet forward launched the down-block kernel {launched} times, not 3")
    plain = seg.model(batch, plain_down=True)
    torch.cuda.synchronize()
    if not (torch.isfinite(pred).all() and pred.shape == (200, 320, 320, 1)):
        raise AssertionError("UNet forward: non-finite or misshapen output")
    mk, mp = pred > 0.5, plain > 0.5
    iou = (mk & mp).sum().item() / max((mk | mp).sum().item(), 1)
    if not (iou >= 0.99 and mp.sum().item() > 1000):
        raise AssertionError(f"kernel vs plain UNet mask IoU {iou} < 0.99 (or an empty mask)")
    kernel_ms = cuda_ms(lambda: seg.model(batch), 3)
    plain_ms = cuda_ms(lambda: seg.model(batch, plain_down=True), 3)
    # the bf16 kernel path against a float32 forward of the plain path (TF32 off)
    with open(Path(__file__).resolve().parent / SHIPPED_CFG) as f:
        cfg = json.load(f)
    ckpt = defs.model_training_path(f"binary_segmentation/checkpoints/{cfg['checkpoint_file']}")
    net32 = UNetXception(from_flax_variables(load_variables(ckpt), tuple(cfg["filter_counts"])),
                         torch.float32).to(device).eval()
    with torch.no_grad():
        pred32 = net32(batch, plain_down=True)
    m32 = pred32 > 0.5
    iou32 = (mk & m32).sum().item() / max((mk | m32).sum().item(), 1)
    diff32 = (pred.float() - pred32).abs().max().item()
    del net32, pred32
    torch.cuda.empty_cache()
    if not (iou32 >= 0.99 and m32.sum().item() > 1000):
        raise AssertionError(f"bf16 kernel path vs f32 UNet mask IoU {iou32} < 0.99 (or an empty mask)")
    emit("unet", batch=list(batch.shape), dtype=str(seg.dtype), launches=launched, mask_iou=iou,
         max_abs_diff=(pred - plain).abs().max().item(), foreground=mp.float().mean().item(),
         mask_iou_bf16_vs_f32=iou32, max_abs_diff_bf16_vs_f32=diff32,
         forward_ms=kernel_ms, plain_forward_ms=plain_ms)


def phase_plate(seg, n_wells: int, rng, device):
    from tmat_torch.ops import down_block as db
    from tmat_torch.tools.plate_pipeline import run_plate

    config = {"image_width_microns": 1200.0}
    forwards = [0]
    model_fn = seg._pred_fn

    def counted(batch):
        forwards[0] += 1
        return model_fn(batch)

    seg._pred_fn = counted
    warm = synthetic_plate(n_wells, rng)
    t0 = time.perf_counter()
    run_plate(warm, [f"warm{i}" for i in range(n_wells)], seg, config, device=device)
    warm_s = time.perf_counter() - t0
    plate = synthetic_plate(n_wells, rng)
    ids = [f"W{i}" for i in range(n_wells)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards[0] = 0
    db.launches = 0  # the main path's run starts here
    runs, timers = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res = run_plate(plate, ids, seg, config, device=device)
        runs.append((res, n_wells / (time.perf_counter() - t0)))
        timers.append(res.pop("_timer"))
    launches = db.launches  # ... and ends here
    seg._pred_fn = model_fn
    (r1, wps1), (r2, wps2) = runs
    print(timers[-1].report(), flush=True)
    if r1 != r2:
        raise AssertionError(f"two runs of the same plate differ:\n{r1}\n{r2}")
    if not all(0 < a < 100 and np.isfinite(a) for a in r1["area_pct"]):
        raise AssertionError(f"area_pct outside (0, 100): {r1['area_pct']}")
    if launches != 3 * forwards[0] or forwards[0] != 2 * n_wells:
        raise AssertionError(f"{launches} kernel launches for {forwards[0]} UNet forwards")
    emit("plate", wells=n_wells, size=[8, 1024, 1024], wells_per_sec=[wps1, wps2], warm_s=warm_s,
         unet_forwards=forwards[0], max_memory_allocated=torch.cuda.max_memory_allocated(),
         stage_totals_s=timers[-1].totals, results=r1)
    return launches


def focus_work(z_counts, h: int, w: int, itemsize: int) -> dict:
    """What one focus-stacking call must do and move: each stack's first
    ``z_count`` slices read once and one projection written, each in its
    own type; FOCUS_FLOPS float32 operations per pixel and slice read. The
    halo (a 40 x 128 tile read for a 32 x 120 output) is stated apart: it is
    read again, mostly from L2, and is no part of the bound."""
    slices, stacks = int(np.sum(z_counts)), len(z_counts)
    nbytes = (slices + stacks) * h * w * itemsize + 4 * stacks
    flops = slices * h * w * FOCUS_FLOPS
    ops_ms, bytes_ms = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "halo_bytes": int(slices * h * w * itemsize * (40 * 128 / (32 * 120) - 1)),
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_focus_check(rng, device):
    from tmat_torch.ops import focus_stack as fs

    cases = []
    for dtype, shape, z_counts, top in FOCUS_CASES:
        stacks = torch.from_numpy((rng.rand(*shape) * top).astype(dtype)).to(device)
        out = fs.focus_stack(stacks, z_counts)
        torch.cuda.synchronize()
        n_diff, far, err = fs.compare_with_plain(out, stacks, z_counts)
        cases.append({"dtype": dtype, "shape": list(shape), "z_counts": z_counts,
                      "mismatched_pixels": n_diff, "not_near_ties": far, "max_abs_err": err})
        # uint8: equal. Others: at most 1e-4 of the pixels, each a near-tie
        allowed = 0 if dtype == "uint8" else 1e-4 * out.numel()
        if far or n_diff > allowed or out.dtype != stacks.dtype:
            raise AssertionError(f"focus kernel disagrees with its plain version: {cases[-1]}")
        # depths as an int32 tensor on the card (taken as it is) give the same projection
        zc_dev = torch.tensor(z_counts or [shape[1]] * shape[0], dtype=torch.int32, device=device)
        if not torch.equal(fs.focus_stack(stacks, zc_dev).cpu(), out.cpu()):
            raise AssertionError(f"focus kernel: device z_counts change the projection: {cases[-1]}")
    emit("focus_check", cases=cases)
    return cases


def phase_focus_time(rng, device):
    from tmat_torch.ops import focus_stack as fs
    from tmat_torch.ops.zproj import focus_stack_conv

    timings = []
    for b in (1, 8):
        nxt = stack_pool(rng, b, device)  # each call reads device memory, not L2
        zc = [8] * b
        # 100 calls each: a call is short enough for one stall of the host to show in 20
        timings.append({
            "shape": [b, 8, 1024, 1024], "dtype": "uint8",
            # full depth, nothing uploaded: what ``project`` launches
            "ms": cuda_ms(lambda: fs.focus_stack(nxt()), 100),
            # host depths, checked and uploaded with every call: what a plate chunk launches
            "host_counts_ms": cuda_ms(lambda: fs.focus_stack(nxt(), zc), 100),
            "plain_ms": cuda_ms(lambda: fs.focus_stack_plain(nxt(), zc), 3),
            "conv_ms": cuda_ms(lambda: focus_stack_conv(nxt(), zc), 3),
            **focus_work(zc, 1024, 1024, 1),
        })
    tiny = torch.zeros((1, 1, 1, 1), dtype=torch.uint8, device=device)
    launch_ms = cuda_ms(lambda: fs.focus_stack(tiny), 200)
    emit("focus_time", shapes=timings, empty_launch_ms=launch_ms)
    return timings, launch_ms


def focus_plate(n_wells: int, rng, size: int = 1024, n_z: int = 8):
    """``synthetic_plate``'s wells for focus stacking and well detection:
    each well a bright disc on a dark frame, its ring and bar sharp in one
    slice (among the first five, so that ragged depths keep it) and
    Gaussian-blurred, more with the distance, in the others. Returns the
    uint8 (n_wells, n_z, size, size) plate, the sharp slice of each well
    and the ring masks."""
    from scipy import ndimage

    rr, cc = np.mgrid[0:size, 0:size]
    radius = np.sqrt((rr - size / 2) ** 2 + (cc - size / 2) ** 2)
    well = radius <= 0.48 * size
    plate = np.empty((n_wells, n_z, size, size), np.uint8)
    sharp, rings = [], []
    for i in range(n_wells):
        ring = np.abs(radius - (size / 3.5 + 10 * i)) < 1.5  # thin: a flat top has no Laplacian
        vessels = np.zeros((size, size), np.float32)
        vessels[ring] = 120
        vessels[size // 2 - 2 : size // 2 + 2, size // 4 : -size // 4] = 100
        z_sharp = i % 5
        for z in range(n_z):
            img = vessels if z == z_sharp else ndimage.gaussian_filter(vessels, 2.0 * abs(z - z_sharp))
            img = np.where(well, img + 100 + 5 * rng.rand(size, size).astype(np.float32),
                           2 * rng.rand(size, size).astype(np.float32))
            plate[i, z] = np.clip(img, 0, 255).astype(np.uint8)
        sharp.append(z_sharp)
        rings.append(ring)
    return plate, sharp, rings


def phase_zproj(plate, sharp, rings, device):
    from tmat_torch.ops import focus_stack as fs
    from tmat_torch.ops.zproj import PROJ_METHODS, proj_host
    from tmat_torch.tools import compute_cell_area as area_tool, compute_zproj as zproj_tool

    with open(Path(__file__).resolve().parent / "config" / "default_cell_area_computation.json") as f:
        cfg = json.load(f)

    def run():
        projs = {m: [zproj_tool.project(stack, m, device) for stack in plate] for m in PROJ_METHODS}
        small = [area_tool.downsample(p, cfg["dsamp_size"], device) for p in projs["fs"]]
        plain = area_tool.analyze_images(small, cfg["sd_coef"], False, cfg["rs_seed"], device)
        wells = area_tool.analyze_images(small, cfg["sd_coef"], True, cfg["rs_seed"], device)
        return projs, plain, wells

    fs.launches = 0  # the zproj and cell-area path starts here
    t0 = time.perf_counter()
    projs, plain, wells = run()
    first_s = time.perf_counter() - t0
    launches = fs.launches  # ... and ends here
    if launches != len(plate):
        raise AssertionError(f"{launches} focus kernel launches for {len(plate)} fs projections")

    ring_share = []
    for stack, proj, z, ring in zip(plate, projs["fs"], sharp, rings):
        if proj.dtype != np.uint8 or proj.shape != stack.shape[1:]:
            raise AssertionError(f"fs projection is {proj.dtype} {proj.shape}")
        ring_share.append(float((proj[ring] == stack[z][ring]).mean()))
    if min(ring_share) < 0.95:
        raise AssertionError(f"fs picked the sharp slice on {ring_share} of the ring pixels, under 0.95")
    for m in ("max", "min", "avg", "med"):
        for stack, proj in zip(plate, projs[m]):
            if not np.array_equal(proj, proj_host(stack, m)):
                raise AssertionError(f"{m} projection differs from the host projection")
    areas, well_areas = plain[2], wells[2]
    coverage = [float((wm > 0).mean()) for wm in wells[1]]
    if not all(0 < a < 1 for a in areas + well_areas):
        raise AssertionError(f"an area fraction outside (0, 1): {areas} {well_areas}")
    if min(coverage) < 0.4:
        raise AssertionError(f"a detected well mask covers under 40% of the frame: {coverage}")

    projs2, plain2, wells2 = run()
    same = (all(np.array_equal(a, b) for m in projs for a, b in zip(projs[m], projs2[m]))
            and plain2[2] == areas and wells2[2] == well_areas
            and all(np.array_equal(a, b) for a, b in zip(wells[1], wells2[1]))
            and all(np.array_equal(a, b) for a, b in zip(plain[0] + wells[0], plain2[0] + wells2[0])))
    if not same:
        raise AssertionError("two runs of the zproj and cell-area cores differ")

    t0 = time.perf_counter()
    for stack in plate:
        zproj_tool.project(stack, "fs", device)
    with_copy = len(plate) / (time.perf_counter() - t0)
    resident = [torch.from_numpy(stack).to(device) for stack in plate]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for stack in resident:
        PROJ_METHODS["fs"](stack)
    torch.cuda.synchronize()
    on_device = len(plate) / (time.perf_counter() - t0)
    emit("zproj", stacks=len(plate), size=list(plate.shape[1:]), fs_launches=launches, first_run_s=first_s,
         fs_stacks_per_sec_with_copy=with_copy, fs_stacks_per_sec_on_device=on_device,
         sharp_slice_share_on_ring=ring_share, area=areas, area_in_well=well_areas,
         well_mask_coverage=coverage)
    return launches


def phase_plate_fs(seg, plate, device):
    from tmat_torch.ops import down_block as db, focus_stack as fs
    from tmat_torch.tools.plate_pipeline import run_plate

    config = {"image_width_microns": 1200.0}
    n_wells = len(plate)
    z_counts = [PLATE_FS_Z_COUNTS[i % len(PLATE_FS_Z_COUNTS)] for i in range(n_wells)]
    plate = plate.copy()
    for i, z in enumerate(z_counts):
        plate[i, z:] = 0
    ids = [f"W{i}" for i in range(n_wells)]
    forwards = [0]
    model_fn = seg._pred_fn

    def counted(batch):
        forwards[0] += 1
        return model_fn(batch)

    seg._pred_fn = counted
    kw = dict(proj_method="fs", detect_well=True, z_counts=z_counts, device=device)
    t0 = time.perf_counter()
    warm = run_plate(plate, ids, seg, config, **kw)
    warm_s = time.perf_counter() - t0
    warm.pop("_timer")
    torch.cuda.synchronize()
    forwards[0] = 0
    db.launches = fs.launches = 0  # the fs plate's run starts here
    t0 = time.perf_counter()
    res = run_plate(plate, ids, seg, config, **kw)
    wps = n_wells / (time.perf_counter() - t0)
    launches = {"down_block": db.launches, "focus_stack": fs.launches}  # ... and ends here
    seg._pred_fn = model_fn
    timer = res.pop("_timer")
    print(timer.report(), flush=True)
    if res != warm:
        raise AssertionError(f"two runs of the same fs plate differ:\n{warm}\n{res}")
    if not all(0 < a < 100 and np.isfinite(a) for a in res["area_pct"]):
        raise AssertionError(f"area_pct outside (0, 100): {res['area_pct']}")
    # one well is one chunk: one focus launch each, three down blocks per forward
    if launches != {"down_block": 3 * forwards[0], "focus_stack": n_wells} or forwards[0] != n_wells:
        raise AssertionError(f"{launches} kernel launches for {forwards[0]} UNet forwards of {n_wells} wells")
    emit("plate_fs", wells=n_wells, size=list(plate.shape[1:]), z_counts=z_counts, wells_per_sec=wps,
         warm_s=warm_s, unet_forwards=forwards[0], launches=launches, stage_totals_s=timer.totals,
         results=res)
    return launches


def phase_branches(seg, max_projs, fs_projs, stacks, device):
    """The branches tool's core on both paths. Returns the down-block
    launches of its two counted runs."""
    from tmat_torch.core.profiling import StageTimer
    from tmat_torch.ops import down_block as db
    from tmat_torch.tools import compute_branches as cb

    with open(Path(__file__).resolve().parent / "config" / "default_branching_computation.json") as f:
        config = {**json.load(f), "image_width_microns": 1200.0}
    images = [(p, False) for p in max_projs] + [(p, True) for p in fs_projs]
    forwards = [0]
    model_fn = seg._pred_fn

    def counted(batch):
        forwards[0] += 1
        return model_fn(batch)

    def run_2d(cfg, timer=None, rates=None):
        out = []
        for kind in (False, True):  # the max projections, then the fs ones with -w
            t0 = time.perf_counter()
            out += [cb.analyze_branches(img, seg, cfg, well, device, timer)
                    for img, well in images if well == kind]
            if rates is not None:
                rates.append(sum(w == kind for _, w in images) / (time.perf_counter() - t0))
        return out

    def run_3d(cfg, timer=None):
        return [cb.analyze_branches(stack, None, cfg, False, device, timer) for stack in stacks]

    seg._pred_fn = counted
    try:
        t0 = time.perf_counter()
        run_2d(config)
        run_3d(config)
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        forwards[0] = 0
        db.launches = 0  # the branches path's run starts here
        runs_2d, runs_3d, timers = [], [], []
        for _ in range(2):
            timer, rates = StageTimer(), []
            runs_2d.append((run_2d(config, timer, rates), rates))
            t0 = time.perf_counter()
            runs_3d.append((run_3d(config, timer), len(stacks) / (time.perf_counter() - t0)))
            timers.append(timer)
        launches, n_forwards = db.launches, forwards[0]  # ... and ends here
    finally:
        seg._pred_fn = model_fn
    print(timers[-1].report(), flush=True)
    if launches != 3 * n_forwards or n_forwards != 2 * len(images):
        raise AssertionError(f"{launches} kernel launches for {n_forwards} UNet forwards of "
                             f"2 x {len(images)} images")
    rows_2d = [[r.rows for r in run] for run, _ in runs_2d]
    rows_3d = [[r.rows for r in run] for run, _ in runs_3d]
    if rows_2d[0] != rows_2d[1] or rows_3d[0] != rows_3d[1]:
        raise AssertionError(f"two runs of the branches tool differ:\n{rows_2d}\n{rows_3d}")
    for rows in rows_2d[0] + rows_3d[0]:
        (_, (n, total, _)), = rows
        if not (n >= 1 and total > 0 and np.isfinite(total)):
            raise AssertionError(f"no branch found: {rows}")
    coverage = [float((r.rasters["well_mask.png"] > 0).mean()) for r in runs_2d[0][0][len(max_projs):]]
    if not all(0.4 <= c < 1.0 for c in coverage):
        raise AssertionError(f"a detected well covers under 40% of the frame (or none was found): {coverage}")

    # the kernel's masks against the plain path's, on every image
    seg._pred_fn = lambda batch: seg.model(batch, plain_down=True)
    try:
        plain = run_2d(config)
    finally:
        seg._pred_fn = model_fn
    ious = []
    for k, p in zip(runs_2d[0][0], plain):
        mk, mp = k.rasters["prediction.png"] > 0.5, p.rasters["prediction.png"] > 0.5
        ious.append(float((mk & mp).sum() / max((mk | mp).sum(), 1)))
    if min(ious) < 0.99:
        raise AssertionError(f"kernel vs plain branches masks: IoU {ious} under 0.99")
    # the native Morse engine (--no-vis) gives the Morse graph's statistics
    no_vis = {**config, "save_vis": False}
    if [r.rows for r in run_2d(no_vis)] != rows_2d[0] or [r.rows for r in run_3d(no_vis)] != rows_3d[0]:
        raise AssertionError("--no-vis statistics differ from the Morse graph's")
    # one stack's vesselness on the card against the CPU, float32 on both sides
    dsamp = (cb.DOWNSAMPLE_WIDTH, cb.DOWNSAMPLE_WIDTH)
    card = cb._stack_vesselness(torch.from_numpy(stacks[0]).to(device), dsamp)[0].cpu()
    host = cb._stack_vesselness(torch.from_numpy(stacks[0]), dsamp)[0]
    vessels_err = (card - host).abs().max().item()
    if not vessels_err <= 1e-4:
        raise AssertionError(f"vesselness on the card differs from the CPU's by {vessels_err}")
    emit("branches", images_2d=len(images), size_2d=list(max_projs[0].shape), stacks_3d=len(stacks),
         size_3d=list(stacks[0].shape), wells_per_sec_2d_max=[r[0] for _, r in runs_2d],
         wells_per_sec_2d_fs_w=[r[1] for _, r in runs_2d],
         stacks_per_sec_3d=[s for _, s in runs_3d], warm_s=warm_s, unet_forwards=n_forwards,
         launches=launches, mask_iou=ious, well_mask_coverage=coverage,
         vessels_max_abs_err=vessels_err, stage_totals_s=timers[-1].totals,
         stage_counts=timers[-1].counts, rows_2d=rows_2d[0], rows_3d=rows_3d[0])
    return launches


def invasion_stacks(n_stacks: int, n_z: int = 8, size: int = 1024, seed: int = 0) -> np.ndarray:
    """uint8 (n_stacks, n_z, size, size) invasion stacks: ``n_z`` distinct
    ``synth_invasion_image`` slices (not invaded, invaded, in turn), made in
    threads; stack i holds them rolled by i along Z and shifted by (37 i,
    53 i) pixels, so that no two stacks are equal."""
    from tmat_torch.models.synthetic import synth_invasion_image

    def one(z):
        return synth_invasion_image(np.random.RandomState(seed + z), size, invaded=bool(z % 2))

    with ThreadPoolExecutor(n_z) as pool:
        slices = np.stack(list(pool.map(one, range(n_z))))
    return np.stack([np.roll(np.roll(slices, i, axis=0), (37 * i, 53 * i), axis=(1, 2))
                     for i in range(n_stacks)])


def ensemble_work(members, x: torch.Tensor) -> dict:
    """What one ensemble forward must do and move, and the least time the
    card could take for it: the convolutions' and the head's multiply-adds
    (two operations each), counted from the shapes of one forward, in bf16
    on the tensor cores; bytes: the input read once, each member's weights
    read once, the probabilities written once. Bias, relu, pool and the
    residual adds are left out of the operations."""
    from torch import nn

    per_member = [0]

    def count(mod, inputs, out):
        if isinstance(mod, nn.Conv2d):
            taps = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            per_member[0] += 2 * out.numel() * taps
        else:
            per_member[0] += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(count) for m in members[0].modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            out = members[0](x)
    finally:
        for h in hooks:
            h.remove()
    flops = per_member[0] * len(members)
    weights = sum(p.numel() * p.element_size() for m in members for p in m.parameters())
    nbytes = x.numel() * x.element_size() + weights + len(members) * out.numel() * 4
    ops_ms, bytes_ms = flops / PEAK_BF16_TC * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "flops_per_slice_per_member": per_member[0] / x.shape[0], "bytes": nbytes,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_inv_depth(device):
    """The invasion-depth tool's core on the shipped ensemble. Returns what
    the cli phase holds the CLI against."""
    from tmat_torch.core.profiling import StageTimer
    from tmat_torch.models.preprocess import host_resize, prep_tail
    from tmat_torch.models.resnet import ensemble_forward
    from tmat_torch.models.synthetic import synth_invasion_image
    from tmat_torch.ops import down_block as db, focus_stack as fs
    from tmat_torch.tools import compute_inv_depth as inv

    root = Path(__file__).resolve().parent
    with open(root / "model_training" / "invasion_depth_best_hp.json") as f:
        last_layer = json.load(f)["last_resnet_layer"]
    with open(root / "model_training" / "invasion_depth_training_values.json") as f:
        values = json.load(f)
    with open(root / "config" / inv.DEFAULT_CONFIG_NAME) as f:
        n_pred = json.load(f)["n_pred_models"]
    shape, thresh = tuple(values["resnet_inp_shape"]), values["cls_thresh"]
    hw = shape[:2]
    ens_dir = root / "model_training" / "best_ensemble"
    ranked = inv._rank_models_by_history(ens_dir, values["n_models"])[:n_pred]
    ckpts = [ens_dir / f"best_finetune_weights_{i}.msgpack" for i in ranked]
    t0 = time.perf_counter()
    ens = inv.load_ensemble(ckpts, shape, last_layer, device=device)
    load_s = time.perf_counter() - t0
    if len(ens) != 3 or ens[0].dtype != torch.bfloat16 or hw != (256, 256):
        raise AssertionError(f"unexpected ensemble: {len(ens)} members, {ens[0].dtype}, input {hw}")
    ens32 = inv.load_ensemble(ckpts, shape, last_layer, torch.float32, device)
    ens_cpu = inv.load_ensemble(ckpts, shape, last_layer, torch.float32, "cpu")

    # quality: the seed-5 slices of the tool's test, not invaded then invaded
    q_rng = np.random.RandomState(5)
    quality = np.stack([synth_invasion_image(q_rng, 256, invaded=False),
                        synth_invasion_image(q_rng, 256, invaded=True)])
    q_rows = inv.stack_rows("q", inv.predict_stack(quality, ens, hw), thresh)
    if [r[inv.PRED_COL] for r in q_rows] != [0, 1]:
        raise AssertionError(f"the seed-5 slices are not predicted [0, 1]: {q_rows}")

    t0 = time.perf_counter()
    stacks = invasion_stacks(INV_STACKS)
    synth_s = time.perf_counter() - t0
    items = [(f"S{i}", s) for i, s in enumerate(stacks)]
    launches_before = (db.launches, fs.launches)
    t0 = time.perf_counter()
    inv.predict_rows(items, ens, hw, thresh)
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        rows = inv.predict_rows(items, ens, hw, thresh)
        runs.append((rows, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    timer = StageTimer()
    timed_rows = inv.predict_rows(items, ens, hw, thresh, timer)
    if runs[0][0] != runs[1][0] or timed_rows != runs[0][0]:
        raise AssertionError("two runs of the inv_depth core differ")
    n_slices = sum(len(s) for s in stacks)
    if len(runs[0][0]) != n_slices:
        raise AssertionError(f"{len(runs[0][0])} rows for {n_slices} slices")

    # bf16 against f32 on the card on the tool's probabilities (the members'
    # mean; each member's is reported beside it); the card's f32 against the CPU's
    p16 = np.stack([inv.predict_stack(s, ens, hw) for s in stacks])
    p32 = np.stack([inv.predict_stack(s, ens32, hw) for s in stacks])
    m16, m32 = p16.mean(axis=1), p32.mean(axis=1)
    bf16_err, member_err = float(np.abs(m16 - m32).max()), float(np.abs(p16 - p32).max())
    far = np.abs(m32 - thresh) > INV_TOL
    if not bf16_err <= INV_TOL or not np.array_equal((m16 > thresh)[far], (m32 > thresh)[far]):
        raise AssertionError(f"bf16 vs f32 probabilities: max {bf16_err} (tol {INV_TOL}; members "
                             f"{member_err}), or a prediction away from the threshold differs")
    p_cpu = np.stack([inv.predict_stack(s, ens_cpu, hw) for s in stacks[:2]])
    cpu_err = float(np.abs(p32[:2] - p_cpu).max())
    if not cpu_err <= 1e-4:
        raise AssertionError(f"the card's f32 differs from the CPU's by {cpu_err}")
    resized = host_resize(stacks[0], hw)
    tail_err = (prep_tail(torch.from_numpy(resized).to(device)).cpu()
                - prep_tail(torch.from_numpy(resized))).abs().max().item()
    if not tail_err <= 1e-4:
        raise AssertionError(f"the prep tail on the card differs from the CPU's by {tail_err}")

    x = prep_tail(torch.from_numpy(resized).to(device))
    forward_ms = cuda_ms(lambda: ensemble_forward(ens, x), 20)
    work = ensemble_work(ens, x)
    if (db.launches, fs.launches) != launches_before:
        raise AssertionError("the inv_depth path launched a kernel of the plate path")
    wall = [t for _, t in runs]
    probs = [r[inv.PROB_COL] for r in runs[0][0]]
    emit("inv_depth", stacks=len(stacks), size=list(stacks.shape[1:]), members=len(ens),
         member_checkpoints=[c.name for c in ckpts], input=list(shape), dtype=str(ens[0].dtype),
         load_s=load_s, synth_s=synth_s, warm_s=warm_s,
         stacks_per_sec=[len(stacks) / t for t in wall], slices_per_sec=[n_slices / t for t in wall],
         stage_ms={k: timer.totals[k] / timer.counts[k] * 1e3 for k in timer.totals},
         forward_ms_per_stack=forward_ms, **{f"forward_{k}": v for k, v in work.items()},
         max_memory_allocated=peak, quality_rows=q_rows, bf16_vs_f32_max_abs=bf16_err,
         bf16_vs_f32_member_max_abs=member_err, predictions_near_threshold=int((~far).sum()),
         card_f32_vs_cpu_max_abs=cpu_err, prep_tail_card_vs_cpu_max_abs=tail_err,
         invaded_share=float(np.mean([r[inv.PRED_COL] for r in runs[0][0]])),
         prob_range=[min(probs), max(probs)])
    return stacks, ens, hw, thresh


def _nd2_chunk(name: bytes, payload: bytes) -> bytes:
    from tmat_torch.core.nd2 import CHUNK_MAGIC

    return struct.pack("<IIQ", CHUNK_MAGIC, len(name), len(payload)) + name + payload


def _lv_item(name: str, value) -> bytes:
    raw_name = (name + "\x00").encode("utf-16-le")
    head = lambda t: struct.pack("<BB", t, len(name) + 1) + raw_name  # noqa: E731
    if isinstance(value, int):
        return head(3) + struct.pack("<I", value)
    if isinstance(value, float):
        return head(6) + struct.pack("<d", value)
    if isinstance(value, str):
        return head(8) + value.encode("utf-16-le") + b"\x00\x00"
    payload = b"".join(_lv_item(k, v) for k, v in value.items())  # a dict
    return head(11) + struct.pack("<IQ", len(value), len(payload)) + payload


def write_nd2(path, stack: np.ndarray) -> None:
    """A (Z, Y, X) uint8/uint16 stack as an ND2 v3 file: the chunk layout
    ``tmat_torch/core/nd2.py`` reads (signature, image attributes,
    metadata, one data chunk per slice, the chunk map)."""
    from tmat_torch.core.nd2 import FILE_SIGNATURE_NAME, FILEMAP_SIGNATURE

    n_z, height, width = stack.shape
    attrs = {"SLxImageAttributes": {"uiWidth": width, "uiHeight": height, "uiComp": 1,
                                    "uiBpcInMemory": stack.dtype.itemsize * 8, "uiSequenceCount": n_z}}
    meta = {"SLxPictureMetadata": {"dCalibration": 0.65, "dZStep": 2.0, "sDescription": "synthetic"}}
    chunks = [(FILE_SIGNATURE_NAME, b"Ver3.0\x00"),
              (b"ImageAttributesLV!", b"".join(_lv_item(k, v) for k, v in attrs.items())),
              (b"ImageMetadataSeqLV|0!", b"".join(_lv_item(k, v) for k, v in meta.items()))]
    chunks += [(b"ImageDataSeq|%d!" % z, struct.pack("<d", 0.1 * z) + np.ascontiguousarray(stack[z]).tobytes())
               for z in range(n_z)]
    buf, offsets = bytearray(), {}
    for name, payload in chunks:
        offsets[name] = len(buf)
        buf += _nd2_chunk(name, payload)
    chunk_map = bytearray()
    for name, payload in chunks[1:]:  # the signature chunk is not mapped
        chunk_map += name + struct.pack("<QQ", offsets[name], len(payload))
    map_offset = len(buf)
    buf += _nd2_chunk(FILEMAP_SIGNATURE, bytes(chunk_map + FILEMAP_SIGNATURE))
    buf += FILEMAP_SIGNATURE + struct.pack("<Q", map_offset)
    with open(path, "wb") as fp:
        fp.write(bytes(buf))


def phase_cli(stacks, ens, hw, thresh, device):
    """``tmat-torch compute_inv_depth IN OUT`` on the card, against the core."""
    from tmat_torch import cli
    from tmat_torch.core import defs, io as tio
    from tmat_torch.tools import compute_inv_depth as inv

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        in_dir, out_dir, base = tmp / "in", tmp / "out", tmp / "base"
        in_dir.mkdir()
        for i in range(2):
            write_nd2(in_dir / f"S{i}.nd2", stacks[i])
            if not np.array_equal(tio.load_image(in_dir / f"S{i}.nd2")[0], stacks[i]):
                raise AssertionError("an ND2 stack does not read back as written")
        # a base dir of its own: the CLI configures it for this session only
        saved = (os.environ.get("TMAT_TPU_BASE_DIR"), defs.BASE_DIR, defs.SCRIPT_CONFIG_DIR,
                 defs.MODEL_TRAINING_DIR)
        os.environ["TMAT_TPU_BASE_DIR"] = str(base)
        defs.BASE_DIR, defs.SCRIPT_CONFIG_DIR, defs.MODEL_TRAINING_DIR = (
            base, base / "config", base / "model_training")
        try:
            t0 = time.perf_counter()
            code = cli.main(["compute_inv_depth", str(in_dir), str(out_dir)])
            cli_s = time.perf_counter() - t0
            help_code, unknown_code = cli.main(["-h"]), cli.main(["frobnicate"])
        finally:
            if saved[0] is None:
                os.environ.pop("TMAT_TPU_BASE_DIR", None)
            else:
                os.environ["TMAT_TPU_BASE_DIR"] = saved[0]
            defs.BASE_DIR, defs.SCRIPT_CONFIG_DIR, defs.MODEL_TRAINING_DIR = saved[1:]
        if (code, help_code, unknown_code) != (0, 0, 1):
            raise AssertionError(f"cli exit codes {code}, {help_code}, {unknown_code}; expected 0, 0, 1")
        with open(out_dir / "invasion_depth_predictions.csv") as f:
            rows = list(csv.DictReader(f))
    expected = [{k: str(v) for k, v in r.items()}
                for i in range(2) for r in inv.stack_rows(f"S{i}", inv.predict_stack(stacks[i], ens, hw), thresh)]
    if rows != expected:
        raise AssertionError(f"the CLI's rows differ from predict_stack's:\n{rows}\n{expected}")
    emit("cli", stacks=2, format="nd2", rows=len(rows), seconds=cli_s, exit_codes=[code, help_code, unknown_code])


def _child_env(**extra) -> dict:
    """This process's environment for a child process that imports this
    checkout's ``tmat_torch``."""
    root = str(Path(__file__).resolve().parent)
    env = {**os.environ, **{k: str(v) for k, v in extra.items()}}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _empty_base(path: Path) -> Path:
    """A base dir whose config and model dirs exist (so that the CLI does
    not configure one) and are empty (so that the shipped files are used)."""
    for sub in ("config", "model_training"):
        (path / sub).mkdir(parents=True, exist_ok=True)
    return path


def phase_warmup(tmp: Path):
    """``tmat-torch warmup`` in a fresh process on an empty build cache,
    then in a second fresh process: 5 libraries built, then none, and the
    same outputs."""
    import re

    env = _child_env(TMAT_TORCH_BUILD_DIR=tmp / "warm_build", TMAT_TPU_BASE_DIR=_empty_base(tmp / "warm_base"),
                     TMPDIR=tmp)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tmat_torch.cli", "warmup"], env=env,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"warmup exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        built = [int(v) for v in re.search(r"(\d+) of (\d+) native libraries built in ([\d.]+)s",
                                           proc.stdout).groups()[:2]]
        build_s = float(re.search(r"native libraries built in ([\d.]+)s", proc.stdout).group(1))
        tools = {name: (float(sec), digest) for name, sec, digest in
                 re.findall(r"(\w+) warmed in ([\d.]+)s \(outputs sha256 (\w+)\)", proc.stdout)}
        runs.append({"seconds": seconds, "built": built, "build_s": build_s, "tools": tools})
    (first, second) = runs
    if first["built"] != [5, 5] or second["built"] != [0, 5]:
        raise AssertionError(f"warmup built {first['built']} then {second['built']} libraries, not [5, 5], [0, 5]")
    if set(first["tools"]) != {"zproj", "area", "branches", "inv_depth", "plate"}:
        raise AssertionError(f"warmup ran {sorted(first['tools'])}")
    digests = [{k: d for k, (_, d) in run["tools"].items()} for run in runs]
    if digests[0] != digests[1]:
        raise AssertionError(f"the two warmup processes wrote different outputs: {digests}")
    emit("warmup", process_seconds=[r["seconds"] for r in runs], build_seconds=[r["build_s"] for r in runs],
         libraries_built=[r["built"][0] for r in runs], libraries=first["built"][1],
         tool_seconds=[{k: v for k, (v, _) in r["tools"].items()} for r in runs],
         outputs_equal=True, output_sha256=digests[0])


# One process of a striped tool run: the tool once on the two warm-up items
# (each process its share), then timed on them again, then timed on all the
# items with this process's kernel launches counted from zero; a barrier
# after each. The difference of the two timed runs is the items' own cost,
# without the tool's fixed cost (model load, listing, ...).
_DIST_WORKER = """
import json, sys, time
from tmat_torch.parallel import distributed as d
d.maybe_initialize_from_env()
from tmat_torch.ops import down_block as db, focus_stack as fs
from tmat_torch.tools import {module} as t
warm, small, run = (json.loads(a) for a in sys.argv[1:4])
t.main(argv=warm)
d.sync_processes("warm")
t0 = time.perf_counter()
t.main(argv=small)
d.sync_processes("small")
small_s = time.perf_counter() - t0
db.launches = fs.launches = 0
t0 = time.perf_counter()
t.main(argv=run)
d.sync_processes("run")
seconds = time.perf_counter() - t0
print("DIST_RESULT " + json.dumps({{"seconds": seconds, "small_seconds": small_s, "down_block": db.launches,
                                    "focus_stack": fs.launches}}))
"""


def phase_distributed(inv_stacks, plate, images, tmp: Path):
    """inv_depth (stacks), branches (2-D images) and the plate (wells),
    each by one process and by two on the one card, through
    ``run_coordinated_workers``: the CSVs byte-equal, the rates of both."""
    from tmat_torch.parallel.validation import run_with_retry

    def write_items(directory: Path, arrays, names):
        directory.mkdir(parents=True)
        for a, name in zip(arrays, names):
            write_nd2(directory / f"{name}.nd2", a if a.ndim == 3 else a[None])
        warm = directory.with_name(directory.name + "_warm")
        warm.mkdir()
        for name in names[:2]:
            os.link(directory / f"{name}.nd2", warm / f"{name}.nd2")
        return directory, warm

    width = ["--image-width-microns", "1200"]
    cases = {
        "inv_depth": ("compute_inv_depth", write_items(tmp / "d_inv", inv_stacks,
                                                       [f"S{i}" for i in range(len(inv_stacks))]),
                      [], ["invasion_depth_predictions.csv"]),
        "branches_2d": ("compute_branches", write_items(tmp / "d_branches", images,
                                                        [f"I{i}" for i in range(len(images))]),
                        width + ["--no-vis"], ["branching_analysis.csv", "config.json"]),
        "plate": ("plate_pipeline", write_items(tmp / "d_plate", plate, [f"W{i}" for i in range(len(plate))]),
                  width, ["plate_results.csv"]),
    }
    env = {"TMAT_TPU_BASE_DIR": _empty_base(tmp / "d_base")}
    out = {"host_cores": os.cpu_count(), "host_cores_usable": len(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads(),
           "blas": {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")},
           "blas_config": _blas_config(), "inv_depth_host_resize": resize_spread()}
    launches = {}
    for name, (module, (in_dir, warm_dir), tail, csvs) in cases.items():
        n_items = len(list(in_dir.iterdir()))
        rates, marginal, csv_bytes, counts = {}, {}, {}, {}
        for n_proc in (1, 2):
            out_dir = tmp / f"d_{name}_out{n_proc}"
            argv = [json.dumps([str(warm_dir), str(tmp / f"d_{name}_{stage}{n_proc}"), *tail])
                    for stage in ("warm", "small")] + [json.dumps([str(in_dir), str(out_dir), *tail])]
            outs = run_with_retry(["-c", _DIST_WORKER.format(module=module), *argv], n_proc,
                                  extra_env=env, timeout=600)
            results = [json.loads(o.split("DIST_RESULT ", 1)[1].splitlines()[0]) for o in outs]
            rates[n_proc] = n_items / results[0]["seconds"]
            n_small = len(list(warm_dir.iterdir()))
            marginal[n_proc] = (n_items - n_small) / (results[0]["seconds"] - results[0]["small_seconds"])
            counts[n_proc] = {k: sum(r[k] for r in results) for k in ("down_block", "focus_stack")}
            csv_bytes[n_proc] = {c: (out_dir / c).read_bytes() for c in csvs}
        if csv_bytes[1] != csv_bytes[2]:
            raise AssertionError(f"{name}: the two-process CSVs differ from the one-process CSVs")
        out[name] = {"items": n_items, "per_sec_1": rates[1], "per_sec_2": rates[2],
                     "speedup": rates[2] / rates[1], "marginal_per_sec_1": marginal[1],
                     "marginal_per_sec_2": marginal[2], "marginal_speedup": marginal[2] / marginal[1],
                     "launches": counts, "csv_bytes_equal": True}
        launches[name] = counts
    if launches["inv_depth"] != {1: {"down_block": 0, "focus_stack": 0}, 2: {"down_block": 0, "focus_stack": 0}}:
        raise AssertionError(f"the inv_depth path launched a kernel: {launches['inv_depth']}")
    for name, n_items in (("branches_2d", len(images)), ("plate", len(plate))):
        for n_proc in (1, 2):
            if launches[name][n_proc]["down_block"] != 3 * n_items:
                raise AssertionError(f"{name} at {n_proc} processes: {launches[name][n_proc]} launches for "
                                     f"{n_items} UNet forwards")
    emit("distributed", **out)
    return {name: sum(c["down_block"] for c in counts.values()) for name, counts in launches.items()
            if name != "inv_depth"}


_RESIZE_CHILD = """
import time, numpy as np
from tmat_torch.models.preprocess import host_resize
x = np.random.RandomState(0).randint(0, 256, (8, 1024, 1024)).astype(np.uint8)
host_resize(x, (256, 256))
times = []
for _ in range(5):
    t0 = time.perf_counter()
    host_resize(x, (256, 256))
    times.append(time.perf_counter() - t0)
print("RESIZE_MS", min(times) * 1e3)
"""


def resize_spread() -> dict:
    """The inv_depth host resize of one uint8 (8, 1024, 1024) stack, best of
    five, in fresh processes: alone with numpy's default BLAS threads, alone
    with one BLAS thread, and two at once with the default threads."""

    def run(n: int, **env):
        procs = [subprocess.Popen([sys.executable, "-c", _RESIZE_CHILD], env=_child_env(**env),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(n)]
        outs = [p.communicate(timeout=300) for p in procs]
        if any(p.returncode for p in procs):
            raise AssertionError(f"a resize probe failed: {[err[-2000:] for _, err in outs]}")
        return [float(out.split("RESIZE_MS", 1)[1]) for out, _ in outs]

    return {"default_threads_ms": run(1)[0], "one_blas_thread_ms": run(1, OPENBLAS_NUM_THREADS=1)[0],
            "two_processes_default_threads_ms": run(2)}


def _blas_config() -> str:
    """numpy's BLAS, as its build configuration names it."""
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        np.show_config()
    return "; ".join(sorted({line.strip() for line in buf.getvalue().splitlines()
                             if "openblas configuration" in line}))


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def phase_profile(seg, n_wells: int, rng, device, tmp: Path):
    """One ``max`` plate run under ``maybe_profile``: the card's busy share
    over the whole run, from the trace that the profiler wrote."""
    from tmat_torch.core.profiling import PROFILE_DIR_ENV, maybe_profile
    from tmat_torch.ops import down_block as db
    from tmat_torch.tools.plate_pipeline import run_plate

    plate = synthetic_plate(n_wells, rng)
    ids = [f"P{i}" for i in range(n_wells)]
    config = {"image_width_microns": 1200.0}
    os.environ[PROFILE_DIR_ENV] = str(tmp / "profile")
    try:
        torch.cuda.synchronize()
        db.launches = 0  # the traced run starts here
        t0 = time.perf_counter()
        with maybe_profile("plate") as prof:
            if prof is None:
                raise AssertionError("maybe_profile did not trace with its variable set")
            t1 = time.perf_counter()
            res = run_plate(plate, ids, seg, config, device=device)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
        # with the profiler's start, stop and the trace's export
        traced_s = time.perf_counter() - t0
        launches = db.launches  # ... and ends here
    finally:
        os.environ.pop(PROFILE_DIR_ENV)
    res.pop("_timer")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run_plate(plate, ids, seg, config, device=device)
    untraced_s = time.perf_counter() - t0
    plain.pop("_timer")
    if plain != res:
        raise AssertionError("the traced plate run differs from the untraced one")
    traces = list((tmp / "profile" / "plate").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"maybe_profile wrote {traces}")
    with open(traces[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device_cats = {"kernel", "gpu_memcpy", "gpu_memset"}
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
    on_device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in device_cats]
    if not kernels:
        raise AssertionError("the trace holds no kernel of the card")
    # over the run by the host clock, and from the first to the last device event
    busy_us, kernel_us = _union_us(on_device), _union_us(kernels)
    device_span_us = max(b for _, b in on_device) - min(a for a, _ in on_device)
    if launches != 3 * n_wells:
        raise AssertionError(f"{launches} down-block launches for {n_wells} traced wells")
    emit("profile", wells=n_wells, run_s=run_s, untraced_s=untraced_s, with_profiler_s=traced_s,
         trace_bytes=traces[0].stat().st_size, kernels=len(kernels), device_busy_s=busy_us / 1e6,
         kernel_busy_s=kernel_us / 1e6, kernel_time_sum_s=sum(b - a for a, b in kernels) / 1e6,
         device_busy_share=busy_us / 1e6 / run_s, device_idle_share=1 - busy_us / 1e6 / run_s,
         kernel_busy_share=kernel_us / 1e6 / run_s, device_span_s=device_span_us / 1e6,
         device_busy_share_of_span=busy_us / device_span_us, launches=launches)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--wells", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = card_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # an empty build cache: every library is built from this checkout's sources
        os.environ["TMAT_TORCH_BUILD_DIR"] = str(Path(tmp) / "build")
        return run_phases(args, Path(tmp), device, kind, smi)


def run_phases(args, tmp: Path, device, kind: str, smi: str) -> int:
    from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg

    phase_build()
    rng = np.random.RandomState(args.seed)
    errors, timings = phase_kernel(rng, device)

    seg = get_unet_patch_segmentor_from_cfg(str(Path(__file__).resolve().parent / SHIPPED_CFG),
                                            device=device)
    if (seg.dtype, seg.tta, seg.patch_size) != (torch.bfloat16, 8, 320):
        raise AssertionError(f"unexpected segmentor {(seg.dtype, seg.tta, seg.patch_size)}")
    phase_unet(seg, synthetic_plate(1, rng)[0], device)
    launches = phase_plate(seg, args.wells, rng, device)
    focus_cases = phase_focus_check(rng, device)
    focus_timings, empty_launch_ms = phase_focus_time(rng, device)
    fs_plate, sharp, rings = focus_plate(args.wells, rng)
    zproj_launches = phase_zproj(fs_plate, sharp, rings, device)
    fs_launches = phase_plate_fs(seg, fs_plate, device)
    from tmat_torch.tools.compute_zproj import project

    branch_launches = phase_branches(
        seg, [well.max(axis=0) for well in synthetic_plate(args.wells, rng)],
        [project(stack, "fs", device) for stack in fs_plate], fs_plate, device)

    inv_stacks, ens, hw, thresh = phase_inv_depth(device)
    phase_cli(inv_stacks, ens, hw, thresh, device)
    del ens
    torch.cuda.empty_cache()

    profile_rng = np.random.RandomState(args.seed + 1)
    profile_launches = phase_profile(seg, args.wells, profile_rng, device, tmp)
    phase_warmup(tmp)
    dist_launches = phase_distributed(
        inv_stacks, synthetic_plate(args.wells, profile_rng),
        [well.max(axis=0) for well in synthetic_plate(args.wells, profile_rng)], tmp)

    one_stack = focus_timings[0]  # (1, 8, 1024, 1024): what both paths launch
    kernels = [{
        "name": "down_block",
        "route": "cuda",
        "source": "tmat_torch/csrc/down_block.cu",
        "replaces": "tmat_tpu/ops/pallas_unet.py:245",
        "launches": (launches + fs_launches["down_block"] + branch_launches + profile_launches
                     + sum(dist_launches.values())),
        "launches_by_path": {"plate": launches, "plate_fs": fs_launches["down_block"],
                             "branches": branch_launches, "profile": profile_launches,
                             "distributed_branches_2d": dist_launches["branches_2d"],
                             "distributed_plate": dist_launches["plate"]},
        "max_abs_err": max(e["max_abs_err"] for e in errors),
        # one UNet forward of 200 patches: the three production blocks
        "ms": sum(t["ms"] for t in timings),
        "plain_ms": sum(t["plain_ms"] for t in timings),
        "bound_ms": sum(t["bound_ms"] for t in timings),
        "bound_by": ("operations" if sum(t["ops_ms"] for t in timings) >= sum(t["bytes_ms"] for t in timings)
                     else "bytes"),
        "library_ms": None,
        "blocks": [{"shape": t["shape"], "ms": t["ms"], "bound_ms": t["bound_ms"], "form": t["form"],
                    "tile": t["tile"][0]} for t in timings],
    }, {
        "name": "focus_stack",
        "route": "cuda",
        "source": "tmat_torch/csrc/focus_stack.cu",
        "replaces": "tmat_tpu/ops/pallas_zproj.py:52",
        "launches": zproj_launches + fs_launches["focus_stack"],
        "launches_by_path": {"zproj": zproj_launches, "plate_fs": fs_launches["focus_stack"]},
        "max_abs_err": max(c["max_abs_err"] for c in focus_cases),
        "mismatched_pixels": sum(c["mismatched_pixels"] for c in focus_cases),
        # one uint8 (8, 1024, 1024) stack, as the tools and a plate chunk launch it
        "ms": one_stack["ms"],
        "host_counts_ms": one_stack["host_counts_ms"],
        "plain_ms": one_stack["plain_ms"],
        "conv_ms": one_stack["conv_ms"],
        "empty_launch_ms": empty_launch_ms,
        "bound_ms": one_stack["bound_ms"],
        "bound_by": one_stack["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
