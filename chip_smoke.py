"""Drive the PyTorch/CUDA port (tmat_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--wells 8] [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name, count and power limit (no CUDA device: exit 1);
2. build: the four CUDA kernels (the down block, focus stacking, the
   int8 conv, the latter also as its mma.sync form alone, which phase quant
   holds and times against the warpgroup form, and the Lanczos-4 resize of
   the inv_depth ingest) and the three host
   libraries, from the sources in this checkout, all compilers started
   together, into an empty build cache (``TMAT_TORCH_BUILD_DIR``, a
   temporary directory);
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
   one launch of the Lanczos-4 resize kernel a stack, then a stage split
   by the host clock: ``host_resize``, ``dispatch``, ``fetch_wait``; the
   stages do not synchronise, so the card's time comes from a trace, not
   from them), the resize kernel at that shape against its plain version
   on the card, timed (CUDA events) beside its bound, the plain version on
   the card and the host resize it replaced (``host_resize``) on this
   host, and the pageable upload of one stack, the
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
   empty build cache, then in a second fresh process: 7 libraries built,
   then 0, and the same outputs; both processes' wall times;
15. distributed: ``compute_inv_depth`` (the eight stacks of phase 11),
   ``compute_branches`` on eight 2-D images (``--no-vis``) and
   ``process_plate`` on eight wells, all as ND2 files, each by one process
   and by two on this card (``parallel/validation.py::
   run_coordinated_workers``): CSVs byte-equal, items per second of both,
   the host's cores and BLAS;
16. train: ``train_segmentation.main`` on 96 synthetic 320^2 pairs (3 epochs,
   every other flag at its default: filters 64-512, batch 16, f32), then
   its step alone on one batch (CUDA events), an epoch split into the
   host's augmented batches and the card's steps, and a save/load/step
   resume check; ``train_invasion.main`` on 48 256^2 slices a class (one
   member, one frozen and one fine-tune epoch, the shipped JSONs), the
   frozen and fine-tune steps alone, the frozen base byte-equal, the
   float16 member through ``compute_inv_depth``'s ensemble path; the
   registered segmentor (bf16) through ``eval_segmentation.evaluate`` on
   two 1024^2 images, its probability maps against the plain path (bf16
   and f32); one small UNet step on the card against the CPU;
17. quant: the int8 conv kernel against its plain version, bit-equal, at
   B=8 for the six up convs the mixed segmentor quantises, the entry conv
   and a 1x1/s2 residual, in every epilogue form and the two fused forms (a
   bfloat16 input requantised on load, alone and with the output
   requantised), the form each shape took (the six up convs the warpgroup
   form), and the six again in the mma.sync form (a library built with
   ``TMAT_INT8_MMA_SYNC_ONLY``); the six timed at B=200 as the fused forward
   launches them (CUDA events) beside their bound, the plain version,
   ``torch._int_mm`` over an unfolded input, the cuDNN bf16 conv they
   replace, and the mma.sync form after PyTorch's requantisation (the
   earlier, unfused path); the shipped
   segmentor with ``"quantize": true`` (scales from the shipped sidecar, no
   calibration) on phase 4's 200 patches: 6 int8 and 3 down-block launches
   a forward, probabilities equal to the unfused path's, its mask against
   the f32 plain forward (IoU >= 0.96), forward ms beside the unfused and
   the bf16 path's; a calibration on a copy of the checkpoint
   (scales within 1e-3 of the sidecar's, the sidecar rewritten, none the
   second time); ``run_plate`` of phase 5's wells with the quantized
   segmentor, beside the bf16 plate;
18. package: a bundle (``python -m tmat_torch.packaging``) running
   ``./tmat-torch compute_zproj IN OUT -m fs`` on a fresh build cache, its
   TIFFs byte-equal to the in-process tool's; a ``--standalone`` bundle
   running ``-m max`` with no python on ``PATH``; both bundles' bytes and
   seconds;
19. rng: JAX's threefry streams in the port (``core/prng.py``): SHA-256 of
   the well search's default draws for seed 0 and of the shipped
   segmentor's UNet kernels from seed 0 (drawn on the card) against
   digests that the CPU tests pin to the JAX package, the card's bits
   against the CPU's (draws, UNet and ResNet50 inits), and the ResNet50
   init on the card timed three times;
20. plate_parts (run right after phase 5, on its wells): the plate's
   building blocks of ``parallel/plate.py``. ``plate_zproj`` of all five
   methods, each equal to ``plate_zproj_masked`` at full depth, its ``fs``
   and ``proj_focus_stacking_batch`` (one focus launch each) equal to the
   focus kernel's plain version; ``plate_threshold`` equal to the threshold
   formula (rescale, GMM threshold of unweighted pixels, > 0) and its well
   means to ``plate_stage1``'s areas; ``plate_segment`` of the resized wells
   equal to ``plate_stage1``'s predictions, 3 down-block launches a
   forward, and against the plain path at mask IoU >= 0.99 and max abs diff
   <= 0.02; ``edt``,
   ``median_filter_batch`` and ``packbits_device`` against their batched
   or inverse forms; each block timed (CUDA events) and the three in a row
   in wells/sec beside phase 5's.

Phase 4 also holds the bf16 kernel path's mask against an f32 forward of
the plain path. The launch counts of phases 5, 8, 9, 10, 13, 15 and 20 go into
the kernels line, and so do the trained segmentor's of phase 16 and the
quantized segmentor's of phase 17 (whose int8 launches are the int8
conv's); phases 11 and 12, the inv_depth runs of 15 and the training steps
launch neither kernel (the JAX package trains through plain Flax layers,
with no custom gradient); the kernels line counts the resize kernel's
launches of phases 11, 12 and 16 (one a stack; phase 11's timing apart).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import csv
import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from tmat_torch.tools.timing import (BLOCK_SHAPES, INT8_UP_SHAPES, card_line, cuda_ms, int8_up_call,
                                     int8_up_inputs, stack_pool)

# H100 SXM dense peaks and memory rate (NVIDIA data sheet): bf16 products on
# the tensor cores, f32 on the CUDA cores
PEAK_BF16_TC = 989e12
PEAK_INT8_TC = 1979e12
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
# plate_segment's bf16 probabilities, kernel against plain down blocks
# (0.0054 and 0.0061 measured on an H100 at 700 W)
PLATE_SEGMENT_ATOL = 0.02
TRAIN_SEG_PAIRS = 96  # 320^2 synthetic image/mask pairs of the train phase
TRAIN_INV_PER_CLASS = 48  # 256^2 synthetic slices per class
TRAIN_EVAL_SIZE = 1024  # the trained segmentor's two synthetic images
# the trained segmentor's probability maps: the bf16 kernel path against the
# bf16 plain path, and against the float32 plain path
TRAIN_PROB_TOL = {"kernel_vs_plain": 0.02, "bf16_vs_f32": 0.05}


# SHA-256 of JAX's draws for seed 0, held to the JAX package by
# tests/test_torch_prng.py::test_chip_smoke_digests_are_jax_s (the card has
# no JAX): jax.random.uniform(PRNGKey(0), (25000, 6)) (the well search's
# candidates), and the kernels of the shipped segmentor's UNet (patch 320,
# filters 64-512) from model.init(PRNGKey(0)), float32 in Flax tree order
RNG_DIGESTS = {
    "unit_draws_0": "8f6d985678d4bfe5e4db839112e2ed6347ed7e2d32237a1f56db7d17508f1bd9",
    "unet_kernels_0": "12ee9f588553ee61ed870fd3aa0e208c67de7d5b6f5b7ed88df1f52b323c098b",
}
RNG_UNET = dict(n_outputs=1, img_shape=(320, 320), channels=1, filter_counts=(64, 128, 256, 512))
RNG_RESNET = dict(n_outputs=1, img_shape=(256, 256, 3))  # the invasion trainer's ResNet50


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

    from tmat_torch.ops import focus_stack, int8_conv, resize_lanczos4

    # the int8 conv also as the mma.sync form alone: phase quant measures the
    # forms against each other
    jobs = {"down_block": lambda: build.cuda_library("down_block"),
            "focus_stack": focus_stack.library_path, "int8_conv": int8_conv.library_path,
            "int8_conv_mma_sync": lambda: int8_conv.library_path(("TMAT_INT8_MMA_SYNC_ONLY",)),
            "resize_lanczos4": resize_lanczos4.library_path}
    for name in ("labeling", "dmtgraph", "morse"):
        jobs[name] = lambda n=name: build.host_library(n)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        paths = {name: str(f.result()) for name, f in futures.items()}
    seconds = time.perf_counter() - t0
    if build.builds != len(jobs):
        raise AssertionError(f"{build.builds} libraries built into an empty cache, not {len(jobs)}")
    ptxas = [ln.strip() for name in ("down_block", "focus_stack", "int8_conv", "resize_lanczos4")
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
    return {"batch": batch, "mask32": m32, "forward_ms": kernel_ms}


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
    return {"launches": launches, "plate": plate, "ids": ids, "results": r1, "wells_per_sec": [wps1, wps2]}


def phase_plate_parts(seg, plate_run, device, smi: str):
    """The plate's building blocks (``parallel/plate.py``) on phase plate's
    wells, and ``plate_stage1`` beside them. Returns the launches of the run
    that drives them."""
    from tmat_torch.ops import down_block as db, focus_stack as fs
    from tmat_torch.ops.distance import edt, edt_batch
    from tmat_torch.ops.rescale import rescale_intensity
    from tmat_torch.ops.resize import resize
    from tmat_torch.ops.threshold import exec_threshold
    from tmat_torch.ops.zproj import PROJ_METHODS, proj_focus_stacking_batch
    from tmat_torch.parallel import plate as P
    from tmat_torch.topo.transforms import median_filter_batch, median_filter_disk2_batch

    plate, n_wells, sd_coef = plate_run["plate"], len(plate_run["plate"]), 0.0  # run_plate's sd_coef
    stacks = torch.from_numpy(plate).to(device)
    target = tuple(int(v) for v in np.round(np.multiply(plate.shape[-2:], seg.ds_ratio)))
    forwards = [0]

    def counted(batch):
        forwards[0] += 1
        return seg._pred_fn(batch)

    def segment_input(proj):
        return rescale_intensity(resize(proj.float(), target, "lanczos"), dims=(-2, -1))

    torch.cuda.synchronize()
    db.launches = fs.launches = 0  # the building blocks' run starts here
    projs = {m: P.plate_zproj(stacks, m, device) for m in PROJ_METHODS}
    fs_batch = proj_focus_stacking_batch(stacks)
    thresh = P.plate_threshold(projs["max"], sd_coef, device=device)
    preds = P.plate_segment(segment_input(projs["max"]), counted, seg.patch_size, 2, seg.tta, device)
    area, stage1_preds, f_pk, _ = P.plate_stage1(stacks, counted, seg.patch_size, 2, target, sd_coef,
                                                 tta=seg.tta)
    torch.cuda.synchronize()
    launches = {"down_block": db.launches, "focus_stack": fs.launches}  # ... and ends here
    if launches != {"down_block": 3 * forwards[0], "focus_stack": 2} or forwards[0] != 2 * n_wells:
        raise AssertionError(f"{launches} kernel launches for {forwards[0]} UNet forwards of {n_wells} wells")

    # depth 8: the whole-stack mean's 1/8 is exact, so it equals the masked mean bit for bit
    for m, proj in projs.items():
        if not torch.equal(proj.float(), P.plate_zproj_masked(stacks, None, m)):
            raise AssertionError(f"plate_zproj({m!r}) differs from plate_zproj_masked at full depth")
    plain = fs.focus_stack_plain(stacks)
    if not (projs["fs"].dtype == torch.uint8 and torch.equal(projs["fs"], plain)
            and torch.equal(fs_batch, plain)):
        raise AssertionError("plate_zproj('fs') or proj_focus_stacking_batch differs from the plain version")
    # the threshold as plate_stage1 computed it before it called plate_threshold
    formula = exec_threshold(rescale_intensity(projs["max"], dims=(-2, -1)), None, sd_coef) > 0
    if not (thresh.dtype == torch.uint8 and torch.equal(thresh.bool(), formula)):
        raise AssertionError(f"plate_threshold differs from the threshold formula at "
                             f"{(thresh.bool() != formula).sum().item()} pixels")
    well_means = thresh.float().mean(dim=(-2, -1))
    if not torch.equal(well_means, area):
        raise AssertionError(f"plate_threshold's well means {well_means.tolist()} differ from stage 1's "
                             f"areas {area.tolist()}")
    if not torch.equal(preds, stage1_preds):
        raise AssertionError("plate_segment differs from plate_stage1's predictions")
    plain_preds = P.plate_segment(segment_input(projs["max"]), lambda b: seg.model(b, plain_down=True),
                                  seg.patch_size, 2, seg.tta, device)
    mk, mp = preds > 0.5, plain_preds > 0.5
    iou = (mk & mp).sum().item() / max((mk | mp).sum().item(), 1)
    max_abs_diff = (preds - plain_preds).abs().max().item()
    if not (iou >= 0.99 and mp.sum().item() > 1000):
        raise AssertionError(f"plate_segment kernel vs plain mask IoU {iou} < 0.99 (or an empty mask)")
    if not max_abs_diff <= PLATE_SEGMENT_ATOL:
        raise AssertionError(f"plate_segment kernel vs plain max abs diff {max_abs_diff} > {PLATE_SEGMENT_ATOL}")
    seg_masks = preds > 0.5
    w = preds.shape[-1]
    mask = P.unpackbits(f_pk, w)[0]
    small_parts = {
        "edt": torch.equal(edt(mask), edt_batch(mask[None])[0]),
        "median_filter_batch": torch.equal(median_filter_batch(seg_masks.float()),
                                           median_filter_disk2_batch(seg_masks.float())),
        "packbits_device": torch.equal(P.unpackbits_device(P.packbits_device(seg_masks), w), seg_masks),
    }
    if not all(small_parts.values()) or not mask.any():
        raise AssertionError(f"a small part disagrees: {small_parts}")

    # each building block alone (CUDA events), then the three in a row (host clock)
    small = segment_input(projs["max"])
    ms = {"plate_zproj_max": cuda_ms(lambda: P.plate_zproj(stacks, "max", device), 10),
          "plate_zproj_fs": cuda_ms(lambda: P.plate_zproj(stacks, "fs", device), 10),
          "plate_threshold": cuda_ms(lambda: P.plate_threshold(projs["max"], sd_coef, device=device), 3),
          "plate_segment": cuda_ms(
              lambda: P.plate_segment(small, seg._pred_fn, seg.patch_size, 2, seg.tta, device), 2)}
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proj = P.plate_zproj(stacks, "max", device)
        P.plate_threshold(proj, sd_coef, device=device)
        P.plate_segment(segment_input(proj), seg._pred_fn, seg.patch_size, 2, seg.tta, device)
        torch.cuda.synchronize()
        rates.append(n_wells / (time.perf_counter() - t0))
    emit("plate_parts", wells=n_wells, size=list(plate.shape[1:]), launches=launches,
         unet_forwards=forwards[0], mask_iou_kernel_vs_plain=iou, max_abs_diff_kernel_vs_plain=max_abs_diff,
         area=area.tolist(), small_parts=small_parts, ms=ms, three_in_a_row_wells_per_sec=rates,
         plate_wells_per_sec=plate_run["wells_per_sec"], nvidia_smi=smi)
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


def resize_work(z: int, H: int, W: int, h: int, w: int, itemsize: int = 1) -> dict:
    """What one Lanczos-4 resize of a (z, H, W) stack to (z, h, w) must do
    and move, and the least time the card could take for it: the banded
    multiply-adds (two operations each, f32 on the CUDA cores) of the
    vertical pass over every input column and of the horizontal pass;
    bytes, the stack read once and the result written once."""
    from tmat_torch.ops.resize_lanczos4 import band

    taps = lambda n_in, n_out: int(band(n_in, n_out).count.sum())  # noqa: E731
    flops = 2 * z * (taps(H, h) * W + h * taps(W, w))
    nbytes = z * (H * W + h * w) * itemsize
    ops_ms, bytes_ms = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_inv_depth(device):
    """The invasion-depth tool's core on the shipped ensemble. Returns what
    the cli phase holds the CLI against."""
    from tmat_torch.core.profiling import StageTimer
    from tmat_torch.models.preprocess import host_resize, prep_tail
    from tmat_torch.models.resnet import ensemble_forward
    from tmat_torch.models.synthetic import synth_invasion_image
    from tmat_torch.ops import down_block as db, focus_stack as fs, resize_lanczos4 as rl
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

    resize_at_start = rl.launches
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
    resize_before = rl.launches
    for _ in range(2):
        t0 = time.perf_counter()
        rows = inv.predict_rows(items, ens, hw, thresh)
        runs.append((rows, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if rl.launches - resize_before != 2 * len(stacks):
        raise AssertionError(f"{rl.launches - resize_before} resize launches for {2 * len(stacks)} stacks")
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

    # the resize kernel at the cell's shape: against its plain version on the
    # card, then timed over a pool of stacks larger than L2, beside its bound,
    # the plain version, the host resize it replaced and the upload before it
    path_launches = rl.launches - resize_at_start
    raw = torch.from_numpy(stacks[0]).to(device)
    k_out = rl.resize_lanczos4(raw, hw).cpu().numpy().astype(np.int16)
    p_out = rl.resize_lanczos4_plain(raw, hw).cpu().numpy().astype(np.int16)
    resize_err = int(np.abs(k_out - p_out).max())
    resize_mismatched = int((k_out != p_out).sum())
    if resize_err > 1 or resize_mismatched > 1e-4 * k_out.size:
        raise AssertionError(f"the resize kernel differs from its plain version by up to {resize_err} "
                             f"at {resize_mismatched} of {k_out.size} pixels")
    pool = stack_pool(np.random.RandomState(3), 1, device)
    resize_ms = cuda_ms(lambda: rl.resize_lanczos4(pool()[0], hw), 50)
    resize_plain_ms = cuda_ms(lambda: rl.resize_lanczos4_plain(pool()[0], hw), 10)
    host_times, upload_times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        host_resize(stacks[0], hw)
        host_times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(stacks[1]).to(device)
        upload_times.append((time.perf_counter() - t0) * 1e3)
    resize = {"shape": list(stacks.shape[1:]), "out": list(hw), "path_launches": path_launches, "ms": resize_ms,
              "plain_ms": resize_plain_ms, "host_resize_ms": min(host_times),
              "upload_ms": min(upload_times), "max_abs_err": resize_err,
              "mismatched_pixels": resize_mismatched, "plan": list(rl.plan(*stacks.shape[2:], *hw)),
              **resize_work(*stacks.shape[1:], *hw)}
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
         card_f32_vs_cpu_max_abs=cpu_err, prep_tail_card_vs_cpu_max_abs=tail_err, resize=resize,
         invaded_share=float(np.mean([r[inv.PRED_COL] for r in runs[0][0]])),
         prob_range=[min(probs), max(probs)])
    return stacks, ens, hw, thresh, resize


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
    then in a second fresh process: 7 libraries built, then none, and the
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
    if first["built"] != [7, 7] or second["built"] != [0, 7]:
        raise AssertionError(f"warmup built {first['built']} then {second['built']} libraries, not [7, 7], [0, 7]")
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
           "blas_config": _blas_config()}
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


@contextmanager
def tf32(conv: bool, matmul: bool):
    """cuDNN's and cuBLAS's TF32 flags for a block, restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def assert_grads(port: dict, ref: dict, what: str) -> float:
    """Each leaf's gradient within 1e-4 of its largest |g|, floored at 1e-2
    of the model's largest (a bias in front of a BatchNorm has only rounding
    noise); returns the worst error in those units."""
    gmax = max(g.abs().max().item() for g in ref.values())
    worst = 0.0
    for k, g in ref.items():
        err = (port[k].cpu() - g.cpu()).abs().max().item()
        worst = max(worst, err / (1e-4 * max(g.abs().max().item(), 1e-2 * gmax)))
    if worst > 1:
        raise AssertionError(f"{what}: a gradient differs by {worst} of its tolerance")
    return worst


def _train_segmentation(tmp: Path, device) -> tuple:
    """The segmentation trainer at its defaults, then its step alone, an
    epoch split into host and card, and resume. Returns (config, fields)."""
    from tmat_torch.models import train as T, train_segmentation as TS
    from tmat_torch.models.synthetic import generate_dataset
    from tmat_torch.models.unet import build_unet_xception

    seg_dir = tmp / "train_seg"
    t0 = time.perf_counter()
    generate_dataset(seg_dir, n=TRAIN_SEG_PAIRS, size=320, seed=0)
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg_path = TS.main([str(seg_dir), "--epochs", "3", "--warmup-steps", "4"], device=device)
    main_s, main_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    # the step alone on one fixed batch on the card, warmed
    args = TS.parse_args([str(seg_dir)])
    train_seq, _ = TS.make_sequences(args, np.random.RandomState(args.seed))
    module = build_unet_xception(1, (args.patch_size, args.patch_size), filter_counts=tuple(args.filters),
                                 bn_momentum=args.bn_momentum, device=device)
    tx = T.adamw(TS.make_schedule(args, len(train_seq)))
    state, step = T.init_train_state(module, tx), T.make_unet_train_step(tx)
    batch = [torch.from_numpy(a).to(device) for a in train_seq[0]]
    for _ in range(3):
        step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, *batch), 10)
    step_peak = torch.cuda.max_memory_allocated()
    # one epoch: the host's augmented batches against the card's steps
    host_s = card_s = 0.0
    for i in range(len(train_seq)):
        t0 = time.perf_counter()
        b = train_seq[i]
        t1 = time.perf_counter()
        _, metrics = step(state, *b)
        torch.cuda.synchronize()
        host_s, card_s = host_s + t1 - t0, card_s + time.perf_counter() - t1

    # resume: byte-equal tensors and step; one further step from each
    path = tmp / "train_state.msgpack"
    T.save_train_state(path, state)
    restored = T.load_train_state(path, T.init_train_state(build_unet_xception(
        1, (args.patch_size, args.patch_size), filter_counts=tuple(args.filters),
        bn_momentum=args.bn_momentum, seed=1, device=device), tx))
    pairs = list(zip(state.module.state_dict().values(), restored.module.state_dict().values()))
    for pa, pb in zip(state.module.parameters(), restored.module.parameters()):
        pairs += [(state.opt.state[pa][k], restored.opt.state[pb][k]) for k in ("exp_avg", "exp_avg_sq", "step")]
    if restored.step != state.step or not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("a resumed train state differs from the saved one")
    _, ma = step(state, *batch)
    _, mb = step(restored, *batch)
    loss_a, loss_b = ma["loss"].item(), mb["loss"].item()
    lr = max(tx.lr(i) for i in range(state.step))
    param_diff = max((a - b).abs().max().item() for a, b in zip(state.module.parameters(),
                                                                restored.module.parameters()))
    if not (abs(loss_a - loss_b) <= 1e-6 * loss_a and param_diff <= 2 * lr):
        raise AssertionError(f"resumed step: losses {loss_a} / {loss_b}, weights {param_diff} apart "
                             f"(tol 2 x lr = {2 * lr})")
    n = args.batch_size
    return cfg_path, {
        "pairs": TRAIN_SEG_PAIRS, "patch": args.patch_size, "filters": args.filters, "batch": n,
        "epochs": 3, "steps_per_epoch": len(train_seq), "data_gen_s": data_s, "main_s": main_s,
        "main_peak_bytes": main_peak, "step_ms": step_ms, "images_per_sec": n / step_ms * 1e3,
        "step_peak_bytes": step_peak, "epoch_host_batches_s": host_s, "epoch_card_steps_s": card_s,
        "epoch_host_share": host_s / (host_s + card_s), "last_loss": metrics["loss"].item(),
        "resume": {"checkpoint_bytes": path.stat().st_size, "step": restored.step,
                   "loss_after": [loss_a, loss_b], "max_weight_diff_after": param_diff,
                   "tol": 2 * lr},
    }


def _trained_segmentor(cfg_path: Path, tmp: Path, device) -> dict:
    """The registered segmentor (bf16, down-block kernel) on two 1024^2
    images, through ``eval_segmentation.evaluate``; its probability maps
    against the plain path's, bf16 and float32 (TF32 off)."""
    from tmat_torch.core.io import load_image, save_image
    from tmat_torch.device import default_dtype
    from tmat_torch.models import eval_segmentation as ev
    from tmat_torch.models.synthetic import synth_vessel_image
    from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg
    from tmat_torch.ops import down_block as db

    eval_dir = tmp / "train_eval"
    eval_dir.mkdir()
    rng = np.random.RandomState(7)
    for i in range(2):  # the training contract: each image rescaled to [0, 1]
        img, mask = synth_vessel_image(rng, TRAIN_EVAL_SIZE)
        img = img.astype(np.float32)
        save_image(eval_dir / f"e{i}.tif", (img - img.min()) / max(img.max() - img.min(), 1))
        save_image(eval_dir / f"e{i}_mask.tif", mask)
    seg = get_unet_patch_segmentor_from_cfg(str(cfg_path), device=device)
    if seg.dtype != default_dtype(device):
        raise AssertionError(f"the trained segmentor computes in {seg.dtype}")
    forwards, model_fn, preds = [0], seg._pred_fn, {}

    def counted(b):
        forwards[0] += 1
        return model_fn(b)

    seg._pred_fn = counted
    paths = ev.image_paths(str(eval_dir))
    db.launches = 0  # the trained segmentor's path starts here
    ious = ev.evaluate(seg, paths, on_image=lambda fp, img, pred, th, m: preds.__setitem__(fp, pred))
    launches = db.launches  # ... and ends here
    if launches != seg.model.n_down * forwards[0] or not forwards[0]:  # 3 at full width
        raise AssertionError(f"{launches} kernel launches for {forwards[0]} UNet forwards")
    seg._pred_fn = lambda b: seg.model(b, plain_down=True)
    cfg = json.loads(cfg_path.read_text())
    cfg.update(dtype="float32", checkpoint_file=str(cfg_path.parents[1] / "checkpoints" / cfg["checkpoint_file"]))
    (tmp / "f32.json").write_text(json.dumps(cfg))
    seg32 = get_unet_patch_segmentor_from_cfg(str(tmp / "f32.json"), device=device)
    seg32._pred_fn = lambda b: seg32.model(b, plain_down=True)
    diffs = {"kernel_vs_plain": [], "bf16_vs_f32": []}
    with tf32(False, False):
        for fp in paths:
            img = load_image(fp)[0].astype(np.float32)
            pred = preds[fp]
            if not (np.isfinite(pred).all() and pred.shape == img.shape):
                raise AssertionError("the trained segmentor's map is non-finite or misshapen")
            diffs["kernel_vs_plain"].append(float(np.abs(pred - seg.predict(img)).max()))
            diffs["bf16_vs_f32"].append(float(np.abs(pred - seg32.predict(img)).max()))
    for k, tol in TRAIN_PROB_TOL.items():
        if max(diffs[k]) > tol:
            raise AssertionError(f"trained segmentor, {k}: probabilities {max(diffs[k])} apart (tol {tol})")
    return {"images": 2, "size": TRAIN_EVAL_SIZE, "dtype": str(seg.dtype), "unet_forwards": forwards[0],
            "launches": launches, "iou_at_0_5": ious, "prob_max_abs_diff": diffs, "tol": TRAIN_PROB_TOL,
            "prob_range": [float(min(p.min() for p in preds.values())),
                           float(max(p.max() for p in preds.values()))]}


def _card_vs_cpu_step(device) -> dict:
    """One UNet step (filters 8-16, 64^2, batch 4) from the same weights and
    batch on the card and the CPU, TF32 off: loss and BN statistics card
    against CPU; the gradients of both against the same step in float64 on
    the CPU (a bias in front of a BatchNorm has a true gradient of 0, so
    its float32 value is rounding noise of either side)."""
    from tmat_torch.models import train as T
    from tmat_torch.models.layers import flax_variables, load_flax_variables
    from tmat_torch.models.synthetic import synth_vessel_image
    from tmat_torch.models.unet import build_unet_xception

    rng = np.random.RandomState(3)
    pairs = [synth_vessel_image(rng, 64) for _ in range(4)]
    x = np.stack([(i - i.min()) / max(float(i.max() - i.min()), 1.0) for i, _ in pairs])[..., None]
    y = np.stack([m > 0 for _, m in pairs])[..., None].astype(np.float32)
    nets = {"cpu": build_unet_xception(1, (64, 64), filter_counts=(8, 16), bn_momentum=0.9, seed=3,
                                       device="cpu")}
    nets["card"] = load_flax_variables(build_unet_xception(1, (64, 64), filter_counts=(8, 16),
                                                           bn_momentum=0.9, device=device),
                                       flax_variables(nets["cpu"]))
    nets["cpu_f64"] = copy.deepcopy(nets["cpu"]).double()
    out = {}
    with tf32(False, False):
        for where, net in nets.items():
            tx = T.adamw(1e-3)
            _, m = T.make_unet_train_step(tx)(T.init_train_state(net, tx), x.astype(np.float32), y)
            out[where] = (m["loss"].item(), {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
                          flax_variables(net)["batch_stats"])
    (loss_cpu, g_cpu, s_cpu), (loss_card, g_card, s_card) = out["cpu"], out["card"]
    g_f64 = out["cpu_f64"][1]
    if abs(loss_card - loss_cpu) > 1e-5 * loss_cpu:
        raise AssertionError(f"card vs CPU step: losses {loss_card} / {loss_cpu}")
    stats_diff = max(float(np.abs(s_card[k][leaf] - s_cpu[k][leaf]).max()) for k in s_cpu for leaf in s_cpu[k])
    if stats_diff > 1e-6:
        raise AssertionError(f"card vs CPU step: BN statistics {stats_diff} apart")
    worst = assert_grads(g_card, g_f64, "card vs float64 step")
    return {"loss": [loss_card, loss_cpu], "bn_stats_max_abs_diff": stats_diff,
            "grad_err_of_tol": worst, "cpu_grad_err_of_tol": assert_grads(g_cpu, g_f64, "CPU vs float64 step")}


def _train_invasion(tmp: Path, device) -> dict:
    """The invasion trainer from the shipped JSONs (one member, one frozen
    and one fine-tune epoch), the frozen and fine-tune steps alone, the
    frozen base byte-equal, and the written member through the tool's path."""
    from glob import glob

    from tmat_torch.models import train as T, train_invasion
    from tmat_torch.models.augment import augment_invasion_imgs
    from tmat_torch.models.data import InvasionDataGenerator
    from tmat_torch.models.resnet import build_trainable_resnet50_tl
    from tmat_torch.models.synthetic import generate_invasion_dataset
    from tmat_torch.tools import compute_inv_depth as inv

    root = Path(__file__).resolve().parent
    hp = json.loads((root / "model_training" / "invasion_depth_best_hp.json").read_text())
    tv = json.loads((root / "model_training" / "invasion_depth_training_values.json").read_text())
    inv_dir = tmp / "train_inv"
    t0 = time.perf_counter()
    generate_invasion_dataset(inv_dir, n_per_class=TRAIN_INV_PER_CLASS, size=256, seed=0)
    data_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_dir = train_invasion.main([str(inv_dir), "--n-models", "1", "--frozen-epochs", "1",
                                   "--fine-tune-epochs", "1"], device=device)
    main_s, main_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    hw = tuple(tv["resnet_inp_shape"][:2])
    paths = {label: sorted(glob(str(inv_dir / name / "*"))) for name, label in tv["class_labels"].items()}
    gen = InvasionDataGenerator(paths, tv["class_labels"], tv["batch_size"], hw, np.random.RandomState(0),
                                class_weights=True, augmentation_function=augment_invasion_imgs,
                                device=device)
    module = build_trainable_resnet50_tl(1, (*hw, 3), hp["last_resnet_layer"], seed=0, device=device)
    base0 = {k: t.clone() for k, t in module.state_dict().items() if k.startswith("base_model.")}
    frozen_tx = T.make_tl_optimizer(hp["frozen_lr"], hp["adam_beta_1"], hp["adam_beta_2"], False)
    state, fstep = T.init_train_state(module, frozen_tx), T.make_classifier_train_step(frozen_tx)
    for b in gen:  # a frozen epoch
        fstep(state, *b)
    x, y, w = gen[0]
    y, w = torch.from_numpy(y).to(device), torch.from_numpy(w).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frozen_ms = cuda_ms(lambda: fstep(state, x, y, w), 10)
    frozen_peak = torch.cuda.max_memory_allocated()
    changed = [k for k, t in base0.items() if not torch.equal(module.state_dict()[k], t)]
    if changed:
        raise AssertionError(f"the frozen stage moved {len(changed)} base tensors, e.g. {changed[:3]}")
    ft_tx = T.make_tl_optimizer(hp["fine_tune_lr"], hp["adam_beta_1"], hp["adam_beta_2"], True)
    state, ftstep = T.init_train_state(module, ft_tx), T.make_classifier_train_step(ft_tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft_ms = cuda_ms(lambda: ftstep(state, x, y, w), 10)
    ft_peak = torch.cuda.max_memory_allocated()

    ckpt = out_dir / "best_finetune_weights_0.msgpack"
    if b"float16" not in ckpt.read_bytes() or not (out_dir / "best_model_history_0.csv").is_file():
        raise AssertionError("the trained member is not a float16 checkpoint beside its history")
    ens = inv.load_ensemble([ckpt], tuple(tv["resnet_inp_shape"]), hp["last_resnet_layer"], device=device)
    probs = inv.predict_stack(invasion_stacks(1)[0], ens, hw)
    if not (probs.shape == (1, 8, 1) and np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all()):
        raise AssertionError(f"the trained member's probabilities: {probs.ravel()}")
    n = tv["batch_size"]
    return {"per_class": TRAIN_INV_PER_CLASS, "size": 256, "input": list(tv["resnet_inp_shape"]),
            "last_layer": hp["last_resnet_layer"], "batch": n, "steps_per_epoch": len(gen),
            "data_gen_s": data_s, "main_s": main_s, "main_peak_bytes": main_peak,
            "frozen_step_ms": frozen_ms, "frozen_images_per_sec": n / frozen_ms * 1e3,
            "frozen_peak_bytes": frozen_peak, "fine_tune_step_ms": ft_ms,
            "fine_tune_images_per_sec": n / ft_ms * 1e3, "fine_tune_peak_bytes": ft_peak,
            "frozen_base_byte_equal": True, "member_bytes": ckpt.stat().st_size,
            "member_probs": probs.ravel().tolist()}


def phase_train(tmp: Path, device) -> int:
    """Training at the shipped widths (models/train*.py), the trained
    segmentor through the down-block kernel, resume, and the card against
    the CPU. The trainers run with PyTorch's default TF32 flags (cuDNN on,
    cuBLAS off); the comparisons with float32 references turn TF32 off.
    Returns the segmentor's down-block launches."""
    from tmat_torch.core import defs

    saved = defs.MODEL_TRAINING_DIR
    defs.MODEL_TRAINING_DIR = tmp / "model_training"  # where the trainers register
    try:
        with tf32(True, False):
            cfg_path, seg = _train_segmentation(tmp, device)
            emit("train_seg", **seg)
            inv_fields = _train_invasion(tmp, device)
            emit("train_inv", **inv_fields)
        trained = _trained_segmentor(cfg_path, tmp, device)
        emit("train_segmentor", **trained)
        emit("train_card_vs_cpu", **_card_vs_cpu_step(device))
    finally:
        defs.MODEL_TRAINING_DIR = saved
    return trained["launches"]


# (tag, H, Cin, Cout, kh, stride) of the int8 conv at the segmentor's widths
# (patch 320, filters 64-512): the six up convs the mixed forward quantises,
# then the entry conv and the first down block's 1x1/s2 residual
INT8_MIXED = [(tag, h, cin, cout, 3, 1) for tag, h, cin, cout in INT8_UP_SHAPES]
INT8_SHAPES = INT8_MIXED + [("entry", 320, 1, 64, 3, 2), ("d0.res", 160, 64, 128, 1, 2)]
# (output dtype, relu, sout): the int8 epilogue, the mixed forward's float
# one, the float tail's (with sout), each with and without relu somewhere
INT8_FORMS = [(torch.int8, False, False), (torch.int8, True, False), (torch.bfloat16, False, False),
              (torch.float32, True, False), (torch.float32, False, True), (torch.bfloat16, True, True)]
# the fused forms of the mixed forward, a bfloat16 input requantised on load:
# (name, relu_in, output requantised through bfloat16, output dtype, relu)
INT8_FUSED_FORMS = [("t1", True, True, torch.int8, True), ("lone", False, False, torch.bfloat16, False)]
QUANT_IOU = 0.96  # the quantized mask against the f32 one: tests/test_quant.py's floor
QUANT_AREA_TOL = 0.5  # area % points between the quantized and the bf16 plate
QUANT_SCALE_RTOL = 1e-3  # the card's calibration against the shipped sidecar


def conv_work(b: int, h: int, cin: int, cout: int, kh: int, stride: int, in_bytes: int, out_bytes: int) -> dict:
    """What one int8 conv must do and move, and the least time the card
    could take for it: 2 * kh*kh*cin int8 tensor-core operations per output
    (the padded depth excluded); bytes: the batch (``in_bytes`` an element)
    read once, the packed weights and the float32 vectors (m, c, and inv_sx
    or inv_next where the input or output is requantised) read once, the
    output (``out_bytes`` an element) written once."""
    from tmat_torch.ops.int8_conv import out_size, padded_depth

    ho = out_size(h, stride)
    outputs = b * ho * ho * cout
    ops = 2 * outputs * kh * kh * cin
    vectors = 4 * (2 * cout + (cin if in_bytes > 1 else 0) + (cout if out_bytes == 1 and in_bytes > 1 else 0))
    nbytes = b * h * h * cin * in_bytes + cout * padded_depth(kh, cin) + vectors + outputs * out_bytes
    ops_ms, bytes_ms = ops / PEAK_INT8_TC * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms)}


def _int8_inputs(rng, b, h, cin, cout, kh, device):
    """A random int8 batch and packed weights, and per-channel m, c and sout
    (m keeps sums of up to 9 * 512 * 127**2 within a few hundred steps)."""
    from tmat_torch.ops import int8_conv as ic

    x = torch.from_numpy(rng.randint(-127, 128, (b, h, h, cin)).astype(np.int8)).to(device)
    packed = ic.pack_weights(rng.randint(-127, 128, (kh, kh, cin, cout)).astype(np.int8)).to(device)
    m, c, sout = (torch.tensor(v.astype(np.float32), device=device)
                  for v in (rng.rand(cout) * 2e-4, rng.randn(cout), rng.rand(cout) * 3))
    return x, packed, m, c, sout


def _fused_inputs(rng, x, packed, kh, stride, m, c):
    """A bfloat16 batch at int8 scale 1 / inv_sx (some of it past +-127), its
    inv_sx, and an inv_next that puts a tenth of each output channel past
    +-127."""
    from tmat_torch.ops import int8_conv as ic

    b, h, _, cin = x.shape
    xf = torch.from_numpy((rng.randn(b, h, h, cin) * 60).astype(np.float32)).to(x.device).to(torch.bfloat16)
    inv_sx = torch.tensor((rng.rand(cin) + 0.5).astype(np.float32), device=x.device)
    v = ic.conv2d_s8_plain(xf, packed, kh, stride, m, c, out_dtype=torch.float32, inv_sx=inv_sx)
    inv_next = 127 / torch.quantile(v.abs().reshape(-1, packed.shape[0])[:16384].cpu(), 0.9, dim=0).to(x.device)
    return xf, inv_sx, inv_next


def _im2col(x: torch.Tensor, kh: int) -> torch.Tensor:
    """The (B*H*W, kh*kh*C) int8 rows of a stride-1 SAME conv, taps in the
    packed weights' (dy, dx, ci) order."""
    p = kh // 2
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    return torch.cat([xp[:, dy: dy + h, dx: dx + w] for dy in range(kh) for dx in range(kh)],
                     dim=-1).reshape(b * h * w, kh * kh * c)


def _int8_kernel_check(rng, device):
    """Every shape in every form against the plain version, bit-equal, in
    the form the pick rule takes; the shapes that take the warpgroup form
    again in the mma.sync form."""
    from tmat_torch.ops import int8_conv as ic

    cases = []
    for tag, h, cin, cout, kh, stride in INT8_SHAPES:
        x, packed, m, c, sout = _int8_inputs(rng, 8, h, cin, cout, kh, device)
        xf, inv_sx, inv_next = _fused_inputs(rng, x, packed, kh, stride, m, c)
        calls = [(f"{str(od).split('.')[-1]}-relu{int(relu)}-sout{int(us)}",
                  (x, packed, kh, stride, m, c, relu, od, sout if us else None), {})
                 for od, relu, us in INT8_FORMS]
        calls += [(name, (xf, packed, kh, stride, m, c, relu, od),
                   {"inv_sx": inv_sx, "relu_in": relu_in, **({"inv_next": inv_next} if rq else {})})
                  for name, relu_in, rq, od, relu in INT8_FUSED_FORMS]
        for name, args, kw in calls:
            ref = ic.conv2d_s8_plain(*args, **kw)
            wide = ic.launch_form(cin, cout, kh, stride, h).startswith("wgmma")
            libraries = [()] + ([("TMAT_INT8_MMA_SYNC_ONLY",)] if wide else [])
            for defines in libraries:
                with ic.built_with(*defines):
                    out = ic.conv2d_s8(*args, **kw)
                    form = ic.last_launch()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                cases.append({"tag": tag, "shape": [8, h, h, cin, cout, kh, stride], "form": name, "kernel": form,
                              "library": list(defines), "bit_equal": torch.equal(out, ref), "max_abs_err": err})
                if not cases[-1]["bit_equal"]:
                    raise AssertionError(f"the int8 conv kernel disagrees with its plain version: {cases[-1]}")
    took = {c["tag"]: c["kernel"] for c in cases if c["form"] == "int8-relu0-sout0" and not c["library"]}
    if {took[t[0]] for t in INT8_MIXED} != {"wgmma"} or took["entry"] != "mma_sync-gather":
        raise AssertionError(f"the int8 conv's pick rule took {took}")
    # torch._int_mm on the unfolded input computes the same sums (the yardstick below)
    tag, h, cin, cout, kh, stride = INT8_MIXED[0]
    x, packed, *_ = _int8_inputs(rng, 8, h, cin, cout, kh, device)
    ones, zeros = torch.ones(cout, device=device), torch.zeros(cout, device=device)
    sums = ic.conv2d_s8(x, packed, kh, stride, ones, zeros, out_dtype=torch.float32).reshape(-1, cout)
    mm = torch._int_mm(_im2col(x, kh), packed[:, : kh * kh * cin].contiguous().t())
    if not torch.equal(mm.float(), sums):
        raise AssertionError("torch._int_mm over the unfolded input does not give the kernel's sums")
    return cases, took


def _int8_kernel_time(rng, device):
    """The six mixed convs at B=200 as the fused forward launches them (t1:
    bfloat16 in, int8 out; t2: int8 in, bfloat16 out), beside their bound,
    the plain version, the yardsticks and the earlier, unfused path:
    PyTorch's requantisation, then the mma.sync form."""
    from tmat_torch.models.unet import _conv_nhwc
    from tmat_torch.ops import int8_conv as ic

    rows = []
    for tag, h, cin, cout, kh, stride in INT8_MIXED:
        a = int8_up_inputs(ic, rng, 200, h, cin, cout, device)
        call = int8_up_call(ic, tag, a)
        ms = cuda_ms(call, 10)
        form = ic.last_launch()
        row = {"tag": tag, "shape": [200, h, h, cin, cout, kh, stride], "form": form, "ms": ms}
        with ic.built_with("TMAT_INT8_MMA_SYNC_ONLY"):
            row["mma_sync_ms"] = cuda_ms(lambda: ic.conv2d_s8(a["xq"], a["packed"], kh, stride, a["m"], a["c"],
                                                              out_dtype=torch.bfloat16), 10)
        # the unfused path's requantisation of the bf16 input (PyTorch passes)
        row["requant_ms"] = cuda_ms(
            lambda: torch.clamp(torch.round(a["xf"].float() * a["inv_sx"]), -127, 127).to(torch.int8), 10)
        row["unfused_path_ms"] = row["mma_sync_ms"] + row["requant_ms"]
        # the fused call's plain version, on the card (float64 sums)
        if tag.endswith("t1"):
            row["plain_ms"] = cuda_ms(lambda: ic.conv2d_s8_plain(
                a["xf"], a["packed"], kh, stride, a["m"], a["c"], True, inv_sx=a["inv_sx"], relu_in=True,
                inv_next=a["inv_next"], mid_dtype=torch.bfloat16), 2)
        else:
            row["plain_ms"] = cuda_ms(lambda: ic.conv2d_s8_plain(
                a["xq"], a["packed"], kh, stride, a["m"], a["c"], out_dtype=torch.bfloat16), 2)
        cols, w_kn = _im2col(a["xq"], kh), a["packed"][:, : kh * kh * cin].contiguous().t()
        row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(cols, w_kn), 10)
        del cols
        kb = torch.randn(cout, cin, kh, kh, device=device, dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        row["cudnn_bf16_ms"] = cuda_ms(lambda: _conv_nhwc(a["xf"], kb, stride), 10)
        del a
        torch.cuda.empty_cache()
        t1 = tag.endswith("t1")
        row.update(conv_work(200, h, cin, cout, kh, stride, 2 if t1 else 1, 1 if t1 else 2))
        row["tops"] = row["ops"] / ms / 1e9
        rows.append(row)
    return rows


@contextmanager
def count_calibrations():
    """Counts ``models/quant.py::calibrate`` calls within the block."""
    from tmat_torch.models import quant

    calls = [0]
    real = quant.calibrate

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    quant.calibrate = counting
    try:
        yield calls
    finally:
        quant.calibrate = real


def phase_quant(rng, unet: dict, plate_run: dict, device, tmp: Path) -> dict:
    """The int8 conv kernel, the quantized shipped segmentor, a calibration
    on a copy of its checkpoint and a quantized plate. Returns the int8 and
    down-block launches of the quantized forward and plate run."""
    import shutil

    from tmat_torch.core import defs
    from tmat_torch.models import quant
    from tmat_torch.models.unet import UNetXceptionPatchSegmentor, get_unet_patch_segmentor_from_cfg
    from tmat_torch.ops import down_block as db, int8_conv as ic
    from tmat_torch.tools.plate_pipeline import run_plate

    cases, took = _int8_kernel_check(rng, device)
    emit("quant_kernel_check", cases=len(cases), all_bit_equal=True, forms_taken=took,
         mma_sync_cases=sum(c["kernel"].startswith("mma_sync") for c in cases),
         wgmma_cases=sum(c["kernel"].startswith("wgmma") for c in cases),
         forms=len(INT8_FORMS) + len(INT8_FUSED_FORMS))
    timings = _int8_kernel_time(rng, device)

    def total(key):
        return sum(t[key] for t in timings)

    emit("quant_kernel_time", convs=timings, ms=total("ms"), bound_ms=total("bound_ms"),
         ops_ms=total("ops_ms"), bytes_ms=total("bytes_ms"), plain_ms=total("plain_ms"),
         int_mm_ms=total("int_mm_ms"), cudnn_bf16_ms=total("cudnn_bf16_ms"), mma_sync_ms=total("mma_sync_ms"),
         requant_ms=total("requant_ms"), unfused_path_ms=total("unfused_path_ms"), ops=total("ops"),
         bytes=total("bytes"))

    # the shipped segmentor, "quantize": true: the shipped sidecar's scales
    root = Path(__file__).resolve().parent
    with open(root / SHIPPED_CFG) as f:
        cfg = json.load(f)
    ckpt = defs.model_training_path(f"binary_segmentation/checkpoints/{cfg['checkpoint_file']}")
    cfg_path = tmp / "quant_segmentor.json"
    cfg_path.write_text(json.dumps({**cfg, "checkpoint_file": str(ckpt), "quantize": True}))
    with count_calibrations() as calls:
        qseg = get_unet_patch_segmentor_from_cfg(str(cfg_path), device=device)
    if not (qseg.quantized and calls[0] == 0 and qseg.dtype == torch.bfloat16):
        raise AssertionError(f"quantized segmentor: quantized {qseg.quantized}, {calls[0]} calibrations, "
                             f"{qseg.dtype}")
    batch = unet["batch"]
    ic.launches = db.launches = 0  # the quantized forward starts here
    pred = qseg.model(batch)
    torch.cuda.synchronize()
    forward_launches = (ic.launches, db.launches)  # ... and ends here
    if forward_launches != (6, 3):
        raise AssertionError(f"the quantized forward launched {forward_launches} int8 / down-block kernels, not (6, 3)")
    if not (torch.isfinite(pred).all() and pred.shape == batch.shape):
        raise AssertionError("quantized forward: non-finite or misshapen output")
    # the same function with the requantisations as PyTorch passes
    qseg.model.up_main = qseg.model.up_main_unfused
    unfused = qseg.model(batch)
    unfused_ms = cuda_ms(lambda: qseg.model(batch), 3)
    del qseg.model.up_main
    if not torch.equal(pred, unfused):
        raise AssertionError("the fused quantized forward differs from the unfused one")
    mq, m32 = pred > 0.5, unet["mask32"]
    iou = (mq & m32).sum().item() / max((mq | m32).sum().item(), 1)
    if iou < QUANT_IOU:
        raise AssertionError(f"quantized vs f32 mask IoU {iou} < {QUANT_IOU}")
    forward_ms = cuda_ms(lambda: qseg.model(batch), 3)
    emit("quant_unet", batch=list(batch.shape), calibrations=calls[0], launches={"int8_conv": 6, "down_block": 3},
         equal_to_unfused=True, mask_iou_vs_f32=iou, forward_ms=forward_ms, unfused_forward_ms=unfused_ms,
         bf16_forward_ms=unet["forward_ms"], speed_vs_bf16=unet["forward_ms"] / forward_ms)

    # a calibration on the card, on a copy of the checkpoint
    copy = tmp / "calib" / ckpt.name
    copy.parent.mkdir()
    shutil.copy(ckpt, copy)
    t0 = time.perf_counter()
    with count_calibrations() as calls:
        UNetXceptionPatchSegmentor(cfg["patch_size"], copy, tuple(cfg["filter_counts"]), quantize=True,
                                   device=device)
        calib_s = time.perf_counter() - t0
        written = quant.load_scales_for(copy)
        UNetXceptionPatchSegmentor(cfg["patch_size"], copy, tuple(cfg["filter_counts"]), quantize=True,
                                   device=device)
    shipped = quant.load_scales_for(ckpt)
    if calls[0] != 1 or written is None or set(written) != set(shipped):
        raise AssertionError(f"calibration on a copy: {calls[0]} calibrations, sidecar written: {written is not None}")
    rel = max(float(np.max(np.abs(written[k] - shipped[k]) / np.abs(shipped[k]))) for k in shipped)
    if rel > QUANT_SCALE_RTOL:
        raise AssertionError(f"the card's scales are {rel} relative off the shipped sidecar's")
    emit("quant_calibration", seconds=calib_s, calibrations=calls[0], scales=len(written),
         max_rel_diff_vs_shipped=rel)

    # the plate of phase 5 with the quantized segmentor
    forwards = [0]

    def counted(b):
        forwards[0] += 1
        return qseg.model(b)

    qseg._pred_fn = counted
    config = {"image_width_microns": 1200.0}
    plate, ids = plate_run["plate"], plate_run["ids"]
    run_plate(plate, ids, qseg, config, device=device)  # warm
    forwards[0] = 0
    ic.launches = db.launches = 0  # the quantized plate run starts here
    t0 = time.perf_counter()
    res = run_plate(plate, ids, qseg, config, device=device)
    wps = len(ids) / (time.perf_counter() - t0)
    plate_launches = (ic.launches, db.launches)  # ... and ends here
    res.pop("_timer")
    ref = plate_run["results"]
    if plate_launches != (6 * forwards[0], 3 * forwards[0]) or forwards[0] == 0:
        raise AssertionError(f"{plate_launches} int8 / down-block launches for {forwards[0]} forwards")
    area_diff = max(abs(a - b) for a, b in zip(res["area_pct"], ref["area_pct"]))
    if area_diff > QUANT_AREA_TOL:
        raise AssertionError(f"quantized plate area % {area_diff} points off the bf16 plate's")
    emit("quant_plate", wells=len(ids), wells_per_sec=wps, bf16_wells_per_sec=plate_run["wells_per_sec"],
         unet_forwards=forwards[0], max_area_pct_diff=area_diff, results=res, bf16_results=ref)
    del qseg
    torch.cuda.empty_cache()
    return {"int8": forward_launches[0] + plate_launches[0], "down_block": forward_launches[1] + plate_launches[1],
            "max_abs_err": max(c["max_abs_err"] for c in cases), "timings": timings}


def _tree_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def phase_package(stacks: np.ndarray, device, tmp: Path) -> None:
    """The bundle on the card: ``./tmat-torch compute_zproj -m fs`` on a
    fresh build cache, byte-equal to the in-process tool; the standalone
    bundle's ``-m max`` with no python on PATH, byte-equal too."""
    import shutil

    from PIL import Image

    from tmat_torch import build
    from tmat_torch.tools import compute_zproj

    src = tmp / "pkg_in"
    src.mkdir()
    for i, stack in enumerate(stacks):
        for z, sl in enumerate(stack):
            Image.fromarray(sl).save(src / f"W{i}_z{z:02d}.tif")
    refs = {}
    for method in ("fs", "max"):
        refs[method] = tmp / f"pkg_ref_{method}"
        compute_zproj.main(argv=[str(src), str(refs[method]), "-m", method], device=device)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {}
    for kind, flags in (("bundle", []), ("standalone", ["--standalone"])):
        out = tmp / f"pkg_{kind}"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tmat_torch.packaging", str(out), *flags], cwd=str(tmp),
                              env=_child_env(), capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        packaging_out = proc.stdout
        if proc.returncode != 0:
            raise AssertionError(f"packaging {kind} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        nbytes = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
        run_env = {**env, "TMAT_TORCH_BUILD_DIR": str(tmp / f"pkg_build_{kind}"),
                   "TMAT_TPU_BASE_DIR": str(_empty_base(tmp / f"pkg_base_{kind}")), "TMPDIR": str(tmp)}
        if kind == "bundle":
            method = "fs"
            run_env["TMAT_TORCH_PYTHON"] = sys.executable
        else:  # bash, dirname and env, and the compilers a first build needs; no python
            method = "max"
            cleanbin = tmp / "pkg_cleanbin"
            cleanbin.mkdir()
            for tool in ("bash", "dirname", "env", "g++", "gcc"):
                os.symlink(shutil.which(tool), cleanbin / tool)
            os.symlink(build.nvcc_path(), cleanbin / "nvcc")
            run_env = {"HOME": str(tmp), "PATH": str(cleanbin), "TERM": "dumb",
                       **{k: run_env[k] for k in ("TMAT_TORCH_BUILD_DIR", "TMAT_TPU_BASE_DIR", "TMPDIR")}}
            if any(cleanbin.glob("python*")):
                raise AssertionError("the clean PATH holds a python")
        result = tmp / f"pkg_out_{kind}"
        t0 = time.perf_counter()
        proc = subprocess.run([str(out / "tmat-torch"), "compute_zproj", str(src), str(result), "-m", method],
                              cwd=str(tmp), env=run_env, capture_output=True, text=True, timeout=600)
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{kind} compute_zproj exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        got, want = _tree_files(result), _tree_files(refs[method])
        if not want or got != want:
            raise AssertionError(f"{kind} compute_zproj -m {method} outputs differ from the in-process tool's: "
                                 f"{sorted(set(got) ^ set(want))}")
        built = sorted(p.name.split("-")[0] for p in (tmp / f"pkg_build_{kind}").glob("lib*.so"))
        runs[kind] = {"bytes": nbytes, "build_s": build_s, "run_s": run_s, "method": method,
                      "outputs": len(got), "libraries_built": built,
                      "packaging_said": [ln for ln in packaging_out.splitlines() if ln.strip()][-2:]}
        if kind == "standalone":
            shutil.rmtree(out, ignore_errors=True)
    if runs["bundle"]["libraries_built"] != ["libfocus_stack"]:
        raise AssertionError(f"the bundle's fs run built {runs['bundle']['libraries_built']}, not the focus kernel")
    emit("package", stacks=len(stacks), outputs_byte_equal=True, **runs)


def kernels_digest(state: dict) -> str:
    """SHA-256 of a trainable model's kernels: float32 bytes in state-dict
    (Flax tree) order."""
    h = hashlib.sha256()
    for key, t in state.items():
        if key.endswith(".kernel"):
            h.update(np.ascontiguousarray(np.asarray(t, np.float32)).tobytes())
    return h.hexdigest()


def phase_rng(device, smi: str) -> None:
    """JAX's threefry streams (``core/prng.py``): the well search's default
    draws and the UNet's from-scratch kernels against digests pinned to the
    JAX package, the card's bits against the CPU's, and the ResNet50 init
    timed on the card."""
    from tmat_torch.core import prng
    from tmat_torch.models import resnet, unet
    from tmat_torch.ops.wellmask import unit_draws

    draws = unit_draws(0)
    digests = {"unit_draws_0": hashlib.sha256(draws.tobytes()).hexdigest()}
    on_card = prng.uniform(prng.prng_key(0), draws.shape, device=device).cpu().numpy()
    if not np.array_equal(on_card, draws):
        raise AssertionError("the card's unit draws differ from the CPU's")
    card_unet = unet.build_unet_xception(**RNG_UNET, seed=0, device=device).state_dict()
    digests["unet_kernels_0"] = kernels_digest({k: t.cpu() for k, t in card_unet.items()})
    cpu_unet = unet.build_unet_xception(**RNG_UNET, seed=0, device="cpu").state_dict()
    if kernels_digest(cpu_unet) != digests["unet_kernels_0"]:
        raise AssertionError("the card's UNet init differs from the CPU's")
    if digests != RNG_DIGESTS:
        raise AssertionError(f"threefry digests {digests} differ from JAX's {RNG_DIGESTS}")

    def resnet_init():
        model = resnet.build_trainable_resnet50_tl(**RNG_RESNET, seed=0, device=device)
        torch.cuda.synchronize()
        return model

    init_s = []
    for _ in range(3):  # the first also loads the kernels the init launches
        t0 = time.perf_counter()
        model = resnet_init()
        init_s.append(time.perf_counter() - t0)
    n_params = sum(t.numel() for t in model.parameters())
    card_state = {k: t.cpu() for k, t in model.state_dict().items()}
    t0 = time.perf_counter()
    cpu_state = resnet.build_trainable_resnet50_tl(**RNG_RESNET, seed=0, device="cpu").state_dict()
    cpu_s = time.perf_counter() - t0
    bad = [k for k in cpu_state if not torch.equal(cpu_state[k], card_state[k])]
    if bad:
        raise AssertionError(f"the card's ResNet50 init differs from the CPU's at {bad[:3]}")
    emit("rng", digests=digests, card_equals_cpu=True, resnet50_params=n_params,
         resnet50_init_s=init_s, resnet50_init_cpu_s=cpu_s, nvidia_smi=smi)


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
    unet = phase_unet(seg, synthetic_plate(1, rng)[0], device)
    plate_run = phase_plate(seg, args.wells, rng, device)
    launches = plate_run["launches"]
    parts_launches = phase_plate_parts(seg, plate_run, device, smi)
    focus_cases = phase_focus_check(rng, device)
    focus_timings, empty_launch_ms = phase_focus_time(rng, device)
    fs_plate, sharp, rings = focus_plate(args.wells, rng)
    zproj_launches = phase_zproj(fs_plate, sharp, rings, device)
    fs_launches = phase_plate_fs(seg, fs_plate, device)
    from tmat_torch.tools.compute_zproj import project

    branch_launches = phase_branches(
        seg, [well.max(axis=0) for well in synthetic_plate(args.wells, rng)],
        [project(stack, "fs", device) for stack in fs_plate], fs_plate, device)

    from tmat_torch.ops import resize_lanczos4 as rl

    inv_stacks, ens, hw, thresh, resize = phase_inv_depth(device)
    cli_resize = rl.launches
    phase_cli(inv_stacks, ens, hw, thresh, device)
    cli_resize = rl.launches - cli_resize
    del ens
    torch.cuda.empty_cache()

    profile_rng = np.random.RandomState(args.seed + 1)
    profile_launches = phase_profile(seg, args.wells, profile_rng, device, tmp)
    phase_warmup(tmp)
    dist_launches = phase_distributed(
        inv_stacks, synthetic_plate(args.wells, profile_rng),
        [well.max(axis=0) for well in synthetic_plate(args.wells, profile_rng)], tmp)
    train_resize = rl.launches
    train_launches = phase_train(tmp, device)
    train_resize = rl.launches - train_resize
    quant_run = phase_quant(rng, unet, plate_run, device, tmp)
    phase_package(fs_plate[:4], device, tmp)
    phase_rng(device, smi)

    one_stack = focus_timings[0]  # (1, 8, 1024, 1024): what both paths launch
    kernels = [{
        "name": "down_block",
        "route": "cuda",
        "source": "tmat_torch/csrc/down_block.cu",
        "replaces": "tmat_tpu/ops/pallas_unet.py:245",
        "launches": (launches + parts_launches["down_block"] + fs_launches["down_block"]
                     + branch_launches + profile_launches + sum(dist_launches.values())
                     + train_launches + quant_run["down_block"]),
        "launches_by_path": {"plate": launches, "plate_parts": parts_launches["down_block"],
                             "plate_fs": fs_launches["down_block"],
                             "branches": branch_launches, "profile": profile_launches,
                             "distributed_branches_2d": dist_launches["branches_2d"],
                             "distributed_plate": dist_launches["plate"], "train": train_launches,
                             "quant": quant_run["down_block"]},
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
        "launches": zproj_launches + fs_launches["focus_stack"] + parts_launches["focus_stack"],
        "launches_by_path": {"zproj": zproj_launches, "plate_fs": fs_launches["focus_stack"],
                             "plate_parts": parts_launches["focus_stack"]},
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
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "tmat_torch/csrc/int8_conv.cu",
        # no Pallas kernel: the JAX package's s8 x s8 -> s32 lax convolution
        "replaces": "tmat_tpu/models/quant.py:629",
        "launches": quant_run["int8"],
        "launches_by_path": {"quant": quant_run["int8"]},
        "max_abs_err": quant_run["max_abs_err"],
        # the six int8 up convs of one mixed forward of 200 patches, fused as
        # the forward launches them (t1 bf16 in, int8 out; t2 int8 in, bf16 out)
        "ms": sum(t["ms"] for t in quant_run["timings"]),
        "plain_ms": sum(t["plain_ms"] for t in quant_run["timings"]),
        "bound_ms": sum(t["bound_ms"] for t in quant_run["timings"]),
        "bound_by": ("operations" if sum(t["ops_ms"] for t in quant_run["timings"])
                     >= sum(t["bytes_ms"] for t in quant_run["timings"]) else "bytes"),
        # torch._int_mm over the unfolded input (its s32 products only)
        "library_ms": sum(t["int_mm_ms"] for t in quant_run["timings"]),
        "cudnn_bf16_ms": sum(t["cudnn_bf16_ms"] for t in quant_run["timings"]),
        # the unfused path: PyTorch's requantisation, then the mma.sync form
        "unfused_path_ms": sum(t["unfused_path_ms"] for t in quant_run["timings"]),
        "convs": [{"tag": t["tag"], "form": t["form"], "ms": t["ms"], "bound_ms": t["bound_ms"],
                   "int_mm_ms": t["int_mm_ms"], "cudnn_bf16_ms": t["cudnn_bf16_ms"],
                   "unfused_path_ms": t["unfused_path_ms"]} for t in quant_run["timings"]],
    }, {
        "name": "resize_lanczos4",
        "route": "cuda",
        "source": "tmat_torch/csrc/resize_lanczos4.cu",
        # no Pallas kernel: the JAX package resizes in numpy on the host
        "replaces": "tmat_tpu/models/preprocess.py:71",
        "launches": resize["path_launches"] + cli_resize + train_resize,
        "launches_by_path": {"inv_depth": resize["path_launches"], "cli": cli_resize, "train": train_resize},
        "max_abs_err": resize["max_abs_err"],
        "mismatched_pixels": resize["mismatched_pixels"],
        # one uint8 (8, 1024, 1024) stack to 256^2, as inv_depth launches it
        "ms": resize["ms"],
        "plain_ms": resize["plain_ms"],
        "host_resize_ms": resize["host_resize_ms"],
        "bound_ms": resize["bound_ms"],
        "bound_by": resize["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
