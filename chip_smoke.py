"""Drive the PyTorch/CUDA port (tmat_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--wells 8] [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name, count and power limit (no CUDA device: exit 1);
2. build: the CUDA kernel and the three host libraries, from the sources
   in this checkout, all compilers started together;
3. kernel: the fused down block against its plain PyTorch version at the
   three production block shapes (B=8, f32 and bf16), then timed at B=200
   (CUDA events) beside its plain version and its bound on this card;
4. unet: the shipped segmentor's forward on a 200 x 320^2 bf16 patch
   batch of a synthetic well, kernel path against plain path (mask IoU),
   with exactly 3 kernel launches;
5. plate: ``run_plate`` on a synthetic 1024^2, Z=8 uint8 plate with the
   shipped checkpoint and TTA 8, warmed on one plate, then timed twice;
   the launch counts of this run go into the kernels line.

The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM dense peaks and memory rate (NVIDIA data sheet): bf16 products on
# the tensor cores, f32 on the CUDA cores
PEAK_BF16_TC = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SHIPPED_CFG = "model_training/binary_segmentation/configs/unet_patch_segmentor_1.json"
# (H, C, F) of the production down blocks: patch 320, filters 64-128-256-512
BLOCK_SHAPES = [(160, 64, 128), (80, 128, 256), (40, 256, 512)]
TOL = {torch.float32: 2e-5}  # bf16: 2**-6 of the output's largest magnitude


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not measured"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, CUDA events, after a warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    jobs = {"down_block": lambda: build.cuda_library("down_block")}
    for name in ("labeling", "dmtgraph", "morse"):
        jobs[name] = lambda n=name: build.host_library(n)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        paths = {name: str(f.result()) for name, f in futures.items()}
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.logs.get("down_block", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(seconds, 3), libraries=paths, ptxas=ptxas)


def phase_kernel(rng, device):
    from tmat_torch.ops import down_block as db

    errors = []
    for h, c, f in BLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, blk = db.random_block(rng, 8, h, c, f, dtype, device)
            for first in (True, False):
                out = db.down_block(x, blk, first)
                ref = db.down_block_plain(x, blk, first)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL.get(dtype, 2.0 ** -6 * ref.float().abs().max().item())
                errors.append({"shape": [8, h, h, c, f], "dtype": str(dtype), "first": first,
                               "max_abs_err": err, "tol": tol})
                if not (err <= tol and torch.isfinite(out.float()).all()):
                    raise AssertionError(f"down block kernel disagrees with its plain version: {errors[-1]}")
    emit("kernel_check", cases=errors)

    timings = []
    for h, c, f in BLOCK_SHAPES:
        x, blk = db.random_block(rng, 200, h, c, f, torch.bfloat16, device)
        first = h == BLOCK_SHAPES[0][0]
        kernel_ms = cuda_ms(lambda: db.down_block(x, blk, first), 10)
        plain_ms = cuda_ms(lambda: db.down_block_plain(x, blk, first), 10)
        timings.append({"shape": [200, h, h, c, f], "dtype": "bfloat16", "ms": kernel_ms,
                        "plain_ms": plain_ms, **block_work(200, h, c, f, torch.bfloat16),
                        "tile": db.launch_config(c, f, torch.bfloat16)})
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
    emit("unet", batch=list(batch.shape), dtype=str(seg.dtype), launches=launched, mask_iou=iou,
         max_abs_diff=(pred - plain).abs().max().item(), foreground=mp.float().mean().item(),
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
    smi = smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

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

    kernels = [{
        "name": "down_block",
        "route": "cuda",
        "source": "tmat_torch/csrc/down_block.cu",
        "replaces": "tmat_tpu/ops/pallas_unet.py:245",
        "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in errors),
        # one UNet forward of 200 patches: the three production blocks
        "ms": sum(t["ms"] for t in timings),
        "plain_ms": sum(t["plain_ms"] for t in timings),
        "bound_ms": sum(t["bound_ms"] for t in timings),
        "bound_by": ("operations" if sum(t["ops_ms"] for t in timings) >= sum(t["bytes_ms"] for t in timings)
                     else "bytes"),
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
