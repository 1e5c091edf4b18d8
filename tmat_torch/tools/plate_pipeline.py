"""Plate-scale pipeline on one CUDA device: zproj -> cell area -> branches.

Counterpart of ``tmat_tpu/tools/plate_pipeline.py``. A producer thread
projects each well's Z stack on the host as it is decoded (for ``-m fs``
it ships the Z-padded stack with its depth, and the chunk is projected by
the focus-stacking kernel) and feeds a bounded queue; each chunk of wells
then runs stage 1 on the device, the component filter on the host, stage 2
on the device and the Morse engine on the host, in a pool task, so one
chunk's host tail overlaps the next chunk's device work. With
``-w/--detect-well`` a well mask is fitted per well on the projection that
stage 1 analyses: the area is then a fraction of the well, the segmentor
sees the well only, and a shrunken mask prunes branches at the well's
edge. Device work is issued under one lock onto the current stream.

While a ``torch.profiler`` records on the calling thread, each call's
stages are also spans (``core/profiling.py``) of their well (the call's
sequence number and the well id): ``well``, from the producer's hand-off
to the end of the well's ``morse_graphs``, causes the chunk's
``device_lock_wait`` (both acquisitions), ``device_stage1`` (with stage
1's parts and ``to_host``), ``post_filter``, ``post_stage2`` and
``morse_graphs``.

Under torchrun each process runs a round-robin stripe of the wells, and
the primary writes the CSV from every process's per-well rows, in the
plate's well order (``parallel/distributed.py``). Where the JAX package
shards each chunk over a mesh spanning the processes, the port's
processes share nothing but these rows; nothing a well computes depends
on the wells beside it, so the CSV is the one process's.

Usage:
    python -m tmat_torch.tools.plate_pipeline IN_DIR OUT_DIR \
        --image-width-microns 1200 [--model-cfg PATH]
"""

from __future__ import annotations

import argparse
import csv
import itertools
import queue as queue_mod
import sys
import threading
import time
import traceback
from collections import deque
from contextlib import contextmanager
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait as futures_wait
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tmat_torch.core import defs, io as tio
from tmat_torch.core.log import SFM, section_footer, section_header
from tmat_torch.core.profiling import Span, StageTimer, count, maybe_profile, profiler_active, traced
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg
from tmat_torch.ops.resize import resize
from tmat_torch.ops.wellmask import make_well_mask
from tmat_torch.ops.zproj import PROJ_METHODS, proj_host
from tmat_torch.parallel.distributed import (
    gather_objects, is_multiprocess, is_primary, maybe_initialize_from_env, merge_striped_rows,
    process_index, stripe)
from tmat_torch.parallel.plate import plate_stage1, plate_stage2, plate_zproj_masked
from tmat_torch.topo.morse_native import morse_stats_native
from tmat_torch.topo.transforms import filter_branch_seg_mask

DOWNSAMPLE_WIDTH = 384
_plate_calls = itertools.count()  # sequence numbers of run_plate_streaming calls, for span items
RESULT_KEYS = ("well_id", "area_pct", "total_branches", "total_branch_length_um",
               "avg_branch_length_um")


def _analyze_well_graph(pred384: np.ndarray, config: dict, width_px: int, pruning_mask=None):
    """Host Morse-graph stage for one well; returns (n, total_um, avg_um)."""
    width_um = config["image_width_microns"]

    def to_px(um):
        return (width_px / width_um) * um

    def to_um(px):
        return (width_um / width_px) * px

    lo, hi = float(pred384.min()), float(pred384.max())
    if not np.isfinite(hi - lo) or hi - lo < 1e-12:
        # a constant raster has no branches (and 255/(hi-lo) would overflow)
        return 0, 0.0, 0.0
    scaled = (pred384 - lo) * np.float32(255.0 / (hi - lo))
    n_branches, total_px, avg_px = morse_stats_native(
        scaled,
        thresholds=(config.get("graph_thresh_1", 5), config.get("graph_thresh_2", 10)),
        smoothing_window=round(max(1, to_px(config.get("graph_smoothing_window", 12)))),
        min_branch_length=round(to_px(config.get("min_branch_length", 12))),
        remove_isolated_branches=config.get("remove_isolated_branches", False),
        pruning_mask=pruning_mask,
    )
    return n_branches, to_um(total_px), to_um(avg_px)


def run_plate(
    stacks: np.ndarray,
    well_ids: Sequence[str],
    segmentor,
    config: dict,
    sd_coef: float = 0.0,
    timer: Optional[StageTimer] = None,
    detect_well: bool = False,
    seed: int = 0,
    proj_method: str = "max",
    z_counts: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> Dict[str, list]:
    """Process an in-memory (B, Z, H, W) plate; returns per-well results.

    Wells stream from the array through ``run_plate_streaming``, each
    trimmed to its true depth when ``z_counts`` is given. ``seed`` seeds
    the well-mask search of ``detect_well``.
    """
    n_wells = stacks.shape[0]
    if z_counts is None:
        z_counts = [stacks.shape[1]] * n_wells

    def wells():
        for i in range(n_wells):
            yield well_ids[i], stacks[i, : max(1, int(z_counts[i]))]

    return run_plate_streaming(
        wells(), n_wells, stacks.shape[1:], segmentor, config,
        plate_dtype=stacks.dtype, sd_coef=sd_coef, timer=timer,
        detect_well=detect_well, seed=seed, proj_method=proj_method, device=device,
    )


def run_plate_streaming(
    wells,
    n_wells: int,
    plate_zhw,
    segmentor,
    config: dict,
    plate_dtype=np.uint8,
    sd_coef: float = 0.0,
    timer: Optional[StageTimer] = None,
    detect_well: bool = False,
    seed: int = 0,
    proj_method: str = "max",
    prefetch: int = 3,
    chunk_wells: int = 1,
    device: DeviceLike = None,
) -> Dict[str, list]:
    """``run_plate`` over an iterator of (well_id, (Z, H, W) ndarray).

    ``plate_zhw`` is the padded per-well geometry; ``prefetch`` bounds the
    chunks buffered ahead of the device; ``chunk_wells`` wells share one
    stage-1 call (one well is one UNet forward of all its patches).
    ``device=None`` means CUDA and must match the segmentor's device.
    """
    traced_call = profiler_active()  # once per call, on the caller's thread (module doc)
    seq = next(_plate_calls)
    dev = resolve_device(device)
    if segmentor.device != dev:
        raise ValueError(f"segmentor is on {segmentor.device}, the plate on {dev}")
    if proj_method not in PROJ_METHODS:
        raise ValueError(f"Unknown projection method: {proj_method}")
    timer = timer or StageTimer()
    z_max, h_max, w_max = (int(v) for v in plate_zhw)
    target = tuple(int(v) for v in np.round(np.multiply((h_max, w_max), segmentor.ds_ratio)))
    dsamp = tuple(int(v) for v in np.round(np.multiply(target, DOWNSAMPLE_WIDTH / target[-1])))
    # every method but fs projects on the host as each well is decoded, so
    # only an (H, W) projection crosses to the device; fs needs the device,
    # and ships the Z-padded stack with its depth
    pre_project = proj_method != "fs"
    chunk_dtype = np.float32 if proj_method in ("avg", "med") else plate_dtype
    pad_shape = (h_max, w_max) if pre_project else (z_max, h_max, w_max)

    chunk_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()
    device_lock = threading.Lock()

    @contextmanager
    def on_device(name: str):
        """Stage ``name`` under the device lock; the wait for the lock is
        a stage of its own, outside it."""
        with timer.stage("device_lock_wait"):
            device_lock.acquire()
        try:
            with timer.stage(name):
                yield
        finally:
            device_lock.release()

    def _put(item) -> None:
        """Enqueue, giving up once the consumer has stopped."""
        while not stop.is_set():
            try:
                chunk_q.put(item, timeout=0.5)
                return
            except queue_mod.Full:
                continue

    def producer():
        try:
            ids, buf, zcs = [], [], []

            def flush():
                chunk = np.stack(buf)
                wells_open = [Span("well", f"{seq}/{wid}") for wid in ids] if traced_call else []
                _put((list(ids), chunk, list(zcs), wells_open))
                ids.clear(), buf.clear(), zcs.clear()

            for wid, stack in wells:
                if stop.is_set():
                    return
                arr = np.zeros(pad_shape, chunk_dtype)
                if pre_project:
                    proj = proj_host(stack, proj_method)
                    arr[: proj.shape[0], : proj.shape[1]] = proj
                else:
                    arr[: stack.shape[0], : stack.shape[1], : stack.shape[2]] = stack
                ids.append(wid)
                buf.append(arr)
                zcs.append(int(stack.shape[0]))
                if len(buf) == chunk_wells:
                    flush()
            if buf:
                flush()
            _put(None)
        except BaseException as exc:  # the consumer re-raises it
            _put(exc)

    def fit_well_masks(proj: torch.Tensor):
        """(B, *target) float well masks on the device and the per-well
        pruning masks (the inverted shrunken masks at ``dsamp``) on the
        host, fitted on the projections that stage 1 analyses."""
        small_np = resize(proj, target, "lanczos").cpu().numpy()
        pairs = [make_well_mask(small, seed=seed, device=dev) for small in small_np]
        wm = torch.from_numpy(np.stack([m for m, _ in pairs]).astype(np.float32)).to(dev)
        outside = torch.from_numpy(np.stack([~s for _, s in pairs]).astype(np.float32)).to(dev)
        pruning = (resize(outside, dsamp, "nearest") > 0).cpu().numpy()
        return wm, list(pruning)

    def chunk_task(chunk_np: np.ndarray, zcs, ids, wells_open):
        """One chunk end to end, in a pool thread; its stages are spans of
        its wells (the first well's ``well`` span causes them)."""
        parent = wells_open[0].id if wells_open else None
        with traced(traced_call, f"{seq}/{'+'.join(ids)}", parent):
            area, stats = _chunk(chunk_np, zcs)
        for well in wells_open:
            well.close()
        return area, stats

    def _chunk(chunk_np: np.ndarray, zcs):
        wm, pruning_chunk = None, [None] * len(zcs)
        with on_device("device_stage1"):
            stage1_in = torch.from_numpy(chunk_np).to(dev, non_blocking=False)
            stage1_pre = pre_project
            if detect_well:
                if not pre_project:
                    # project once: the mask is fitted on what stage 1 analyses
                    stage1_in = plate_zproj_masked(stage1_in, zcs, proj_method)
                    stage1_pre = True
                with timer.stage("well_mask"):
                    wm, pruning_chunk = fit_well_masks(stage1_in.float())
            area, preds, f_pk, s_pk = plate_stage1(
                stage1_in, segmentor._pred_fn, segmentor.patch_size, 2, target, sd_coef, wm,
                proj_method=proj_method, z_counts=zcs, pre_projected=stage1_pre,
                tta=segmentor.tta, timer=timer,
            )
            with timer.stage("to_host"):
                area, f_pk, s_pk = area.cpu().numpy(), f_pk.cpu().numpy(), s_pk.cpu().numpy()
                count("host_copies", 3)
        w = preds.shape[-1]
        with timer.stage("post_filter"):
            f_np = np.unpackbits(f_pk, axis=-1)[..., :w].astype(bool)
            s_np = np.unpackbits(s_pk, axis=-1)[..., :w].astype(bool)
            masks = np.stack([
                filter_branch_seg_mask(f_np[j].astype(np.uint8), footprint=None,
                                       precomputed_skeleton=s_np[j]) > 0
                for j in range(f_np.shape[0])
            ])
            masks_pk = np.packbits(masks, axis=-1)
        with on_device("post_stage2"):
            p384 = plate_stage2(
                preds, torch.from_numpy(masks_pk).to(dev), torch.from_numpy(s_pk).to(dev),
                dsamp,
            ).cpu().numpy()
            del preds
        with timer.stage("morse_graphs"):
            stats = [_analyze_well_graph(p384[j], config, dsamp[1], pruning_chunk[j])
                     for j in range(p384.shape[0])]
        return area, stats

    well_ids: list = []
    finished = []
    max_workers = 8
    threading.Thread(target=producer, daemon=True).start()
    try:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = []
            while True:
                # backpressure reaches the producer through chunk_q
                while True:
                    for f in futures:  # fail fast on a failed chunk
                        if f.done() and f.exception() is not None:
                            raise f.exception()
                    pending = [f for f in futures if not f.done()]
                    if len(pending) < max_workers + max(1, prefetch):
                        break
                    futures_wait(pending, return_when=FIRST_COMPLETED)
                item = chunk_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                ids, chunk_np, zcs, wells_open = item
                well_ids.extend(ids)
                futures.append(pool.submit(chunk_task, chunk_np, zcs, ids, wells_open))
            finished = [f.result() for f in futures]
    finally:
        stop.set()

    areas = np.concatenate([a for a, _ in finished]) if finished else np.zeros(0)
    graph_stats = [st for _, stats in finished for st in stats]
    results = {
        "well_id": well_ids[:n_wells],
        "area_pct": [float(a) * 100 for a in areas[:n_wells]],
        "total_branches": [g[0] for g in graph_stats],
        "total_branch_length_um": [g[1] for g in graph_stats],
        "avg_branch_length_um": [g[2] for g in graph_stats],
    }
    results["_timer"] = timer
    return results


def merge_plate_results(results: Dict[str, list], global_idxs: Sequence[int],
                        error: Optional[str] = None):
    """Every process's per-well ``results`` (of the wells at ``global_idxs``
    of the plate) in the plate's well order, on every process, and every
    error a process caught: ``(results, errors)``. One process: its own."""
    rows = [(g, *vals) for g, vals in zip(global_idxs, zip(*(results[k] for k in RESULT_KEYS)))]
    merged, errors = merge_striped_rows(rows, error)
    return {k: [r[i + 1] for r in merged] for i, k in enumerate(RESULT_KEYS)}, errors


_PIL_MODE_DTYPES = {
    "L": np.uint8, "P": np.uint8, "RGB": np.uint8, "RGBA": np.uint8,
    "I;16": np.uint16, "I;16B": np.uint16, "I": np.int32, "F": np.float32,
}


def _probe_plate_geometry(img_paths):
    """(max_z, h, w, dtype) from header-only probes (one open per file), or
    None when some well needs a full decode to know its dims. Raises
    ValueError when wells differ in spatial size."""

    def _probe(path):
        probed = tio.probe_image_header(path)
        if probed is None:
            return None
        dims, mode = probed
        dtype = _PIL_MODE_DTYPES.get(mode)
        return None if dtype is None else (dims, dtype)

    max_z, hw, dtypes = 0, None, []
    for files in img_paths.values():
        if isinstance(files, (list, tuple)):
            d0 = None
            for pf in files:
                probed = _probe(pf)
                if probed is None:
                    return None
                d, dtype = probed
                dtypes.append(dtype)
                if d.T > 1 or d.C > 1 or d.Z > 1:
                    return None
                if d0 is None:
                    d0 = d
                elif (d.Y, d.X) != (d0.Y, d0.X):
                    return None
            z, h, w = len(files), d0.Y, d0.X
        else:
            probed = _probe(files)
            if probed is None:
                return None
            d, dtype = probed
            dtypes.append(dtype)
            if d.T > 1 or d.C > 1:
                return None
            z, h, w = d.Z, d.Y, d.X
        if hw is None:
            hw = (h, w)
        elif hw != (h, w):
            raise ValueError(f"wells differ in spatial size: {hw} vs {(h, w)}")
        max_z = max(max_z, z)
    return max_z, hw[0], hw[1], np.result_type(*dtypes)


def _well_loader(img_paths, decode_workers: int = 4, ahead: int = 8):
    """Yield (well_id, ZYX stack), with at most ``ahead`` decodes in flight."""

    def _load(files):
        img, _ = tio.load_image(files)
        return img[None] if img.ndim == 2 else img

    items = list(img_paths.items())
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        pending = deque()
        next_i = 0
        while next_i < len(items) or pending:
            while next_i < len(items) and len(pending) < ahead:
                wid, files = items[next_i]
                pending.append((wid, pool.submit(_load, files)))
                next_i += 1
            wid, fut = pending.popleft()
            yield wid, fut.result()


_MIXED_SIZE_HELP = (
    "process_plate requires same-size wells (padding smaller wells would bias "
    "their area denominator, GMM threshold and segmentation scale); run "
    "compute_cell_area / compute_branches per image for mixed-size inputs."
)


def main(args=None, argv=None, device: DeviceLike = None):
    """The plate CLI. ``device=None`` means CUDA."""
    maybe_initialize_from_env()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("in_root", type=str)
    p.add_argument("out_root", type=str)
    p.add_argument("--image-width-microns", type=float, required=True)
    p.add_argument("--model-cfg", type=str, default=None)
    p.add_argument("--sd-coef", type=float, default=0.0)
    p.add_argument("-w", "--detect-well", action="store_true")
    p.add_argument("-m", "--method", choices=("min", "max", "med", "avg", "fs"), default="max",
                   help="Z-projection method.")
    p.add_argument("--tta", type=int, choices=(1, 4, 8), default=None,
                   help="Dihedral test-time-augmentation variants of the tiled "
                        "UNet (default: the model config's 'tta' key, else 8).")
    if args is None:
        args = p.parse_args(argv)
    else:
        # a namespace from the GUI: absent flags take the parser's defaults,
        # and the checks argparse would have made are made here
        for name in ("model_cfg", "sd_coef", "detect_well", "method", "tta"):
            if getattr(args, name, None) in (None, ""):
                setattr(args, name, p.get_default(name))
        for required in ("in_root", "out_root", "image_width_microns"):
            if getattr(args, required, None) in (None, ""):
                print(f"{SFM.failure} Missing required field: {required}", flush=True)
                sys.exit(2)
        if args.method not in ("min", "max", "med", "avg", "fs"):
            print(f"{SFM.failure} Invalid projection method: {args.method!r} "
                  "(choose from min/max/med/avg/fs)", flush=True)
            sys.exit(2)
        if args.tta and int(args.tta) not in (1, 4, 8):
            print(f"{SFM.failure} Invalid tta value: {args.tta!r} (choose 1, 4 or 8)", flush=True)
            sys.exit(2)
    dev = resolve_device(device)

    from tmat_torch.tools import args as su

    su.check_input_dir_structure(args.in_root)
    img_paths = su.resolve_image_paths(args.in_root)
    su.verify_output_dir(args.out_root)

    section_header("Loading plate")
    # each process runs its stripe of the wells; the geometry is probed on
    # every well, so every process pads as one process would
    su.check_striped_discovery(list(img_paths))
    indexed = stripe(enumerate(img_paths.items()))
    global_idxs = [i for i, _ in indexed]
    my_paths = {wid: files for _, (wid, files) in indexed}
    well_ids = list(my_paths)
    try:
        plate_zhw = _probe_plate_geometry(img_paths)
    except ValueError as e:
        print(f"{SFM.failure} {e}. {_MIXED_SIZE_HELP}", flush=True)
        sys.exit(1)

    model_cfg = args.model_cfg
    if not model_cfg:
        from tmat_torch.models.registry import get_last_exp_num

        cfg_dir = Path(defs.model_training_path("binary_segmentation")) / "configs"
        model_cfg = str(cfg_dir / f"unet_patch_segmentor_{get_last_exp_num()}.json")
    segmentor = get_unet_patch_segmentor_from_cfg(model_cfg, device=dev)
    if args.tta:
        segmentor.tta = int(args.tta)
    config = {"image_width_microns": args.image_width_microns}

    section_header("Processing plate")
    start = time.perf_counter()
    common = dict(sd_coef=args.sd_coef, detect_well=args.detect_well, proj_method=args.method,
                  device=dev)
    if plate_zhw is None:
        # buffered: decode this process's wells, and pad them to the
        # geometry and type of the whole plate, as one process would
        stacks = []
        for wid in well_ids:
            img, _ = tio.load_image(my_paths[wid])
            stacks.append(img[None] if img.ndim == 2 else img)
        parts = gather_objects([(s.shape, s.dtype.str) for s in stacks])
        shapes = [shape for part in parts for shape, _ in part]
        hw_set = {shape[1:] for shape in shapes}
        if len(hw_set) > 1:
            print(f"{SFM.failure} wells differ in spatial size: {sorted(hw_set)}. "
                  f"{_MIXED_SIZE_HELP}", flush=True)
            sys.exit(1)
    stripe_error = None
    with maybe_profile("plate"):  # a trace under $TMAT_TORCH_PROFILE_DIR/plate, if set
        try:
            if plate_zhw is not None:
                results = run_plate_streaming(
                    _well_loader(my_paths), len(well_ids), plate_zhw[:3], segmentor, config,
                    plate_dtype=plate_zhw[3], **common,
                )
            else:
                (h, w), = hw_set
                max_z = max(shape[0] for shape in shapes)
                dtype = np.result_type(*[np.dtype(d) for part in parts for _, d in part])
                plate = np.zeros((len(stacks), max_z, h, w), dtype)
                for i, s in enumerate(stacks):
                    plate[i, : s.shape[0]] = s
                results = run_plate(plate, well_ids, segmentor, config,
                                    z_counts=[s.shape[0] for s in stacks], **common)
        except Exception as e:  # a well that does not decode, ...
            if not is_multiprocess():
                raise
            # fail together after the row gather: raising alone would leave the
            # peers waiting in it
            traceback.print_exc()
            stripe_error = f"process {process_index()}: {e}"
            results = {k: [] for k in RESULT_KEYS}
    elapsed = time.perf_counter() - start
    timer = results.pop("_timer", None)
    if timer is not None:
        print(timer.report(), flush=True)
    print(f"{SFM.success} {len(well_ids)} wells in {elapsed:.1f}s "
          f"({len(well_ids) / elapsed:.2f} wells/sec)", flush=True)

    results, errors = merge_plate_results(results, global_idxs, stripe_error)
    if errors:
        for e in errors:
            print(f"{SFM.failure} {e}", flush=True)
        sys.exit(1)
    if is_primary():
        out_csv = Path(args.out_root) / "plate_results.csv"
        with open(out_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(list(results))
            for row in zip(*results.values()):
                writer.writerow(row)
        print(f"Results saved to {out_csv}", flush=True)
    section_footer()


if __name__ == "__main__":
    main()
