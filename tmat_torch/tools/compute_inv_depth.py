"""Predict depths of invasion in input directory of Z-stacks or Z-projections.

Counterpart of ``tmat_tpu/tools/compute_inv_depth.py``: an ensemble of
ResNet50 classifiers predicts, for every Z slice of each stack, the
probability of invasion; the members' mean, rounded to 4 decimals, is
thresholded at ``cls_thresh``. Same flags, prints, exit codes and CSV
(``invasion_depth_predictions.csv``: Z Slice ID / Invasion Probability /
Invasion Prediction (0=no 1=yes)). Under torchrun each process predicts a
round-robin stripe of the stacks and the primary writes the CSV from
every process's rows (``parallel/distributed.py``).

The ensemble's hp file (``invasion_depth_best_hp.json``) may name its
backbone under the key ``backbone`` (``BACKBONES``): ``"resnet50"``, the
default (Flax checkpoints ``best_finetune_weights_<i>.msgpack``, truncated
at ``last_resnet_layer``), or ``"swinv2_base_window16_256"`` (SwinV2,
``models/swin.py``: ``torch.save``d state dicts
``best_finetune_weights_<i>.pt``, their sizes read from them; the port has
no trainer for them yet). The members carry their backbone, so the rest
of the tool takes either kind: each backbone's prep tail (``PREP_TAILS``)
follows the shared resize.

Each raw stack is uploaded once and everything runs on the device: the
Lanczos-4 resize (``ops/resize_lanczos4.py``, a CUDA kernel on the card,
its plain version on the CPU; the function of ``models/preprocess.py::
host_resize``), the prep tail and the members' forwards, one after another
on one stream. On the card every member loaded here, of either backbone,
replays its features from one CUDA graph of 8 slices captured at load
(``models/graphed.py``), ``ceil(Z/8)`` replays a stack, and runs its head
eagerly; on the CPU the members run eagerly. At most ``MAX_IN_FLIGHT``
stacks are queued on the device before the oldest is fetched, so the host
loads and dispatches the next stacks while the device works
(``predict_rows``). The file-free core is ``predict_stack``.

Stages, all by the host clock (none calls a synchronise): ``host_resize``,
the host's share of the resize (the upload of the raw stack, a blocking
copy that starts once the work queued before it is done, and the kernel's
launch; on the CPU, the whole resize), ``dispatch`` (the prep
tail and the members' forwards as the host enqueues them, counting each
member's graph replays, ``graph_replays``, or its eager forward,
``eager_forwards``; inside it, a SwinV2 member's forward is the stage
``swin_forward``, which counts its attention calls and windows,
``attn_calls`` and ``attn_windows``) and
``fetch_wait`` (the host blocked in the copy of a stack's probabilities
back). While a ``torch.profiler`` records on the thread that calls
``predict_rows``, they are also spans of their stack
(``core/profiling.py``); a ``host_resize`` span on the card counts the
kernel's launch (``resize_launches``).

Usage:
    python -m tmat_torch.tools.compute_inv_depth IN_DIR OUT_DIR [-c CONFIG]
"""

from __future__ import annotations

import csv
import json
import os
import sys
from collections import deque
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tmat_torch.core import defs, io as tio
from tmat_torch.core.log import SFM, section_footer, section_header
from tmat_torch.core.profiling import StageTimer, maybe_profile, profiler_active, traced
from tmat_torch.device import DeviceLike, default_dtype, resolve_device
from tmat_torch.models.params_io import from_flax_resnet_variables, load_variables
from tmat_torch.models import swin
from tmat_torch.models.preprocess import imagenet_prep_tail, prep_tail
from tmat_torch.models.resnet import ResNet50TL, build_resnet50_tl, ensemble_forward, load_member
from tmat_torch.ops.resize_lanczos4 import resize_lanczos4
from tmat_torch.parallel.distributed import (
    is_multiprocess, is_primary, maybe_initialize_from_env, merge_striped_rows, process_index, stripe)
from tmat_torch.tools import args as su

DEFAULT_CONFIG_NAME = "default_invasion_depth_computation.json"
MAX_IN_FLIGHT = 8
RESIZE_DTYPES = (np.uint8, np.uint16, np.float32)  # the resize kernel's
ID_COL = "Z Slice ID"
PROB_COL = "Invasion Probability"
PRED_COL = "Invasion Prediction (0=no 1=yes)"
# backbone -> the suffix of its members' checkpoints
BACKBONES = {"resnet50": ".msgpack", swin.BACKBONE: ".pt"}
# member class -> what turns resized slices into its inputs
PREP_TAILS = {ResNet50TL: prep_tail, swin.SwinV2TL: imagenet_prep_tail}


def _rank_models_by_history(ensemble_dir: Path, n_models: int) -> np.ndarray:
    """Members ordered by their best fine-tune val_loss; identity order
    when no history is there."""
    best_val_losses = np.full(n_models, np.inf)
    for i in range(n_models):
        hist = ensemble_dir / f"best_model_history_{i}.csv"
        if not hist.is_file():
            continue
        with open(hist) as fp:
            rows = [r for r in csv.DictReader(fp) if r.get("training_stage") == "finetune"]
        if rows:
            best_val_losses[i] = min(float(r["val_loss"]) for r in rows)
    if np.isinf(best_val_losses).all():
        return np.arange(n_models)
    return best_val_losses.argsort()


def load_ensemble(checkpoints: Sequence[Path], img_shape: Tuple[int, int, int], last_layer: Optional[str],
                  dtype: Optional[torch.dtype] = None, device: DeviceLike = None,
                  backbone: str = "resnet50") -> List[torch.nn.Module]:
    """One classifier per checkpoint of ``backbone`` (``BACKBONES``; the
    module doc), on ``device`` (None = CUDA), in ``dtype`` (default:
    bfloat16 on CUDA, float32 on the CPU), its features captured as a CUDA
    graph on CUDA (``models/graphed.py``). ``last_layer`` is ResNet50's."""
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}: one of {sorted(BACKBONES)}")
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    members = []
    for ckpt in checkpoints:
        if backbone == swin.BACKBONE:
            members.append(swin.load_member(ckpt, img_shape, dtype, dev))
            continue
        model = build_resnet50_tl(1, img_shape, last_layer, dtype=dtype, init="zeros", device=dev)
        members.append(load_member(model, from_flax_resnet_variables(load_variables(ckpt))).capture())
    return members


def resize_stack(stack: np.ndarray, img_hw: Tuple[int, int], dev: torch.device) -> torch.Tensor:
    """``host_resize``'s (Z, h, w) slices of a (Z, H, W) or (H, W) stack, on
    ``dev``: the raw stack uploaded once, pageable (pinning a fresh buffer
    for each stack costs more than the copy), and resized there. A dtype
    the resize does not take goes up as float32, as the host resize
    computes it; an integer one is then rounded and clipped to its range."""
    arr = np.ascontiguousarray(stack)
    if arr.dtype in RESIZE_DTYPES:
        return resize_lanczos4(torch.from_numpy(arr).to(dev), img_hw)
    resized = resize_lanczos4(torch.from_numpy(arr.astype(np.float32)).to(dev), img_hw)
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        resized = resized.round().clamp_(info.min, info.max)
    return resized


def dispatch_stack(stack: np.ndarray, ensemble: Sequence[torch.nn.Module], img_hw: Tuple[int, int],
                   timer: Optional[StageTimer] = None) -> torch.Tensor:
    """Queue one (Z, H, W) or (H, W) stack on the ensemble's device:
    (k, Z, 1) member probabilities, still on the device. The members'
    backbone picks the prep tail (``PREP_TAILS``)."""
    dev = next(ensemble[0].parameters()).device
    timer = timer or StageTimer()
    with timer.stage("host_resize"):
        resized = resize_stack(stack, img_hw, dev)
    with timer.stage("dispatch"):
        return ensemble_forward(ensemble, PREP_TAILS[type(ensemble[0])](resized), timer)


def predict_stack(stack: np.ndarray, ensemble: Sequence[torch.nn.Module],
                  img_hw: Tuple[int, int]) -> np.ndarray:
    """(k, Z, 1) float32 member probabilities of one stack's slices, on the
    host."""
    return dispatch_stack(stack, ensemble, img_hw).cpu().numpy()


def stack_rows(stack_id: str, member_probs: np.ndarray, cls_thresh: float) -> List[Dict]:
    """The CSV rows of one stack: the members' mean taken on the host in
    float32, rounded to 4 decimals, thresholded after rounding."""
    mean = np.asarray(member_probs).mean(axis=0).squeeze(-1)
    rows = []
    for z in range(len(mean)):
        prob = round(float(mean[z]), 4)
        rows.append({ID_COL: f"{stack_id}_z{z}", PROB_COL: prob, PRED_COL: int(prob > cls_thresh)})
    return rows


def predict_rows(stacks: Iterable[Tuple[str, np.ndarray]], ensemble: Sequence[torch.nn.Module],
                 img_hw: Tuple[int, int], cls_thresh: float,
                 timer: Optional[StageTimer] = None) -> List[Dict]:
    """The CSV rows of each ``(id, stack)`` in turn. At most MAX_IN_FLIGHT
    stacks wait on the device: the host dispatches the next ones meanwhile."""
    rows: List[Dict] = []
    pending: deque = deque()
    timer = timer or StageTimer()

    def collect_one():
        stack_id, yhat, on = pending.popleft()
        with traced(on, stack_id), timer.stage("fetch_wait"):
            probs = yhat.cpu()
        rows.extend(stack_rows(stack_id, probs.numpy(), cls_thresh))

    for stack_id, stack in stacks:
        on = profiler_active()  # once per stack, on this thread (module doc)
        with traced(on, stack_id):
            pending.append((stack_id, dispatch_stack(stack, ensemble, img_hw, timer), on))
        if len(pending) >= MAX_IN_FLIGHT:
            collect_one()
    while pending:
        collect_one()
    return rows


def main(args=None, argv=None, device: DeviceLike = None):
    """Predicts invasion for every Z slice and writes the CSV.
    ``device=None`` means CUDA."""
    maybe_initialize_from_env()
    default_config_path = str(defs.default_config_path(DEFAULT_CONFIG_NAME))
    if args is None:
        args = su.parse_inv_depth_args({"default_config_path": default_config_path}, argv)
    dev = resolve_device(device)

    su.check_input_dir_structure(args.in_root)

    try:
        su.verify_output_dir(args.out_root)
    except PermissionError as e:
        print(f"{SFM.failure} {e}", flush=True)
        sys.exit(1)

    section_header("Loading Classifier")

    with open(defs.model_training_path("invasion_depth_best_hp.json")) as fp:
        best_hp = json.load(fp)
    with open(defs.model_training_path("invasion_depth_training_values.json")) as fp:
        training_values = json.load(fp)

    cls_thresh = training_values["cls_thresh"]
    resnet_inp_shape = tuple(training_values["resnet_inp_shape"])
    n_models = training_values["n_models"]
    backbone = best_hp.get("backbone", "resnet50")
    if backbone not in BACKBONES:
        print(f"{SFM.failure} Unknown backbone {backbone!r} in invasion_depth_best_hp.json: "
              f"one of {sorted(BACKBONES)}.", flush=True)
        sys.exit(1)
    last_resnet_layer = best_hp.get("last_resnet_layer")  # ResNet50's only

    # an explicit config from either entry path: the CLI flag or the GUI's field
    config_path = getattr(args, "config", None) or default_config_path
    try:
        config = su.verify_config_file(config_path)
    except FileNotFoundError as e:
        print(f"{SFM.failure} {e}", flush=True)
        sys.exit(1)
    n_pred_models = config["n_pred_models"]
    if n_pred_models > n_models:
        print(
            f"{SFM.failure} n_pred_models ({n_pred_models}) cannot exceed "
            f"n_models ({n_models}).",
            flush=True,
        )
        sys.exit(1)

    ensemble_dir = Path(defs.model_training_path("best_ensemble"))
    ranked = _rank_models_by_history(ensemble_dir, n_models)

    ensemble = []
    for i in range(n_pred_models):
        ckpt = ensemble_dir / f"best_finetune_weights_{int(ranked[i])}{BACKBONES[backbone]}"
        if not ckpt.is_file():
            print(
                f"{SFM.failure} Ensemble checkpoint not found: {ckpt}\n"
                f"{SFM.info} Train the ensemble with "
                f"{SFM.highlight('python -m tmat_torch.models.train_invasion')} "
                "or place converted checkpoints in that directory.",
                flush=True,
            )
            sys.exit(1)
        print(f"Loading classifier {i}...", flush=True)
        ensemble += load_ensemble([ckpt], resnet_inp_shape, last_resnet_layer, device=dev, backbone=backbone)
        print(f"... Classifier {i} loaded.", flush=True)

    print("All classifiers loaded.", flush=True)
    print(SFM.success, flush=True)
    section_footer()

    section_header("Making Predictions")

    zstack_paths = su.resolve_image_paths(args.in_root)
    if not zstack_paths:
        print(f"{SFM.failure} No Z stacks found in {args.in_root}", flush=True)
        sys.exit(1)

    # each process predicts its stripe; the primary writes every process's
    # rows in discovery order
    su.check_striped_discovery(list(zstack_paths))
    row_owners: List[int] = []  # the global index of each row's stack
    stripe_error = None

    def load_stacks():
        nonlocal stripe_error
        for gidx, (zstack_id, zstack_path) in stripe(enumerate(zstack_paths.items())):
            print(f"Processing {zstack_id}...", flush=True)
            try:
                img, _ = tio.load_image(zstack_path, args.time, args.channel)
            except OSError as error:
                print(f"{SFM.failure}{error}", flush=True)
                if is_multiprocess():
                    # fail together after the row gather: exiting alone
                    # would leave the peers waiting in it
                    stripe_error = f"process {process_index()}: {error}"
                    return
                sys.exit(1)
            img = np.asarray(img)
            row_owners.extend([gidx] * (1 if img.ndim == 2 else len(img)))
            yield zstack_id, img

    with maybe_profile("inv_depth"):  # a trace under $TMAT_TORCH_PROFILE_DIR/inv_depth, if set
        rows = predict_rows(load_stacks(), ensemble, resnet_inp_shape[:-1], cls_thresh)
    merged, errors = merge_striped_rows(list(zip(row_owners, rows)), stripe_error)
    if errors:
        for e in errors:
            print(f"{SFM.failure} {e}", flush=True)
        sys.exit(1)

    if is_primary():
        print("Saving results...", flush=True)
        out_csv_path = os.path.join(args.out_root, "invasion_depth_predictions.csv")
        out_csv_path = tio.get_unique_output_filepath(out_csv_path)
        with open(out_csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=[ID_COL, PROB_COL, PRED_COL])
            writer.writeheader()
            writer.writerows(row for _, row in merged)
        print("... Results saved.", flush=True)
    print(SFM.success, flush=True)
    section_footer()


if __name__ == "__main__":
    main()
