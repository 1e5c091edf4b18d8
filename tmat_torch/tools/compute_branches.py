"""Analyze microvessels in a directory of Z stacks or Z projections.

Counterpart of ``tmat_tpu/tools/compute_branches.py``: branch counts and
lengths of 2-D images (the UNet patch segmentor, through the down-block
kernel on the card) or of Z stacks (multi-scale Sato vesselness), through
a discrete Morse graph. Same flags, CSV contract (UTF-16
``branching_analysis{tag}[-N].csv``, one per graph-threshold sweep
config), visualization PNGs and exit codes; single process.

The device work is ``analyze_branches``, which takes an array and returns
the CSV rows per sweep tag and the visualization rasters, touching no
file; ``analyze_img`` loads a file, calls it and writes the outputs.

- 2-D: lanczos4 resize to the segmentor's ``ds_ratio`` and [0, 1] stretch
  (head), the tiled UNet, the disk(2) median and component filter, then
  the centreline-relative distance weighting, the downsample to 384 px
  wide and the [0, 255] stretch (tail).
- 3-D: per-slice Gaussian blur, linear resize to 384 px wide, [0, 1]
  stretch, pairwise slice maxima, Sato over 10 scales, N-D unsharp mask,
  the max over Z, Canny and skeleton (vesselness head); the eccentricity
  x diameter filter of the skeleton on the host; three masked blurs, a
  10-step region expansion, edge removal and a disk(2) closing (middle);
  the component filter; the dilation, re-masking, blur and stretch (tail).
  Convolutions of the 3-D path run without TF32.
- Statistics: the Python ``MorseGraph`` (with its barcode and tree plots),
  or with ``--no-vis`` the native Morse engine; the CSVs are identical.

Not ported: the multi-process striping and the AOT executable cache.

Usage:
    python -m tmat_torch.tools.compute_branches IN_DIR OUT_DIR \
        --image-width-microns 1200 [-w] [--no-vis] [--graph-thresh-1 2 8]
"""

from __future__ import annotations

import csv
import json
import os
import sys
from dataclasses import dataclass, field
from itertools import product
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tmat_torch.core import defs, io as tio
from tmat_torch.core.config import load_tool_config, merge_cli_overrides
from tmat_torch.core.log import SFM, section_footer, section_header
from tmat_torch.core.profiling import StageTimer
from tmat_torch.device import DeviceLike, resolve_device
from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg
from tmat_torch.ops import morphology as morph
from tmat_torch.ops.canny import canny
from tmat_torch.ops.distance import edt_batch
from tmat_torch.ops.filters import gaussian, unsharp_mask_nd
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import resize, target_shape_for_ratio
from tmat_torch.ops.sato import sato
from tmat_torch.ops.wellmask import make_well_mask
from tmat_torch.tools import args as su
from tmat_torch.topo import regionprops as rp
from tmat_torch.topo.morse import MorseGraph
from tmat_torch.topo.morse_native import morse_stats_native
from tmat_torch.topo.transforms import filter_branch_seg_mask

DEFAULT_CONFIG_NAME = "default_branching_computation.json"
DOWNSAMPLE_WIDTH = 384
CSV_FIELDS = ["Image", "Total # of branches", "Total branch length (µm)",
              "Average branch length (µm)"]


def create_output_csv(output_file: Path) -> None:
    """A UTF-16 CSV holding the header row."""
    with open(output_file, "w", encoding="utf-16") as f:
        csv.writer(f, lineterminator="\n").writerow(CSV_FIELDS)


def append_csv_row(output_dir: Path, tuned_str: str, fields: list, created_csv_files: set) -> None:
    """Append one result row to the sweep config's UTF-16 CSV.

    Rows land in the first ``branching_analysis{tag}[-N].csv`` (N = 2, 3,
    ...) that either this run already opened or does not exist yet: a CSV
    from an earlier run is never appended to, it gets a suffixed sibling.
    """

    def candidates():
        yield output_dir / f"branching_analysis{tuned_str}.csv"
        n = 2
        while True:
            yield output_dir / f"branching_analysis{tuned_str}-{n}.csv"
            n += 1

    for path in candidates():
        ours = str(path) in created_csv_files
        if ours or not path.is_file():
            break
    if not ours:
        create_output_csv(path)
        created_csv_files.add(str(path))

    with open(path, "a", encoding="utf-16") as f:
        csv.writer(f, lineterminator="\n").writerow(fields)

    print(f"Results saved to {path}.", flush=True)


def save_vis(img, save_dir, filename) -> None:
    """Stretch ``img`` onto [0, 255] and save it as a uint8 PNG."""
    img = rescale_intensity(torch.as_tensor(np.asarray(img, np.float32)), (0, 255)).numpy()
    file = tio.get_unique_output_filepath(os.path.join(str(save_dir), filename))
    tio.save_image(file, img.astype(np.uint8))


def pixels_to_microns(num_pixels, im_width_px, im_width_microns):
    return (im_width_microns / im_width_px) * num_pixels


def microns_to_pixels(num_microns, im_width_px, im_width_microns):
    return (im_width_px / im_width_microns) * num_microns


def _f32_convs():
    """Convolutions in full float32 (no TF32 on the card) inside the block."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """out[i, j] = x[i + dr, j + dc]; outside the frame ``fill`` (no wraparound)."""
    h, w = x.shape
    padded = x.new_full((h + 2, w + 2), fill)
    padded[1:-1, 1:-1] = x
    return padded[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w]


def _region_expansion(mask: torch.Tensor, vessels: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Gradient-guided region expansion of a 2-D mask over ``vessels``.

    Each step marks a pixel when some 8-neighbour in the mask is not
    brighter than it (hi) and none is brighter (lo), where vessels > 0.01.
    The compares against the 8 shifted rasters do not change between
    steps and are made once; a neighbour outside the frame is in no mask.
    """
    m = mask.to(torch.bool)
    offsets = [p for p in product((-1, 0, 1), repeat=2) if p != (0, 0)]
    # the source pixel of destination (i, j) is (i - r, j - c)
    lt = [vessels < _shift2d(vessels, -r, -c, 0.0) for r, c in offsets]
    eligible = vessels > 0.01
    for _ in range(iters):
        lo = torch.zeros_like(m)
        hi = torch.zeros_like(m)
        for (r, c), lt_k in zip(offsets, lt):
            src = _shift2d(m, -r, -c, False)
            lo |= src & lt_k
            hi |= src & ~lt_k
        m = m | (eligible & hi & ~lo)
    return m


def _stack_vesselness(stack: torch.Tensor, target_shape: Tuple[int, int]):
    """Vesselness head of the 3-D path on a (Z, H, W) stack: (vessels,
    Canny edges, their skeleton), each (h, w) at ``target_shape``."""
    with _f32_convs():
        x = gaussian(stack.float(), sigma=1.0, mode="nearest")
        x = resize(x, target_shape, "linear")
        x = rescale_intensity(x, out_range=(0, 1))
        pairs = torch.maximum(x[:-1], x[1:])
        sharp = unsharp_mask_nd(sato(pairs), 2.0, 2.0)
        vessels = sharp.amax(dim=0)
    edges = canny(vessels, sigma=0)
    skel = morph.skeletonize(edges[None])[0]
    return vessels, edges, skel


def _stack_expand(mask: torch.Tensor, vessels: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Middle of the 3-D path: three masked blurs of ``vessels``, the
    region expansion, edge removal and a disk(2) closing."""
    mask = mask.to(torch.bool)
    with _f32_convs():
        for _ in range(3):
            vessels = torch.where(mask, gaussian(vessels, 1.0, mode="nearest"), vessels)
    m = _region_expansion(mask, vessels, iters=10)
    m = m & ~edges.to(torch.bool)
    return morph.binary_closing(m, morph.disk(2))


def _stack_final(vessels_mask: torch.Tensor, vessels: torch.Tensor) -> torch.Tensor:
    """Tail of the 3-D path: vesselness inside the 3x3-dilated mask,
    blurred and stretched onto [0, 255] for the Morse stage."""
    out = torch.where(morph.binary_dilation(vessels_mask.to(torch.bool), morph.square(3)),
                      vessels, 0.0)
    with _f32_convs():
        blurred = gaussian(out, 1.0, mode="nearest")
    return rescale_intensity(blurred, out_range=(0, 255))


def _branch2d_head(raw_img: torch.Tensor, target_shape: Tuple[int, int]):
    """lanczos4 resize to ``target_shape`` and the [0, 1] stretch: (resized
    float32, rescaled); the first feeds the PNG, the second the segmentor."""
    resized = resize(raw_img.float(), tuple(target_shape), "lanczos4")
    return resized, rescale_intensity(resized, out_range=(0, 1))


def _branch2d_tail(seg_mask: torch.Tensor, pred: torch.Tensor, dsamp_res: Tuple[int, int]):
    """Centreline-relative distance weighting pred * dist / (dist + cdt),
    the linear downsample to ``dsamp_res`` and the [0, 255] stretch:
    (weighted, analysis)."""
    skel, dist = morph.medial_axis(seg_mask.to(torch.bool), return_distance=True)
    cdt = edt_batch(~skel[None])[0]
    rel = dist / torch.clamp(dist + cdt, min=1e-12)
    weighted = pred * rel
    analysis = resize(weighted, tuple(dsamp_res), "linear")
    return weighted, rescale_intensity(analysis, out_range=(0, 255))


def _ecc_diameter_filter(skel_np: np.ndarray, thresh: float = 3.5) -> np.ndarray:
    """Drop skeleton components whose eccentricity x equivalent diameter
    is at most ``thresh`` (one labeling pass for both properties)."""
    labels, n = rp.label(skel_np)
    if n == 0:
        return np.zeros_like(skel_np)
    props = rp.region_properties(labels, n, props=("eccentricity", "equivalent_diameter_area"))
    keep = props["eccentricity"] * props["equivalent_diameter_area"] > thresh
    lut = np.concatenate(([False], keep))
    return np.where(lut[labels], skel_np, 0)


def _pad_format(values) -> str:
    """Zero-padded format spec wide enough for every swept value."""
    if not all(isinstance(x, (int, float)) for x in values):
        return "{}"
    if all(isinstance(x, int) for x in values):
        digits = max(len(str(x)) for x in values)
        return f"{{:0{digits}d}}"
    as_text = [str(float(x)) for x in values]
    int_digits = max(t.index(".") for t in as_text)
    frac_digits = max(len(t) - t.index(".") - 1 for t in as_text)
    return f"{{:0{int_digits + 1 + frac_digits}.{frac_digits}f}}"


def sweep_configs(graph_thresh_1, graph_thresh_2) -> List[Tuple[str, dict]]:
    """(CSV tag, {"thresh1", "thresh2"}) for every combination of the two
    threshold sweeps. Swept (multi-value) parameters are zero-padded into
    the tag, so that sweep outputs sort lexicographically; a run without
    a sweep has the tag ""."""
    axes = {"thresh1": np.atleast_1d(graph_thresh_1).tolist(),
            "thresh2": np.atleast_1d(graph_thresh_2).tolist()}
    tuned = [k for k, v in axes.items() if len(v) > 1]
    fmt = {k: _pad_format(v) for k, v in axes.items()}
    out = []
    for combo in product(*axes.values()):
        cfg = dict(zip(axes, combo))
        tag = "".join(f"_{k}_{fmt[k].format(v)}" for k, v in cfg.items() if k in tuned)
        out.append((f"_CONFIG{tag}" if tag else "", cfg))
    return out


@dataclass
class BranchAnalysis:
    """What ``analyze_branches`` returns.

    ``rows``: (CSV tag, [n_branches, total_um, avg_um]) per sweep config,
    in sweep order. ``rasters``: name -> 2-D array of the visualization
    PNGs, in the order they are saved (only with ``save_vis``).
    ``graphs``: CSV tag -> the ``MorseGraph`` of that config (only with
    ``save_vis``). ``original_image`` and ``dsamp_res`` place the Morse tree
    over the image."""

    rows: List[Tuple[str, list]]
    rasters: Dict[str, np.ndarray] = field(default_factory=dict)
    graphs: Dict[str, MorseGraph] = field(default_factory=dict)
    original_image: Optional[np.ndarray] = None
    dsamp_res: Tuple[int, int] = (0, 0)


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` on ``dev``: uint8 and float32 as they are (cast on the
    device), other types as float32."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.float32):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(dev)


def analyze_branches(img: np.ndarray, model, config: dict, use_well_mask: bool = False,
                     device: DeviceLike = None, timer: Optional[StageTimer] = None
                     ) -> BranchAnalysis:
    """Branch statistics of one 2-D image (with ``model``, a patch
    segmentor on the same device) or (Z, H, W) stack (Sato path; ``model``
    unused). ``config`` holds ``image_width_microns`` and the branching
    keys of ``config/default_branching_computation.json``; ``save_vis``
    (default True) keeps the rasters and routes statistics through the
    Python ``MorseGraph``, else through the native engine. ``timer``
    accumulates the stages' host-clock time. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    timer = timer or StageTimer()
    img = np.asarray(img)
    image_width_microns = config.get("image_width_microns")
    if image_width_microns is None:
        raise ValueError("config['image_width_microns'] is required")
    vis = config.get("save_vis", True)
    rasters: Dict[str, np.ndarray] = {}
    n_dims = img.ndim
    img_dsamp_res = tuple(
        int(v) for v in np.round(np.multiply(img.shape[-2:], DOWNSAMPLE_WIDTH / img.shape[-1])).astype(int)
    )

    if n_dims == 3:
        original_image = img.max(0)
        if vis:
            rasters["original_image.png"] = original_image
        if use_well_mask:
            with timer.stage("well_mask"):
                small = resize(_upload(original_image, dev).float(), img_dsamp_res, "linear")
                original_dsamp = small.cpu().numpy()
                well_mask, shrunken = make_well_mask(original_dsamp, device=dev)
        else:
            well_mask = shrunken = np.full(img_dsamp_res, True)
        pruning_mask = np.logical_not(shrunken)

        with timer.stage("vesselness"):
            vessels, edges, skel = _stack_vesselness(_upload(img, dev), img_dsamp_res)
            skel_np = skel.cpu().numpy().astype(np.uint8)
        with timer.stage("ecc_filter"):
            mask_np = _ecc_diameter_filter(skel_np)
        with timer.stage("expand"):
            mask = torch.from_numpy(mask_np > 0).to(dev)
            vessels_mask = _stack_expand(mask, vessels, edges).cpu().numpy()
        with timer.stage("filter"):
            vessels_mask = filter_branch_seg_mask(vessels_mask.astype(np.uint8), None, False, device=dev)
        with timer.stage("final"):
            mask = torch.from_numpy(vessels_mask > 0).to(dev)
            analysis_img = _stack_final(mask, vessels).cpu().numpy()
        if vis:
            rasters["vesselness_image.png"] = analysis_img
    else:
        if model.device != dev:
            raise ValueError(f"the segmentor is on {model.device}, the analysis on {dev}")
        target_shape = target_shape_for_ratio(img.shape[:2], model.ds_ratio)
        with timer.stage("head"):
            resized, rescaled = _branch2d_head(_upload(img, dev), target_shape)
            original_image = resized.cpu().numpy()
            img = rescaled.cpu().numpy()
        if vis:
            rasters["original_image.png"] = original_image
        if use_well_mask:
            with timer.stage("well_mask"):
                well_mask, shrunken = make_well_mask(img, device=dev)
        else:
            well_mask = shrunken = np.full(img.shape[:2], True)
        pruning_mask = np.logical_not(shrunken)

        with timer.stage("unet"):
            pred = model.predict(img * well_mask, auto_resample=False)
        if vis:
            rasters["prediction.png"] = pred
        with timer.stage("filter"):
            seg_mask = filter_branch_seg_mask(((pred > 0.5) * well_mask).astype(np.uint8), device=dev)
            seg_mask = seg_mask.astype(float)
        with timer.stage("tail"):
            weighted, analysis = _branch2d_tail(torch.from_numpy(seg_mask > 0).to(dev),
                                                torch.from_numpy(pred).to(dev), img_dsamp_res)
            analysis_img = analysis.cpu().numpy()
            if use_well_mask:
                outside = torch.from_numpy(pruning_mask.astype(np.float32)).to(dev)
                pruning_mask = resize(outside, img_dsamp_res, "nearest").cpu().numpy() > 0
            else:
                pruning_mask = np.zeros(img_dsamp_res, bool)
        if vis:
            rasters["segmentation_mask.png"] = seg_mask
            rasters["distance_transform.png"] = weighted.cpu().numpy()

    if use_well_mask and vis:
        rasters["well_mask.png"] = np.asarray(well_mask) * 255

    width_px = analysis_img.shape[1]
    min_branch_length_px = round(
        microns_to_pixels(config.get("min_branch_length", 12), width_px, image_width_microns))
    max_branch_length = config.get("max_branch_length")
    max_branch_length_px = None
    if max_branch_length is not None:
        max_branch_length_px = round(
            max(1, microns_to_pixels(max_branch_length, width_px, image_width_microns)))
    smoothing_window_px = round(max(
        1, microns_to_pixels(config.get("graph_smoothing_window", 12), width_px, image_width_microns)))

    rows, graphs = [], {}
    for tuned_str, cfg in sweep_configs(config.get("graph_thresh_1", 5),
                                        config.get("graph_thresh_2", 10)):
        morse_kwargs = dict(
            thresholds=(cfg["thresh1"], cfg["thresh2"]),
            smoothing_window=smoothing_window_px,
            min_branch_length=min_branch_length_px,
            max_branch_length=max_branch_length_px,
            remove_isolated_branches=config.get("remove_isolated_branches", False),
            pruning_mask=pruning_mask,
        )
        with timer.stage("morse"):
            if vis:
                graph = graphs[tuned_str] = MorseGraph(analysis_img, **morse_kwargs)
                n_branches = len(graph.barcode)
                total_px = graph.get_total_branch_length()
                avg_px = graph.get_average_branch_length()
            else:
                n_branches, total_px, avg_px = morse_stats_native(analysis_img, **morse_kwargs)
        rows.append((tuned_str, [
            n_branches,
            pixels_to_microns(total_px, width_px, image_width_microns),
            pixels_to_microns(avg_px, width_px, image_width_microns),
        ]))
    return BranchAnalysis(rows, rasters, graphs, original_image, img_dsamp_res)


def _save_morse_vis(morse_graph, vis_dir, tuned_str, original_image, img_dsamp_res):
    """Barcode and Morse-tree overlay PNGs of one sweep config."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_path = tio.get_unique_output_filepath(str(vis_dir / f"barcode{tuned_str}.png"))
    plt.figure(figsize=(6, 6))
    plt.margins(0)
    ax = plt.gca()
    scaling_factor = original_image.shape[1] / img_dsamp_res[1]
    morse_graph.plot_colored_barcode(scaling_factor=scaling_factor, ax=ax)
    plt.savefig(save_path, dpi=300, bbox_inches="tight", pad_inches=0)

    save_path = tio.get_unique_output_filepath(str(vis_dir / f"morse_tree{tuned_str}.png"))
    fig_width = 10
    fig_height = fig_width * (original_image.shape[0] / original_image.shape[1])
    plt.figure(figsize=(fig_width, fig_height))
    plt.margins(0)
    ax = plt.gca()
    ax.imshow(rescale_intensity(torch.as_tensor(np.asarray(original_image, np.float32)),
                                out_range=(0, 255)).numpy(), cmap="gray")
    morse_graph.plot_colored_tree(scaling_factor=scaling_factor, ax=ax)
    plt.savefig(save_path, dpi=200, bbox_inches="tight", pad_inches=0)
    plt.close("all")


def analyze_img(
    img_id: str,
    img_files: Union[str, list],
    model,
    output_dir: Path,
    config: dict,
    created_csv_files: set,
    use_well_mask: bool = False,
    device: DeviceLike = None,
) -> None:
    """Measure branches in one image file (or slice sequence), save its
    visualizations and append its rows to the CSVs."""
    print("", flush=True)
    print("=========================================", flush=True)
    print(f"Analyzing {img_id}...", flush=True)
    print("=========================================", flush=True)

    img, pix_sizes = tio.load_image(img_files, config.get("time"), config.get("channel"))
    config = dict(config)
    if config.get("image_width_microns") is None:
        if pix_sizes.X is None:
            print(
                f"\n{SFM.failure} The --image-width-microns parameter was not "
                "specified, and the pixel to micron conversion factor was not "
                "found in the image metadata.\n"
                f"{SFM.info} {SFM.bold}Solution:{SFM.reset} Specify "
                "--image-width-microns and try again. Exiting...\n"
            )
            sys.exit(1)
        config["image_width_microns"] = img.shape[-1] * pix_sizes.X

    print("Processing slices..." if img.ndim == 3 else "\nSegmenting image...", flush=True)
    result = analyze_branches(img, model, config, use_well_mask, device)

    vis = config.get("save_vis", True)
    vis_dir = output_dir / "visualizations" / img_id
    if vis:
        vis_dir.mkdir(parents=True, exist_ok=True)
        for name, raster in result.rasters.items():
            save_vis(raster, vis_dir, name)
    for tuned_str, stats in result.rows:
        if img.ndim == 2:
            print("\nComputing graph and barcode...", flush=True)
        if vis:
            _save_morse_vis(result.graphs[tuned_str], vis_dir, tuned_str, result.original_image,
                            result.dsamp_res)
        print("\nComputing branch statistics...", flush=True)
        append_csv_row(output_dir, tuned_str, [img_id, *stats], created_csv_files)


def main(args=None, argv=None, device: DeviceLike = None):
    """The branches CLI. ``device=None`` means CUDA."""
    dev = resolve_device(device)
    default_config_path = str(defs.default_config_path(DEFAULT_CONFIG_NAME))

    if args is None:
        args = su.parse_branching_args({"default_config_path": default_config_path}, argv)
        config = load_tool_config(args.config, Path(default_config_path))
    else:
        config = {}

    args_dict = vars(args)
    config = merge_cli_overrides(
        config,
        args_dict,
        ("image_width_microns", "graph_thresh_1", "graph_thresh_2", "graph_smoothing_window",
         "min_branch_length", "max_branch_length", "remove_isolated_branches"),
    )

    model_cfg_path = args_dict.get("model_cfg_path") or config.get("model_cfg_path")
    if not model_cfg_path:
        cfg_dir = Path(defs.model_training_path("binary_segmentation")) / "configs"
        last_exp = 0
        for file in cfg_dir.glob("unet_patch_segmentor_*.json"):
            try:
                last_exp = max(last_exp, int(file.stem.split("_")[-1]))
            except ValueError:
                continue
        model_cfg_path = str(cfg_dir / f"unet_patch_segmentor_{last_exp}.json")

    if not Path(model_cfg_path).is_file():
        print(f"{SFM.failure}Model config file {model_cfg_path} does not exist.", flush=True)
        sys.exit(1)

    su.check_input_dir_structure(args.in_root)
    input_dir = Path(args.in_root)
    try:
        su.verify_output_dir(args.out_root)
    except PermissionError as error:
        print(f"{SFM.failure} {error}", flush=True)
        sys.exit(1)

    img_paths = su.resolve_image_paths(args.in_root)
    if len(img_paths) == 0:
        print(f"{SFM.failure}No images found in {input_dir}", flush=True)
        sys.exit(1)

    model = get_unet_patch_segmentor_from_cfg(model_cfg_path, device=dev)
    if args_dict.get("tta"):
        # a namespace built without argparse skips its choices: check again
        if int(args_dict["tta"]) not in (1, 4, 8):
            print(f"{SFM.failure} Invalid tta value: {args_dict['tta']!r} (choose 1, 4 or 8)",
                  flush=True)
            sys.exit(2)
        model.tta = int(args_dict["tta"])

    config["time"] = args.time
    config["channel"] = args.channel
    config["save_vis"] = not args_dict.get("no_vis", False)
    output_dir = Path(args.out_root)
    created_csv_files: set = set()

    section_header("Performing Analysis")
    for img_id, img_files in img_paths.items():
        analyze_img(img_id, img_files, model, output_dir, config, created_csv_files,
                    use_well_mask=args.detect_well, device=dev)

    cfg_path = tio.get_unique_output_filepath(output_dir / "config.json")
    with open(cfg_path, "w", encoding="utf8") as f:
        json.dump({k: v for k, v in config.items() if v is not None}, f, indent=4)

    print(f"{SFM.success} Analysis complete.", flush=True)
    section_footer()


if __name__ == "__main__":
    main()
