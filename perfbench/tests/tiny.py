"""A temporary copy of the benchmark with tiny cells, for the CPU tests.

``tiny_copy(tmp)`` copies ``BENCHMARK.json`` and ``perfbench/`` into
``tmp`` and adds, as new files and entries only (what a later change may
do), two configurations with seeded weights written in the shipped
checkpoints' format (a UNet-Xception of widths 8-64 at patch 32, and two
ResNet50 members to ``conv2_block3_out`` at 32 px), a tiny cell of each
real cell with its limits (``tiny_plate``, ``tiny_inv``, ``tiny_fs``: two
192 px disc wells of depths 3 and 2 of 3), the plate cell with a generator
(``traffic/tiny_plate.py``) and a reference module of its own, and a
dummy per-layer metric. The
harness then runs them on the CPU through ``harness.Run`` and
``harness.measure``: everything of a run but the look for a card.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

GENERATOR = '''"""tiny_plate's own generator: the vessel wells, one plate fewer."""

from perfbench.inputs import vessels


def make(seed, traffic, device="cpu"):
    pool = vessels.well_pool(seed, traffic["pool_wells"], traffic["size"], traffic["z"], device)
    return vessels.plates(pool, seed, traffic["cycle_plates"] - 1, traffic["wells_per_plate"], device)
'''

REFERENCE = '''"""A reference module added by name: the plate reference as it is."""

from perfbench.reference.segment import *  # noqa: F401,F403
'''

DUMMY_METRIC = '''"""plates_seen: plates the window ran (a test's metric)."""


def read(run):
    return run.driver.counters.get("plates")
'''


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def tiny_copy(tmp: Path) -> dict:
    """The copy's BENCHMARK.json (as a dict), with cells ``tiny_plate``,
    ``tiny_inv`` and ``tiny_fs`` and metric ``plates_seen`` added."""
    import torch
    from tmat_torch.models.layers import flax_variables
    from tmat_torch.models.params_io import save_params
    from tmat_torch.models.resnet import build_trainable_resnet50_tl
    from tmat_torch.models.unet import build_unet_xception

    tmp = Path(tmp)
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    pb = tmp / "perfbench"
    bench = json.loads((tmp / "BENCHMARK.json").read_text())

    torch.manual_seed(0)
    unet = build_unet_xception(1, (32, 32), 1, (8, 16, 32, 64), seed=3, device="cpu")
    save_params(tmp / "weights" / "tiny_unet.msgpack", flax_variables(unet))
    seg = json.loads((pb / "configs" / "unet_xception_seg_bf16.json").read_text())
    seg.update(checkpoint="weights/tiny_unet.msgpack", patch_size=32, filter_counts=[8, 16, 32, 64],
               ds_ratio=0.5, dtype="float32", reduced=["patch_size", "filter_counts"])
    _write(pb / "configs" / "tiny_seg.json", seg)

    from perfbench.inputs.invasion import invasion_stacks
    from perfbench.reference.resnet import prep

    ens = tmp / "weights" / "ens"
    sample = torch.cat([prep(s, (32, 32), "cpu") for s in invasion_stacks(1, 2, 3, 64)])
    for i in range(2):
        m = build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=i, device="cpu").eval()
        v = flax_variables(m)
        # a random head centred on the sample's features, so that the
        # probabilities spread over (0, 1) (a zero head gives 0.5 everywhere)
        with torch.no_grad():
            feats = m.base_model(sample).mean(dim=(1, 2)).numpy()
        k = (np.random.RandomState(i).randn(feats.shape[1], 1) * 0.02).astype(np.float32)
        v["params"]["head"]["kernel"] = k
        v["params"]["head"]["bias"] = -(feats.mean(axis=0) @ k).astype(np.float32)
        save_params(ens / f"best_finetune_weights_{i}.msgpack", v)
        (ens / f"best_model_history_{i}.csv").write_text(f"val_loss,training_stage\n{0.5 - 0.1 * i},finetune\n")
    res = json.loads((pb / "configs" / "resnet50_inv_ensemble_bf16.json").read_text())
    res.update(ensemble_dir="weights/ens", last_layer="conv2_block3_out", input_shape=[32, 32, 3],
               n_models=2, n_pred_models=2, dtype="float32")
    _write(pb / "configs" / "tiny_res.json", res)

    plate = json.loads((pb / "traffic" / "plate_max.json").read_text())
    plate.update(size=64, z=3, wells_per_plate=2, pool_wells=3, cycle_plates=3, trace_plates=[1, 1],
                 check_plate_rate=0.5, reference="tiny_segment")
    _write(pb / "traffic" / "tiny_plate.json", plate)
    fs = json.loads((pb / "traffic" / "plate_fs_well.json").read_text())
    fs.update(size=192, z=3, wells_per_plate=2, pool_wells=3, cycle_plates=3, trace_plates=[1, 1],
              check_plate_rate=0.5)
    fs["run_plate"]["z_counts"] = [3, 2]
    fs["well"].update(rim_sigma=2.0, regions=3, sharp_below=2)
    _write(pb / "traffic" / "tiny_fs.json", fs)
    shutil.copy(pb / "traffic" / "plate_fs_well.py", pb / "traffic" / "tiny_fs.py")
    (pb / "traffic" / "tiny_plate.py").write_text(GENERATOR)
    (pb / "reference" / "tiny_segment.py").write_text(REFERENCE)
    inv = json.loads((pb / "traffic" / "inv_depth_1024.json").read_text())
    inv.update(size=64, z=3, cycle_stacks=3, warm_stacks=2, check_stacks=2, trace_stacks=[1, 2],
               check_stack_rate=1.0)
    _write(pb / "traffic" / "tiny_inv.json", inv)
    shutil.copy(pb / "limits" / "plate_max.json", pb / "limits" / "tiny_plate.json")
    shutil.copy(pb / "limits" / "plate_fs_well.json", pb / "limits" / "tiny_fs.json")
    shutil.copy(pb / "limits" / "inv_depth_1024.json", pb / "limits" / "tiny_inv.json")
    (pb / "metrics" / "plates_seen.py").write_text(DUMMY_METRIC)

    bench["configs"] += [
        {"name": "tiny_seg", "source": "https://keras.io/examples/vision/oxford_pets_image_segmentation/",
         "file": "perfbench/configs/tiny_seg.json", "reduced": ["patch_size", "filter_counts"], "why": "test"},
        {"name": "tiny_res", "source": "https://arxiv.org/abs/1512.03385",
         "file": "perfbench/configs/tiny_res.json", "reduced": ["last_layer"], "why": "test"}]
    bench["workloads"] += [
        {"name": "tiny_plate", "config": "tiny_seg", "traffic": "tiny_plate", "chips": 1, "why": "test"},
        {"name": "tiny_inv", "config": "tiny_res", "traffic": "tiny_inv", "chips": 1, "why": "test"},
        {"name": "tiny_fs", "config": "tiny_seg", "traffic": "tiny_fs", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("plate_max", "tiny_plate"), ("inv_depth_1024", "tiny_inv"),
                           ("plate_fs_well", "tiny_fs")):
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    bench["per_layer"].append({"name": "plates_seen", "unit": "plates", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves": "wells_per_s",
                               "workloads": ["tiny_plate"]})
    _write(tmp / "BENCHMARK.json", bench)
    return bench


def run_tiny(tmp: Path, bench: dict, cell: str, seed: int = 2**33 + 7, seconds: float = 1.5,
             trace: bool = False, control: str = "", fault=None) -> dict:
    """One CPU run of a tiny cell of the copy at ``tmp``; ``fault(run)``
    may break the timed path after set-up."""
    import time

    import torch
    from perfbench import harness

    c = harness.Cell(bench, cell, Path(tmp) / "perfbench")
    run = harness.Run(c, seed, seconds, trace, torch.device("cpu"), control=control)
    try:
        if fault is not None:
            setup = run.driver.setup

            def broken_setup():
                setup()
                fault(run)

            run.driver.setup = broken_setup
        return harness.measure(run, time.time())
    finally:
        run.close()
