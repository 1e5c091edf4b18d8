"""Closed loop of plates through ``tools/plate_pipeline.py::run_plate``.

One client: plates from the traffic's generator (``inputs/<inputs>.py``)
back to back, each started only after the one before has returned, until
the window ends; every plate started in the window is finished. The
traffic's ``run_plate``, if any, holds further arguments of the call. Set-up
builds the segmentor as the CLI builds it
(``get_unet_patch_segmentor_from_cfg`` on the configuration), makes the
cycle of plates from the seed, and runs one plate to warm every shape.

The check: for ``check_plates`` plates drawn from the seed among the first
``check_plate_rate`` x seconds of the window, every well's row, and the
probabilities that the segmentor's prediction function returned for it
(copied to pinned host memory as they were made), against the traffic's
plain reference (``reference/<reference>.py``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench.inputs.vessels import seeded
from perfbench.work import block_work, unet_flops

ROW_KEYS = ("area_pct", "total_branches", "total_branch_length_um", "avg_branch_length_um")


def well_ids(n: int) -> List[str]:
    """A column of a 96-well plate first: A01..H01, A02..."""
    return [f"{'ABCDEFGH'[i % 8]}{i // 8 + 1:02d}" for i in range(n)]


def segmentor_cfg(config: Dict, root: Path, tmpdir: Path) -> Path:
    """The segmentor's model config JSON, as the CLI reads one, from the
    benchmark's configuration file."""
    keys = ("patch_size", "filter_counts", "ds_ratio", "channels", "dtype", "tta", "quantize")
    cfg = {k: config[k] for k in keys if k in config}
    cfg["checkpoint_file"] = str((root / config["checkpoint"]).resolve())
    path = tmpdir / f"{config['name']}.model.json"
    path.write_text(json.dumps(cfg))
    return path


class Driver:
    kind = "plate"

    def __init__(self, h):
        self.h = h
        self.t = h.traffic
        self.counters: Dict[str, float] = {}
        self.traced: Dict[str, float] = {}
        self.item_s: List[float] = []
        self.results: List[Dict] = []
        self.spans: List[str] = []  # the kind of each span of the traced part, in order
        self.kept: Dict[int, Dict] = {}  # what a driver keeps of the program's plates for the check

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        import torch
        from tmat_torch.models import unet
        from tmat_torch.tools.plate_pipeline import run_plate

        h, t = self.h, self.t
        self.run_plate = run_plate
        config = dict(h.config, quantize=True) if h.control else h.config
        self.seg = unet.get_unet_patch_segmentor_from_cfg(
            str(segmentor_cfg(config, h.root, h.tmpdir)), device=h.device)
        h.log("set-up: segmentor built")
        self.plates = h.cell.generator.make(h.seed, t, h.device)
        h.log("set-up: inputs made")
        self.ids = well_ids(t["wells_per_plate"])
        self.cfg = {"image_width_microns": t["image_width_microns"], **t.get("graph", {})}
        self.kw = dict(t.get("run_plate", {}), device=h.device)
        self.patch_flops = unet_flops(h.config["patch_size"], h.config["filter_counts"],
                                      h.config.get("channels", 1))

        # the prediction function the pipeline calls: counted, and copied
        # out for the check on the plates drawn for it
        self._pred = self.seg._pred_fn
        self.recording = None
        self.seg._pred_fn = self._counted_pred
        # the layer's entry as the program binds it, inside harness spans
        self._down_block = unet.down_block
        unet.down_block = self._span_down_block

        # plates of distinct content (the cycle repeats), among those the window reaches
        n_check = t["check_plates"]
        within = max(n_check, int(t["check_plate_rate"] * h.seconds))
        self.check_at = []
        for p in seeded(h.seed, 5).permutation(within).tolist():
            if len(self.check_at) < n_check and all((p - q) % len(self.plates) for q in self.check_at):
                self.check_at.append(p)
        self.check_at.sort()
        if h.device.type == "cuda":
            n = h.config["patch_size"]
            self.pinned = {p: [torch.empty((self.patches_per_forward(), n, n, 1), dtype=torch.float32,
                                           pin_memory=True) for _ in self.ids] for p in self.check_at}
        else:
            self.pinned = {p: [None] * len(self.ids) for p in self.check_at}
        self.recorded: Dict[int, list] = {p: [] for p in self.check_at}

        warm = run_plate(self.plates[0], self.ids, self.seg, self.cfg, timer=h.new_timer(), **self.kw)
        warm.pop("_timer")
        h.sync()

    def patches_per_forward(self) -> int:
        c = self.h.config
        side = int(round(self.t["size"] * c["ds_ratio"]))
        step, aug = c["patch_size"] // 2, c["patch_size"] // 2
        n = -(-(side + 2 * aug - c["patch_size"]) // step) + 1
        return c.get("tta", 8) * n * n

    def _counted_pred(self, batch):
        out = self._pred(batch)
        self.counters["forwards"] = self.counters.get("forwards", 0) + 1
        if self.h.tracer.active:
            self.traced["unet_flops"] = self.traced.get("unet_flops", 0) + batch.shape[0] * self.patch_flops
        if self.recording is not None:
            buf = self.recording[len(self.recorded[self.recording_plate])]
            if buf is None:
                buf = out.detach().clone()
            else:
                buf.copy_(out, non_blocking=True)
            self.recorded[self.recording_plate].append(buf)
        return out

    def _span_down_block(self, x, blk, first=False):
        tracer = self.h.tracer
        if not tracer.active:
            return self._down_block(x, blk, first)
        tracer.mark()
        out = self._down_block(x, blk, first)
        tracer.mark()
        b, hh, _, c = x.shape
        self.spans.append("down_block")
        self.traced["down_block_bound_s"] = (self.traced.get("down_block_bound_s", 0)
                                             + block_work(b, hh, c, out.shape[-1], x.element_size())["bound_s"])
        return out

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> None:
        h, t = self.h, self.t
        tracer, timer = h.tracer, h.timer
        trace_from, trace_n = t["trace_plates"]
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while time.perf_counter() < deadline:
            if h.trace and i == trace_from:
                tracer.start(h.device)
            if i in self.pinned:
                self.recording, self.recording_plate = self.pinned[i], i
            plate = self.plates[i % len(self.plates)]
            with timer.stage("plate"):
                s = time.perf_counter()
                res = self.run_plate(plate, self.ids, self.seg, self.cfg, timer=timer, **self.kw)
                self.item_s.append(time.perf_counter() - s)
            self.recording = None
            res.pop("_timer", None)
            self.results.append(res)
            i += 1
            if h.trace and i == trace_from + trace_n:
                h.trace_summary = tracer.stop()
        if tracer.active:
            h.trace_summary = tracer.stop()
        h.window_s = time.perf_counter() - t0
        wells = len(self.ids) * i
        self.counters.update(plates=i, wells=wells, attempted=wells,
                             failed=sum(len(self.ids) - len(r["well_id"]) for r in self.results))
        # a plate drawn for the check that a slow window did not reach is
        # run now, through the same call, and checked like the others
        self.late = {}
        for p in self.check_at:
            if p >= i:
                self.recording, self.recording_plate = self.pinned[p], p
                res = self.run_plate(self.plates[p % len(self.plates)], self.ids, self.seg, self.cfg,
                                     timer=h.new_timer(), **self.kw)
                self.recording = None
                res.pop("_timer", None)
                self.late[p] = res

    # ------------------------------------------------------------ check

    def release(self) -> None:
        from tmat_torch.models import unet

        unet.down_block = self._down_block
        self.seg = self._pred = None

    def check(self) -> Dict[str, float]:
        """The numbers compared (see ``limits/<cell>.json``), over the wells
        checked:

        - ``prob_gap``, ``prob_mean_gap``: the widest and the mean gap of a
          patch probability from the reference's, from the raw stack;
        - ``area_gap``: how far (points) the area lies outside the band of
          the reference's areas at its GMM threshold moved by 1e-4;
        - ``tail_count_gap``, ``tail_length_gap``: the mean over the wells of
          the relative gap of the branch count and of the total length
          from the reference's float64 host tail run on the program's own
          patch outputs (the tail follows the program from its state);
        - ``rows_missing``;
        - whatever further ``gaps`` the reference gives a well (the widest),
          from what the driver ``kept`` of the program's plate.

        The reference gets each well's stack trimmed to the traffic's
        ``run_plate.z_counts``, where it gives them.

        ``tail_gap``, the widest of those gaps over the wells, is reported
        and compared with nothing: one well's count flips by a branch under
        float32 rounding as under the control. Under the control the
        segmentor is the program's int8 path, the GMM runs in bfloat16 and
        the tail takes a bfloat16 probability map."""
        import torch
        from perfbench.reference.flax_msgpack import read_flax

        h, c, t = self.h, self.h.config, self.t
        ref = h.cell.reference
        low = torch.bfloat16 if h.control else torch.float64
        ref.no_tf32()
        model = ref.UNetRef(read_flax(h.root / c["checkpoint"]), c["filter_counts"]).to_device(h.device)
        seen = {k: [] for k in ("prob", "prob_mean", "area", "count", "length")}
        depths = t.get("run_plate", {}).get("z_counts")  # each well's depth, from the traffic
        missing = 0
        for p in self.check_at:
            plate = self.plates[p % len(self.plates)]
            res = self.results[p] if p < len(self.results) else self.late[p]
            outs = self.recorded[p]
            if len(outs) != len(self.ids) or res["well_id"] != self.ids:
                missing += len(self.ids)
                continue
            for w, wid in enumerate(self.ids):
                row = {k: float(res[k][w]) for k in ROW_KEYS}
                if not all(np.isfinite(row[k]) for k in ROW_KEYS):
                    missing += 1
                    continue
                stack = plate[w][: depths[w]] if depths else plate[w]
                want = ref.well_row(stack, model, c, t, h.device, self.kept.get(p))
                probs = want["probs"]
                # the program's forward of this well: the one nearest the reference's
                diffs = [(o.to(probs.device) - probs).abs() for o in outs]
                k = int(np.argmin([float(d.max()) for d in diffs]))
                seen["prob"].append(float(diffs[k].max()))
                seen["prob_mean"].append(float(diffs[k].mean()))
                lo, hi = want["area_band"]
                if h.control:
                    row["area_pct"] = ref.control_area(want)
                seen["area"].append(max(0.0, lo - row["area_pct"], row["area_pct"] - hi))
                n, total, _ = ref.tail_row(outs[k].to(h.device), want, c, t, low)
                for key, value in want.get("gaps", {}).items():
                    seen.setdefault(key, []).append(value)
                seen["count"].append(abs(row["total_branches"] - n) / max(n, 1))
                seen["length"].append(abs(row["total_branch_length_um"] - total) / max(total, 1.0))
                h.log(f"well {p}/{wid}: prob gap {seen['prob'][-1]:.5f} area gap {seen['area'][-1]:.3g} "
                      f"count gap {seen['count'][-1]:.3g} length gap {seen['length'][-1]:.3g} row {row} "
                      f"tail {(n, total)} band {want['area_band']}")
        del model
        if h.device.type == "cuda":
            torch.cuda.empty_cache()
        out = {"rows_missing": missing, "wells_checked": len(seen["prob"])}
        for k in ("prob", "prob_mean", "area"):
            out[f"{k}_gap"] = max(seen[k], default=float("nan"))
        # a well's branch count flips by one under rounding (bars of exactly
        # min_branch_length are common), so the tail is held by its means
        for k in ("count", "length"):
            out[f"tail_{k}_gap"] = float(np.mean(seen[k])) if seen[k] else float("nan")
        out["tail_gap"] = max(map(max, seen["count"], seen["length"]), default=float("nan"))
        for key in set(seen) - {"prob", "prob_mean", "area", "count", "length"}:
            out[key] = max(seen[key])
        return out
