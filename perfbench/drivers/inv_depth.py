"""Closed loop of invasion stacks through one streaming
``tools/compute_inv_depth.py::predict_rows`` call.

Set-up loads the ensemble as the tool does (``load_ensemble`` on the
``n_pred_models`` members ranked best by their histories), makes
``cycle_stacks`` distinct stacks from the seed (the traffic's generator,
``inputs/<inputs>.py``) and runs ``warm_stacks`` of them through ``predict_rows``. The window
hands stacks to one ``predict_rows`` call (its own pipelining of
``MAX_IN_FLIGHT`` stacks) until the window ends, and lasts until that call
returns.

The check: the rows of ``check_stacks`` stacks drawn from the seed among
those handed in, and each member's probabilities for them (kept by a
forward hook as they were made), against the traffic's plain reference
(``reference/<reference>.py``).
"""

from __future__ import annotations

import time
from typing import Dict

from perfbench.inputs.vessels import seeded
from perfbench.work import resnet50_flops


class Driver:
    kind = "inv_depth"

    def __init__(self, h):
        self.h = h
        self.t = h.traffic
        self.counters: Dict[str, float] = {}
        self.traced: Dict[str, float] = {}

    def members(self):
        c, root = self.h.config, self.h.root
        from tmat_torch.tools import compute_inv_depth as inv

        ranked = inv._rank_models_by_history(root / c["ensemble_dir"], c["n_models"])
        return [root / c["ensemble_dir"] / f"best_finetune_weights_{int(i)}.msgpack"
                for i in ranked[: c["n_pred_models"]]]

    def setup(self) -> None:
        import torch
        from tmat_torch.device import dtype_from_name
        from tmat_torch.tools import compute_inv_depth as inv

        h, t, c = self.h, self.t, self.h.config
        self.inv = inv
        self.hw = tuple(c["input_shape"][:2])
        self.ens = inv.load_ensemble(self.members(), tuple(c["input_shape"]), c["last_layer"],
                                     dtype_from_name(c.get("dtype"), h.device), h.device)
        self.stacks = h.cell.generator.make(h.seed, t, h.device)
        self.flops_per_stack = t["z"] * len(self.ens) * resnet50_flops(self.hw[0], c["last_layer"])

        # each member's probabilities of the stacks drawn for the check
        self.keep = set()
        self.handed = 0
        self.member_out: Dict[int, list] = {}
        self.hooks = [m.register_forward_hook(self._hook(k)) for k, m in enumerate(self.ens)]
        within = max(t["check_stacks"], int(t["check_stack_rate"] * h.seconds))
        self.check_at = sorted(seeded(h.seed, 6).choice(within, t["check_stacks"], replace=False).tolist())

        warm = [(f"warm{i}", self.stacks[i % len(self.stacks)]) for i in range(t["warm_stacks"])]
        inv.predict_rows(warm, self.ens, self.hw, c["cls_thresh"], h.new_timer())
        h.sync()

    def _hook(self, k: int):
        def hook(module, inputs, out):
            idx = self.handed - 1  # the stack being dispatched
            if idx in self.keep:
                self.member_out.setdefault(idx, [None] * len(self.ens))[k] = out.detach()
        return hook

    def _feed(self, deadline: float):
        h, t = self.h, self.t
        i = 0
        while True:
            now = time.perf_counter()
            if i == 0:
                self.first = now
            if now >= deadline:
                return
            if h.trace and i == t["trace_stacks"][0]:
                h.tracer.start(h.device)
            if h.trace and i == sum(t["trace_stacks"]):
                h.trace_summary = h.tracer.stop()
            self.keep = {i} & set(self.check_at)
            self.handed = i + 1
            if h.tracer.active:
                self.traced["resnet_flops"] = self.traced.get("resnet_flops", 0) + self.flops_per_stack
            yield f"S{i}", self.stacks[i % len(self.stacks)]
            i += 1

    def window(self, seconds: float) -> None:
        h, c = self.h, self.h.config
        t0 = time.perf_counter()
        self.rows = self.inv.predict_rows(self._feed(t0 + seconds), self.ens, self.hw, c["cls_thresh"],
                                          None)
        end = time.perf_counter()
        if h.tracer.active:
            h.trace_summary = h.tracer.stop()
        h.window_s = end - self.first
        z = self.t["z"]
        n = self.handed
        self.counters.update(stacks=len(self.rows) // z, attempted=n,
                             failed=n - len(self.rows) // z, slices=len(self.rows))

    def release(self) -> None:
        for hk in self.hooks:
            hk.remove()
        self.ens = None

    def check(self) -> Dict[str, float]:
        """The numbers compared (see ``limits/<cell>.json``): the widest gap
        of a member's probability and of a row's, over the stacks checked,
        rows whose prediction disagrees with their own probability, and rows
        missing. Under the control the members' probabilities and the rows
        are the reference's computed in float8 (``reference/resnet.py``)."""
        import torch
        from perfbench.reference.flax_msgpack import read_flax

        h, c, z = self.h, self.h.config, self.t["z"]
        ref = h.cell.reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ranked = ref.rank_members(h.root / c["ensemble_dir"], c["n_models"])[: c["n_pred_models"]]
        trees = [read_flax(h.root / c["ensemble_dir"] / f"best_finetune_weights_{i}.msgpack") for i in ranked]
        members = [ref.ResNetRef(t, c["last_layer"], h.device) for t in trees]
        control = [ref.ResNetRef(t, c["last_layer"], h.device, quantize=True) for t in trees] if h.control else None
        by_id = {r[self.inv.ID_COL]: (r[self.inv.PROB_COL], r[self.inv.PRED_COL]) for r in self.rows}
        out = {"member_gap": 0.0, "prob_gap": 0.0, "pred_mismatch": 0, "rows_missing": 0,
               "slices_checked": 0}
        for i in self.check_at:
            stack = self.stacks[i % len(self.stacks)]
            probs = ref.stack_probs(stack, members, self.hw, h.device)
            if control is not None:
                prog = ref.stack_probs(stack, control, self.hw, h.device)
                rows = {f"S{i}_z{zi}": r for zi, r in enumerate(ref.rows(prog, c["cls_thresh"]))}
            else:
                outs = self.member_out.get(i)
                if i >= self.handed or outs is None or any(o is None for o in outs):
                    out["rows_missing"] += z
                    continue
                prog = torch.stack([o.float().reshape(-1) for o in outs]).to(probs.device)
                rows = by_id
            out["member_gap"] = max(out["member_gap"], float((prog - probs).abs().max()))
            for zi, (p_ref, _) in enumerate(ref.rows(probs, c["cls_thresh"])):
                row = rows.get(f"S{i}_z{zi}")
                if row is None:
                    out["rows_missing"] += 1
                    continue
                p, pred = row
                out["prob_gap"] = max(out["prob_gap"], abs(p - p_ref))
                out["pred_mismatch"] += int(pred != int(p > c["cls_thresh"]))
                out["slices_checked"] += 1
            h.log(f"stack {i}: members {prog.cpu().numpy().round(4).tolist()} "
                  f"ref {probs.cpu().numpy().round(4).tolist()}")
        return out
