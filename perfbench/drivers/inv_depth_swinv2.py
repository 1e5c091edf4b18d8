"""The inv_depth loop (``drivers/inv_depth.py``) for an ensemble of SwinV2
members (``tmat_torch/models/swin.py``).

Set-up draws ``n_pred_models`` members from the seed at the
configuration's sizes (``swin.build_swinv2_tl``: the published init, the
configuration's ``assumed``), gives each its head (below), writes each as
a checkpoint into the run's temporary directory (``swin.save_member``) and
loads them as the tool does, through ``compute_inv_depth.load_ensemble(
..., backbone=...)``. The stacks, the hooks, the stacks drawn for the
check and the warm stacks are inv_depth's; a second hook keeps each
member's logits (its head's output). The window is inv_depth's.

A head of seeded weights would give every slice the same probability, so
each member's head is a direction drawn from the seed, scaled, with a bias,
so that the reference's float32 logits of a sample of the cycle's slices
(``head_sample_slices`` of every stack, drawn from the seed) have mean 0
and std ``head_logit_std``. The sample spans the cycle: the logits' spread
differs from stack to stack (over the first two stacks alone it ran
0.9-2.9 times the spread over the stacks checked).

The base loop's ``flops_per_stack`` (ResNet50's operations) is 0 here:
``swinv2_mfu`` reads the forwards' work from the program's counters.

The check: inv_depth's numbers (``member_gap``, ``prob_gap``,
``pred_mismatch``, ``rows_missing``) against ``reference/swinv2.py``, and
``logit_gap``: the widest gap of a member's logit from the reference's,
over the std of the reference's logits on the slices checked. Under the
control the members' logits and probabilities, and the rows, are the
reference's with every Linear in float8.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.drivers import inv_depth
from perfbench.inputs.vessels import seeded

ARCH_KEYS = ("patch", "embed_dim", "depths", "heads", "window", "mlp_ratio", "cpb_hidden")


class Driver(inv_depth.Driver):
    def setup(self) -> None:
        import torch
        from tmat_torch.device import dtype_from_name
        from tmat_torch.models import swin
        from tmat_torch.tools import compute_inv_depth as inv

        h, t, c = self.h, self.t, self.h.config
        self.inv, self.swin = inv, swin
        self.hw = tuple(c["input_shape"][:2])
        self.arch = {k: c[k] for k in ARCH_KEYS}
        self.stacks = h.cell.generator.make(h.seed, t, h.device)
        h.log("set-up: inputs made")
        self.paths = self._members()
        h.log("set-up: members drawn and written")
        self.ens = inv.load_ensemble(self.paths, tuple(c["input_shape"]), None,
                                     dtype_from_name(c.get("dtype"), h.device), h.device, backbone=c["backbone"])
        self.flops_per_stack = 0

        # each member's probabilities and logits of the stacks drawn for the check
        self.keep = set()
        self.handed = 0
        self.member_out: Dict[int, list] = {}
        self.logit_out: Dict[int, list] = {}
        self.hooks = [m.register_forward_hook(self._hook(k)) for k, m in enumerate(self.ens)]
        self.hooks += [m.head.register_forward_hook(self._logit_hook(k)) for k, m in enumerate(self.ens)]
        within = max(t["check_stacks"], int(t["check_stack_rate"] * h.seconds))
        self.check_at = sorted(seeded(h.seed, 6).choice(within, t["check_stacks"], replace=False).tolist())

        warm = [(f"warm{i}", self.stacks[i % len(self.stacks)]) for i in range(t["warm_stacks"])]
        inv.predict_rows(warm, self.ens, self.hw, c["cls_thresh"], h.new_timer())
        h.sync()

    def _members(self) -> list:
        """Draw, head and write the members; their checkpoints' paths."""
        import torch

        h, c = self.h, self.h.config
        ref = h.cell.reference
        rng = seeded(h.seed, 9)
        k = c["head_sample_slices"]
        sample = np.concatenate([s[np.sort(rng.choice(len(s), k, replace=False))] for s in self.stacks])
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        paths = []
        try:
            x = ref.prep(sample, self.hw, h.device)
            for k in range(c["n_pred_models"]):
                member = self.swin.build_swinv2_tl(tuple(c["input_shape"]), self.arch, torch.float32,
                                                   int(seeded(h.seed, 7, k).randint(2**31)), h.device)
                gen = torch.Generator().manual_seed(int(seeded(h.seed, 8, k).randint(2**31)))
                direction = torch.randn(member.head.weight.shape, generator=gen).to(h.device)
                with torch.no_grad():
                    member.head.weight.copy_(direction)
                    member.head.bias.zero_()
                    raw = ref.logits(x, ref.SwinV2Ref(member.state_dict(), self.hw[0], self.arch, h.device))
                    scale = c["head_logit_std"] / raw.std()
                    member.head.weight.mul_(scale)
                    member.head.bias.fill_(float(-raw.mean() * scale))
                paths.append(h.tmpdir / f"swinv2_member_{k}.pt")
                self.swin.save_member(member, paths[-1])
                del member
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if h.device.type == "cuda":
            torch.cuda.empty_cache()
        return paths

    def _logit_hook(self, k: int):
        def hook(module, inputs, out):
            idx = self.handed - 1  # the stack being dispatched
            if idx in self.keep:
                self.logit_out.setdefault(idx, [None] * len(self.ens))[k] = out.detach()
        return hook

    def check(self) -> Dict[str, float]:
        """The numbers compared (see ``limits/<cell>.json``): inv_depth's,
        over the stacks checked, and ``logit_gap`` (the module doc)."""
        import torch

        h, c, z = self.h, self.h.config, self.t["z"]
        ref = h.cell.reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        states = [torch.load(p, map_location=h.device, weights_only=True) for p in self.paths]
        members = [ref.SwinV2Ref(s, self.hw[0], self.arch, h.device) for s in states]
        control = ([ref.SwinV2Ref(s, self.hw[0], self.arch, h.device, quantize=True) for s in states]
                   if h.control else None)
        by_id = {r[self.inv.ID_COL]: (r[self.inv.PROB_COL], r[self.inv.PRED_COL]) for r in self.rows}
        out = {"member_gap": 0.0, "prob_gap": 0.0, "pred_mismatch": 0, "rows_missing": 0, "slices_checked": 0}
        widest, ref_logits = 0.0, []
        for i in self.check_at:
            stack = self.stacks[i % len(self.stacks)]
            logits = ref.stack_logits(stack, members, self.hw, h.device)
            probs = torch.sigmoid(logits)
            ref_logits.append(logits.reshape(-1))
            if control is not None:
                prog_logits = ref.stack_logits(stack, control, self.hw, h.device)
                prog = torch.sigmoid(prog_logits)
                rows = {f"S{i}_z{zi}": r for zi, r in enumerate(ref.rows(prog, c["cls_thresh"]))}
            else:
                outs, louts = self.member_out.get(i), self.logit_out.get(i)
                if i >= self.handed or outs is None or louts is None or any(o is None for o in outs + louts):
                    out["rows_missing"] += z
                    continue
                prog = torch.stack([o.float().reshape(-1) for o in outs]).to(probs.device)
                prog_logits = torch.stack([o.float().reshape(-1) for o in louts]).to(probs.device)
                rows = by_id
            out["member_gap"] = max(out["member_gap"], float((prog - probs).abs().max()))
            widest = max(widest, float((prog_logits - logits).abs().max()))
            for zi, (p_ref, _) in enumerate(ref.rows(probs, c["cls_thresh"])):
                row = rows.get(f"S{i}_z{zi}")
                if row is None:
                    out["rows_missing"] += 1
                    continue
                p, pred = row
                out["prob_gap"] = max(out["prob_gap"], abs(p - p_ref))
                out["pred_mismatch"] += int(pred != int(p > c["cls_thresh"]))
                out["slices_checked"] += 1
            h.log(f"stack {i}: member logits {prog_logits.cpu().numpy().round(3).tolist()} "
                  f"ref {logits.cpu().numpy().round(3).tolist()}")
        std = float(torch.cat(ref_logits).std()) if ref_logits else float("nan")
        out["logit_gap"] = widest / std
        out["ref_logit_std"] = std
        return out
