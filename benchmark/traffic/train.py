"""Training by one process in a closed loop: request i is optimizer step i of
one train step object, on the resident batch i mod R, seeded with its own
int. Steps are issued back to back; the host waits for the card only at the
window's end.

The mix gives ``batch``, ``resident_batches`` (R, at least the reference's
steps plus one, so those steps all see different rows),
``caption_words`` (the share of each caption length in words, the same
multiset in every batch) and ``profiled_requests``. The cell gives
``reference_steps`` and the limits of ``loss_gap``, ``grad_gap`` and
``change_gap``.

Set-up builds the step (``train.step.build_step_fns``) with its model and
optimizer state, drives it through its first ``reference_steps`` steps with
the window's own call and feed, keeps what the check reads (the losses, the
first gradient as Adam's first moment holds it, the parameters after the
last of them), and hands the same object to the window.

``ctx.variant`` "control" puts the reference, at the control's lower
precision, in the program's place (``calibrate.py``, which also plants the
faults from outside, by wrapping ``issue``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark import arith, inputs, port


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    return max(abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med)
               for k in keys)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.m, self.mix = ctx, ctx.model, ctx.mix
        self.batch = self.mix["batch"]
        self.units_per_request = self.batch
        self.flops_per_request = arith.train_flops(self.m) * self.batch
        self.steps = ctx.cell["reference_steps"]
        self.next_request = self.steps

    def seed_of(self, i: int) -> int:
        return inputs.derive(self.ctx.seed, f"step{i}")

    def setup(self) -> None:
        ctx, m, dev = self.ctx, self.m, self.ctx.device
        if self.mix["resident_batches"] <= self.steps:
            raise ValueError("resident_batches must exceed reference_steps")
        ctx.log("set-up: weights")
        sd = inputs.state_dict(ctx.reference.layout(m), m, ctx.seed, dev)
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        ctx.log("set-up: inputs")
        self.batches = []
        for i in range(self.mix["resident_batches"]):
            b = inputs.sentences(ctx.seed, i, self.batch, m, self.mix["caption_words"], dev)
            b["vid_feats"] = inputs.video_feats(ctx.seed, i, self.batch, m, dev)
            self.batches.append(b)
        if ctx.variant == "control":
            return
        ctx.log("set-up: program")
        from vcr_tpu_torch.train import optim, step

        t = m["train"]
        self.params = port.load_params(self.sd, m, dev)
        optimizer = optim.build_optimizer(t["optimizer"], t["lr"], t["wd"], t["max_norm"])
        self.opt_state = optimizer.init(self.params)
        self.train_step = step.build_step_fns(m["arch"], port.model_spec(m), optimizer,
                                              static_tf=t["teacher_force"], device=dev)[0]
        ctx.log("set-up: first steps")
        self.losses = []
        for i in range(self.steps):
            self.complete(i, self.issue(i))
            if i == 0:
                tree = {}
                for path, leaf in zip(self.opt_state.paths, self.opt_state.leaves):
                    node = tree
                    for key in path[:-1]:
                        node = node.setdefault(key, {})
                    # a step that never reached the optimizer left no moment
                    moment = self.opt_state.optimizer.state[leaf].get(
                        "exp_avg", torch.zeros_like(leaf))
                    node[path[-1]] = moment / (1.0 - t["betas"][0])
                self.first_grad = port.export_tree(tree, m)
        self.after = port.export_tree(self.params, m)
        self.losses = [float(x) for x in self.losses]
        self.sync()

    def issue(self, i: int):
        batch = self.batches[i % len(self.batches)]
        metrics = self.train_step(self.params, self.opt_state, batch, self.seed_of(i),
                                  self.m["train"]["teacher_force"])[2]
        if i < self.steps:
            self.losses.append(metrics["loss"].detach().clone())
        return metrics

    def complete(self, i: int, out) -> None:
        """Nothing: the host runs ahead, and the window synchronises once."""

    def sync(self) -> None:
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def release(self) -> None:
        self.params = self.opt_state = self.train_step = None

    def check(self, window: dict) -> List[dict]:
        """The program's first steps against the reference's on the same
        batches and seeds: each step's loss, the first gradient as Adam gets
        it, the parameters' change after the last step; each by the worst
        step or leaf. A leaf whose reference gradient is under a thousandth
        of the median leaf's moves by round-off alone and is left out of the
        change."""
        ctx, m, t = self.ctx, self.m, self.m["train"]
        dev = ctx.device
        sd = {k: v.to(dev) for k, v in self.sd.items()}
        batches = self.batches[: self.steps]
        seeds = [self.seed_of(i) for i in range(self.steps)]
        ref = ctx.reference.train_steps(sd, m, t, batches, seeds)
        if ctx.variant == "control":
            prog = ctx.reference.train_steps(sd, m, t, batches, seeds, prec=ctx.cell["control"])
            losses, first_grad = prog["loss"], prog["grad"]
            change = {k: v.cpu() for k, v in prog["change"].items()}
        else:
            losses, first_grad = self.losses, self.first_grad
            change = {k: self.after[k] - self.sd[k] for k in self.sd}
        keys = list(self.sd)
        raw = {k: float(ref["raw_grad"][k].double().norm()) for k in keys}
        floor = 1e-3 * statistics.median(raw.values())
        moved = [k for k in keys if raw[k] >= floor]
        ref_cpu = {k: ref["change"][k].cpu() for k in keys}
        limits = ctx.cell["limits"]
        return [
            {"name": "loss_gap", "limit": limits["loss_gap"],
             "value": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))},
            {"name": "grad_gap", "limit": limits["grad_gap"],
             "value": leaf_gap({k: v.cpu() for k, v in first_grad.items()},
                               {k: v.cpu() for k, v in ref["grad"].items()}, keys)},
            {"name": "change_gap", "limit": limits["change_gap"],
             "value": leaf_gap(change, ref_cpu, moved)},
        ]
