"""Batch captioning by one client in a closed loop: request i captions the
resident batch i mod R of ``batch`` videos through the program's serving
entry and copies its tokens to the host before request i + 1 is issued.

The mix (``traffic/<name>.json``) gives ``batch``, ``beam_size``,
``resident_batches`` (R), ``warmup_requests`` and ``profiled_requests``.
The cell (``workloads/<name>.json``) gives ``check_captions`` (how many
served captions the check samples) and the limit of ``served_gap``.

The entry is the callable of ``serving.build_captioner``; where a call
draws random numbers (RationaleNet's frame-selection noise, by
``serving.draw_plan``), the benchmark draws them from the seed and hands
them in through ``serving.make_caption_fn``, the function that
``build_captioner`` wraps, so that the reference reads the same noise.

``ctx.variant`` "control" puts the reference, at the control's lower
precision, in the program's place (``calibrate.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import arith, inputs, port


class Driver:
    def __init__(self, ctx):
        self.ctx, self.m, self.mix = ctx, ctx.model, ctx.mix
        self.batch, self.beam = self.mix["batch"], self.mix["beam_size"]
        self.units_per_request = self.batch
        self.flops_per_request = arith.caption_flops(self.m, self.beam) * self.batch
        self.next_request = 0
        self.served: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        ctx, m, dev = self.ctx, self.m, self.ctx.device
        ctx.log("set-up: weights")
        sd = inputs.state_dict(ctx.reference.layout(m), m, ctx.seed, dev)
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        ctx.log("set-up: inputs")
        resident = self.mix["resident_batches"]
        self.feats = [inputs.video_feats(ctx.seed, i, self.batch, m, dev)
                      for i in range(resident)]
        self.noise = [inputs.gumbel(ctx.seed, i, (self.batch, m["num_frames"], 2), dev)
                      if m["arch"] == "rationale" else None for i in range(resident)]
        ctx.log("set-up: program")
        self.program = self.build_program()
        ctx.log("set-up: warm-up")
        warm = self.mix["warmup_requests"]
        for i in range(warm):
            self.complete(i, self.issue(i))
        self.sync()
        self.served.clear()
        self.next_request = warm

    def build_program(self):
        m, dev, variant = self.m, self.ctx.device, self.ctx.variant
        if variant == "control":
            sd = {k: v.to(dev) for k, v in self.sd.items()}
            return lambda i: self.ctx.reference.serve(sd, m, self.feats[i], self.noise[i],
                                                      self.beam, self.ctx.cell["control"])
        from vcr_tpu_torch import serving

        spec = port.model_spec(m)
        params = port.load_params(self.sd, m, dev)
        if serving.draw_plan(spec, self.beam):
            caption = serving.make_caption_fn(spec, beam_size=self.beam,
                                              eos_id=m["eos_id"])

            def program(i):
                with torch.inference_mode():
                    return caption(params, self.feats[i], {"select": self.noise[i]})
        else:
            call = serving.build_captioner(params, spec, beam_size=self.beam,
                                           eos_id=m["eos_id"], device=dev)

            def program(i):
                return call(self.feats[i])
        if variant is not None:
            raise ValueError(f"unknown variant {variant!r}")
        return program

    # ------------------------------------------------------------ requests

    def issue(self, i: int):
        return self.program(i % len(self.feats))

    def complete(self, i: int, tokens) -> None:
        self.served[i] = tokens.cpu()

    def sync(self) -> None:
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.program = None

    # ------------------------------------------------------------ the check

    def check(self, window: dict) -> List[dict]:
        """The widest gap of a sample of the window's served captions, drawn
        from the seed, under the reference (``reference.served_gaps``)."""
        ctx, m = self.ctx, self.m
        first, n = window["start"], window["requests"]
        done = [i for i in range(first, first + n) if i in self.served]
        rng = np.random.default_rng(inputs.derive(ctx.seed, "check"))
        count = ctx.cell["check_captions"]
        reqs = rng.choice(done, size=count)
        rows = rng.integers(0, self.batch, size=count)
        sd = {k: v.to(ctx.device) for k, v in self.sd.items()}
        resident = len(self.feats)
        feats = torch.stack([self.feats[i % resident][r] for i, r in zip(reqs, rows)])
        noise = (None if self.noise[0] is None else
                 torch.stack([self.noise[i % resident][r] for i, r in zip(reqs, rows)]))
        tokens = torch.stack([self.served[i][r] for i, r in zip(reqs, rows)]).to(ctx.device)
        gaps = ctx.reference.served_gaps(sd, m, feats, noise, tokens, self.beam, ctx.cell)
        if len(done) < n:
            gaps = torch.cat([gaps, gaps.new_full((1,), torch.inf)])
        return [{"name": "served_gap", "value": float(gaps.max()),
                 "limit": ctx.cell["limits"]["served_gap"]}]
