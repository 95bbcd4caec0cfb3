"""Training-step throughput benchmarks on one card.

Counterpart of the JAX package's ``bench_train.py``. Default (no family):
the S2VT flagship configuration, one JSON line, with the same contract as
``bench`` (the headline bench stays inference; this is the training
analogue: forward + backward + Adam + global-norm clip at the reference's
training configuration, through the product step
``train.step.build_step_fns``).

    python -m vcr_tpu_torch.bench_train [s2vt|s2vt-att|transformer|rationale|spatial|all]
        [--iters 10] [--batch B] [--accum N] [--remat] [--tag T] [--upload_chunk_mb MB]

``all`` benches every family (S2VT, S2VT-att, the Transformer, RationaleNet,
SpatialNet) with its feature configuration (``FAMILY_DEFAULTS``), one JSON
line per family: ``metric``, ``value`` (videos/s), ``unit``, ``step_ms``,
``grad_accum`` (when above 1), ``mfu``, then ``median``, ``loadavg``,
``iters``, ``flops`` and ``launches`` as ``bench`` prints them. ``--batch``
replaces every family's batch, ``--accum N`` makes each update from N
microbatches (``Config.grad_accum``), ``--remat`` runs the train forward
under ``torch.utils.checkpoint``: these are the JAX module's
``VCR_BENCH_BATCH``, ``VCR_BENCH_ACCUM`` and ``VCR_BENCH_REMAT``, and
``--iters``, ``--tag`` and ``--upload_chunk_mb`` its ``VCR_BENCH_ITERS``,
``VCR_BENCH_TAG`` and ``VCR_UPLOAD_CHUNK_MB``. Nothing here reads the
environment.

The JAX module benches its plain recurrences by default
(``VCR_BENCH_PALLAS=0``). That switch is not ported: on the card the step
of S2VT, S2VT-att, SpatialNet and RationaleNet launches B1 (and
RationaleNet B2) through their ``torch.library`` ops, forward and in the
backward's recompute, whatever the option.

Timing: ``iters`` optimizer steps issued back to back from Python between
two CUDA events, best of 3 after a warm-up call
(``benchutil.time_chained``); the JAX module chains them inside one jit.
Each step draws its dropout from a ``torch.Generator`` seeded with its own
int (the port's convention) where JAX folds the step index into a key.
The optimizer updates the parameters in place, so each timed call goes on
training from where the last one stopped. The row includes the host's
launch time wherever the host cannot stay ahead of the card; capturing the
step in a CUDA graph (ROADMAP A19) is what would remove it. A failed probe
prints one JSON failure line and exits 1; ``--device cpu``, or no card at
all, raises before anything is built.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np
import torch

from vcr_tpu_torch.bench import Row, measure, normal_feats, probe_or_exit, row_fields
from vcr_tpu_torch.bench_all import FULL, spec_for
from vcr_tpu_torch.utils import benchutil

FAMILY_DEFAULTS = {
    # family: (batch, feats_shape, spec_kwargs)
    "s2vt": (1024, (30, 4096), {}),
    "s2vt-att": (1024, (30, 512), {}),
    "transformer": (128, (30, 4096), {}),
    "rationale": (512, (30, 4096), {"base_arch": "s2vt"}),
    "spatial": (16, (30, 1024, 13, 13), {"base_arch": "s2vt", "grid_size": 13}),
}
SENT_LEN = 12      # every sentence's length


def train_batch(rng: np.random.Generator, spec, batch: int, feats_shape, device,
                limit_mb=None) -> dict:
    """The JAX module's batch, drawn from ``rng``: normal bf16 features,
    uniform tokens, every sentence ``SENT_LEN`` long, every row valid."""
    return {"vid_feats": normal_feats(rng, (batch, *feats_shape), device, limit_mb),
            "sent": torch.as_tensor(rng.integers(0, spec.vocab_size, (batch, spec.max_len))
                                    .astype(np.int32), device=device),
            "sent_len": torch.full((batch,), SENT_LEN, dtype=torch.int32, device=device),
            "valid": torch.ones((batch,), dtype=torch.float32, device=device)}


def train_row(name: str, spec, params, batch: dict, iters: int, accum: int = 1,
              remat: bool = False, device=None) -> Row:
    """``iters`` steps of the product train step of family ``name`` (Adam lr
    2e-3, weight decay 4e-5, clip 1.0, static teacher forcing 1.0) on
    ``batch``; returns the last step's metrics. Step k of the whole run is
    seeded with k."""
    from vcr_tpu_torch.train import optim, step

    b = batch["vid_feats"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not divisible by accum {accum}")
    optimizer = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    opt_state = optimizer.init(params)
    train_step, _ = step.build_step_fns(name, spec, optimizer, grad_accum=accum,
                                        remat=remat, static_tf=1.0, device=device)
    seeds = itertools.count()

    def one(params, opt_state, bdata):
        return train_step(params, opt_state, bdata, next(seeds), 1.0)[2]

    def run_n(params, opt_state, bdata):
        for _ in range(iters):
            metrics = one(params, opt_state, bdata)
        return metrics

    args = (params, opt_state, batch)
    return Row(run_n, args, b * iters, f"{name} train step videos/sec/chip (B={b}, bf16)",
               (one, args, iters), unit="videos/s")


def bench_family(name: str, iters: int, batch=None, accum: int = 1, remat: bool = False,
                 device="cuda", tag=None, limit_mb=None) -> dict:
    """Build, time and print family ``name``'s row; returns it."""
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import base

    default_batch, feats_shape, spec_kw = FAMILY_DEFAULTS[name]
    batch = default_batch if batch is None else batch
    rng = np.random.default_rng(0)
    glove = rng.standard_normal((FULL.vocab_size, FULL.embed_size)).astype(np.float32)
    spec = spec_for(FULL, name, feats_shape[-1] if len(feats_shape) == 2 else feats_shape[1],
                    **spec_kw)
    init_fn, _ = base.build_model(name)
    params = params_to(init_fn(torch.Generator().manual_seed(0), spec, glove), device)
    data = train_batch(rng, spec, batch, feats_shape, device, limit_mb)
    row = train_row(name, spec, params, data, iters, accum, remat, device)
    timed = measure(row, device)
    extra = {"step_ms": timed["best_s"] / iters * 1e3}
    if accum > 1:
        extra["grad_accum"] = accum
    out = row_fields(row, timed, iters, **extra)
    benchutil.emit_row(out, tag=tag)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("family", nargs="?", default="s2vt",
                   choices=(*FAMILY_DEFAULTS, "all"))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=None,
                   help="every family's batch (default: FAMILY_DEFAULTS)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation: microbatches per update")
    p.add_argument("--remat", action="store_true",
                   help="recompute the train forward in the backward")
    p.add_argument("--tag", default=None,
                   help="marks a variant's row: its metric becomes '<metric> [<tag>]'")
    p.add_argument("--upload_chunk_mb", type=float, default=None,
                   help="copy the features to the card in slices of at most this many MB")
    p.add_argument("--device", default="cuda",
                   help="the card (a CPU time is not a device measurement: cpu raises)")
    args = p.parse_args(argv)
    device = benchutil.require_card(args.device)
    rc = probe_or_exit("train videos/sec/chip", "videos/s")
    if rc is not None:
        return rc
    families = list(FAMILY_DEFAULTS) if args.family == "all" else [args.family]
    for name in families:
        bench_family(name, args.iters, args.batch, args.accum, args.remat, device,
                     args.tag, args.upload_chunk_mb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
