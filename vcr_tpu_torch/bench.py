"""Benchmark: MSVD captions/sec/chip for the flagship S2VT greedy decode.

Counterpart of the JAX package's ``bench.py``. Measures the features ->
caption tokens call of ``serving.build_captioner`` on one card at the
reference's model dimensions (S2VT greedy on MSVD-VGG 4096-d features,
H=512, N=30 frames, L=20 tokens, vocab 9000 padded to 128;
``entry.FLAGSHIP``) in bf16 products with float32 state and a serving-sized
batch (B=2048). On the card the call launches B1 twice (the encoder and the
prime pass) through its ``torch.library`` op; no switch turns it off.

    python -m vcr_tpu_torch.bench [--batch 2048] [--iters 20] [--tag T]
        [--upload_chunk_mb MB]
    python -m vcr_tpu_torch.cli --mode bench

Prints ONE JSON line (``utils.benchutil.emit_row``), last: ``metric``,
``value``, ``unit``, ``vs_baseline``, ``mfu``, then ``median`` (the rate
of the median call), ``loadavg`` (the host's 1/5/15-minute load), ``iters``,
``flops`` (the products of one timed call, all ``iters`` captioner calls,
counted on one captioner call and multiplied: the calls are the same) and
``launches`` (B1-B4's counters read before and after the best timed call).

vs_baseline: the reference publishes no numbers, so the baseline is an
engineering estimate of the PyTorch reference on a V100: its decode runs
50 sequential Python-loop steps (30 encode + 20 decode, S2VTModel.py:121-177)
with ~6 small kernel launches each; at a measured-typical ~60µs/launch plus
cuDNN GRU cell time this bounds a bsize-32 batch near ~10ms  => ~3,000
captions/s. The ≥5x target therefore means ≥15,000 captions/s.

Timing: ``iters`` calls issued back to back from Python between two CUDA
events, best of 3 after a warm-up call (``benchutil.time_chained``). The
JAX bench chains its calls inside one jit and perturbs the input per call
so that XLA cannot fold them into one; eager PyTorch recomputes every call,
so the input is not perturbed. The row includes the host's launch time
wherever the host cannot stay ahead of the card (981 launches per flagship
call, ``PERF.md`` §5); capturing the call in a CUDA graph (ROADMAP A19) is
what would remove it.

A subprocess probe (``utils.backend_probe``) runs first: a failed probe
prints one JSON failure line and exits 1. There is no CPU fallback:
``--device cpu``, or no card at all, raises before anything is built. The
JAX module's ``VCR_BENCH_BATCH``, ``VCR_BENCH_ITERS``, ``VCR_BENCH_TAG`` and
``VCR_UPLOAD_CHUNK_MB`` are the flags above; ``VCR_BENCH_PALLAS`` is not
ported. Nothing here reads the environment.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from vcr_tpu_torch.utils import benchutil

EST_V100_REFERENCE_CAPS_PER_SEC = 3000.0
METRIC = "MSVD S2VT greedy captions/sec/chip (feats->tokens, B=%d)"


class Row(NamedTuple):
    """One bench row's program. ``run_n(*args)`` does ``rows_per_call``
    units of work (captions, videos or tokens: ``unit`` is their rate) and
    returns its last output; ``metric`` is the row's name. ``call`` (fn,
    args, times): ``run_n`` is ``times`` calls of ``fn(*args)`` (a caption
    call, a tick, a train step), so its products are ``times`` times that
    call's, counted on one call; the artifact's is the live tokens call,
    whose products the exported program's stand for. ``per_caption``:
    tokens per caption, where the row also prints its token rate as
    captions (``captions_equiv_per_s``)."""

    run_n: Callable
    args: tuple
    rows_per_call: float
    metric: str
    call: tuple
    unit: str = "captions/s"
    per_caption: Optional[int] = None


def unit_flops(row: Row) -> int:
    """The products of one ``run_n`` call of ``row``: ``benchutil.flops`` of
    one call of its ``call`` (``FlopCounterMode`` runs a call many times
    slower than eager), times ``times``."""
    fn, args, times = row.call
    return benchutil.flops(fn, *args) * times


def measure(row: Row, device) -> dict:
    """Time ``row`` on the card (``benchutil.time_chained``; RuntimeError on
    the CPU, before anything runs) -> its fields, with the products of one
    timed call and the kernel launches of the best one, read around it."""
    device = benchutil.require_card(device)
    return benchutil.time_chained(row.run_n, row.args, device, count=unit_flops(row))


def row_fields(row: Row, timed: dict, iters: int, **extra) -> dict:
    """The JSON row of a timed ``row``: the JAX row's keys (``extra`` in
    their place), then the median rate, the load, the counts."""
    value = row.rows_per_call / timed["best_s"]
    out = {"metric": row.metric, "value": value, "unit": row.unit, **extra}
    if row.per_caption:
        out["captions_equiv_per_s"] = value / row.per_caption
    if timed["mfu"] is not None:
        out["mfu"] = timed["mfu"]
    out.update(median=row.rows_per_call / timed["median_s"], loadavg=timed["loadavg"],
               iters=iters, flops=timed["flops"], launches=timed["launches"])
    return out


def probe_or_exit(metric: str, unit: str) -> Optional[int]:
    """Probe the card in a subprocess; a failure prints the JSON failure line
    and returns 1 (the exit code), success None."""
    from vcr_tpu_torch.utils import backend_probe

    ok, diag = backend_probe.ensure_backend()
    if ok:
        return None
    backend_probe.emit_failure_json(metric=metric, unit=unit, diag=diag)
    return 1


def normal_feats(rng: np.random.Generator, shape: Sequence[int], device,
                 limit_mb: Optional[float] = None) -> torch.Tensor:
    """float32 normal draws of ``shape`` from ``rng``, copied to ``device``
    in slices of at most ``limit_mb`` MB, cast to bf16 there."""
    host = rng.standard_normal(tuple(shape)).astype(np.float32)
    return benchutil.chunked_to(host, device, limit_mb).to(torch.bfloat16)


def flagship_row(spec, params, feats: torch.Tensor, iters: int, device=None) -> Row:
    """The flagship's row: ``iters`` calls of ``serving.build_captioner``'s
    tokens call on ``feats`` (B, N, V), back to back; returns the last
    call's tokens (B, L) int32."""
    from vcr_tpu_torch import serving

    caption = serving.build_captioner(params, spec, device=device)

    def run_n(x):
        for _ in range(iters):
            tokens = caption(x)
        return tokens

    return Row(run_n, (feats,), feats.shape[0] * iters, METRIC % feats.shape[0],
               (caption, (feats,), iters))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--tag", default=None,
                   help="marks a variant's row: its metric becomes '<metric> [<tag>]'")
    p.add_argument("--upload_chunk_mb", type=float, default=None,
                   help="copy the features to the card in slices of at most this many "
                        "MB (default: one copy)")
    p.add_argument("--device", default="cuda",
                   help="the card (a CPU time is not a device measurement: cpu raises)")
    args = p.parse_args(argv)
    device = benchutil.require_card(args.device)
    rc = probe_or_exit("MSVD S2VT greedy captions/sec/chip", "captions/s")
    if rc is not None:
        return rc

    from vcr_tpu_torch import entry

    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device=device)
    feats = normal_feats(np.random.default_rng(0),
                         (args.batch, spec.num_frames, spec.vid_feat_size), device,
                         args.upload_chunk_mb)
    row = flagship_row(spec, params, feats, args.iters, device)
    timed = measure(row, device)
    value = row.rows_per_call / timed["best_s"]
    benchutil.emit_row(row_fields(row, timed, args.iters,
                                  vs_baseline=value / EST_V100_REFERENCE_CAPS_PER_SEC),
                       tag=args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
