"""Serving-pool autotuner: size the continuous-batching pool for a workload.

Counterpart of ``scripts/tune_serving.py``. The slot pool
(``vcr_tpu_torch/serving_continuous.py``) has three geometry knobs, slots R,
admission chunk A and step chunk S, whose best values depend on the card,
the model and the arrivals. This tool drives each candidate geometry over
the same seeded synthetic workload (Poisson arrivals at ``--rate`` req/s, or
a burst at ``--rate 0``) and prints, per geometry and rate, one JSON line:
completion throughput, occupancy (useful token-steps over slot-steps),
request latency p50/p95, ticks and admission chunks, and the kernel launches
of the run (on the card each admission chunk launches B1, RationaleNet's B2
and B1). A final ``best`` line per rate follows.

    python -m vcr_tpu_torch.tune_serving --save_path ./trained_models \\
        --rate 0,200 --n_requests 400 --slots 16,32,64 --admit_chunk 4,8 \\
        --step_chunk 2,4,8

or ``--synthetic`` for a small seeded S2VT instead of a checkpoint. The
flags are the JAX script's, with ``--device`` (the card unless ``cpu``) in
place of its ``--platform``. On the card a subprocess probe
(``utils.backend_probe``) runs first; a failed probe prints one JSON
failure line and exits 1.

The driver feeds ``caption_stream`` with the poll-marker protocol (None
while no request is due), as the HTTP daemon's queue drain does. Request k
arrives at a cumulative exponential time t_k, the same for every geometry,
and for a seed the same as the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from vcr_tpu_torch.device import resolve_device
from vcr_tpu_torch.utils import benchutil

# the synthetic model of the JAX script (scripts/tune_serving.py)
SYNTHETIC = dict(vocab_size=512, embed_size=300, hidden=256, vid_feat=512, max_len=12,
                 num_frames=8)
WORKLOAD_VIDEOS = 32


def make_workload(spec, n_requests: int, rates: Sequence[float], seed: int
                  ) -> Tuple[np.ndarray, Dict[float, np.ndarray]]:
    """(WORKLOAD_VIDEOS feature arrays the requests cycle through, arrival
    times per rate): a burst at t=0 for rate 0, else cumulative exponential
    gaps, drawn from one numpy generator in the JAX script's order."""
    rng = np.random.default_rng(seed)
    if spec.arch == "spatial":
        g = spec.grid_size
        shape = (WORKLOAD_VIDEOS, spec.num_frames, spec.vid_feat_size, g, g)
    else:
        shape = (WORKLOAD_VIDEOS, spec.num_frames, spec.vid_feat_size)
    feats = rng.standard_normal(shape).astype(np.float32)
    arrivals = {}
    for rate in rates:
        if rate > 0:
            arrivals[rate] = np.cumsum(rng.exponential(1.0 / rate, n_requests))
        else:
            arrivals[rate] = np.zeros(n_requests)
    return feats, arrivals


def run_config(cc, feats: np.ndarray, arrivals: np.ndarray) -> dict:
    """Drive one pool over the timed workload -> its metrics."""
    n = len(arrivals)
    t_done = {}
    before = benchutil.kernel_launches()
    t0 = time.monotonic()

    def requests():
        i = 0
        while i < n:
            remaining = arrivals[i] - (time.monotonic() - t0)
            if remaining <= 0:
                yield i, feats[i % len(feats)]
                i += 1
            else:
                # a bounded sleep, not a spin: a busy poll would compete for
                # the host with the work being measured
                time.sleep(min(0.0005, remaining))
                yield None

    for key, _toks in cc.caption_stream(requests()):
        t_done[key] = time.monotonic() - t0
    if cc.device.type == "cuda":
        torch.cuda.synchronize(cc.device)
    wall = max(time.monotonic() - t0, 1e-9)
    st = cc.stats
    row = {"served": len(t_done), "wall_s": wall,
           "throughput_caps_s": len(t_done) / wall,
           "occupancy": st["useful_steps"] / max(st["slot_steps"], 1),
           "latency_p50_ms": None, "latency_p95_ms": None, "ticks": st["ticks"],
           "admit_chunks": st["admit_chunks"],
           "launches": {k: v - before[k] for k, v in benchutil.kernel_launches().items()}}
    if t_done:
        lat = np.asarray(sorted(t_done[k] - arrivals[k] for k in t_done))
        row["latency_p50_ms"] = 1e3 * float(lat[len(lat) // 2])
        row["latency_p95_ms"] = 1e3 * float(lat[min(len(lat) - 1, int(len(lat) * 0.95))])
    return row


def pick_best(results: List[dict], rates: Sequence[float]) -> List[dict]:
    """One ``best`` record per rate. A burst (rate 0) sizes for capacity: the
    highest throughput among geometries at >= 0.9 occupancy (any geometry if
    none reaches it, with a caveat). A finite rate sizes for latency: the
    lowest p95, then the highest throughput."""
    out = []
    for rate in rates:
        scored = [r for r in results if r["served"] and r["rate"] == rate]
        if not scored:
            continue
        if rate == 0:
            qual = [r for r in scored if r["occupancy"] >= 0.9]
            best = max(qual or scored, key=lambda r: (r["throughput_caps_s"],
                                                      r["occupancy"]))
            rec = {"rate": rate, "best": best, "occupancy_qualified": bool(qual)}
            if not qual:
                rec["caveat"] = ("no geometry reached 0.9 occupancy: the pick rewards "
                                 "fewer ticks; re-tune at a higher load")
        else:
            best = min(scored, key=lambda r: (r["latency_p95_ms"],
                                              -r["throughput_caps_s"]))
            rec = {"rate": rate, "best": best}
        out.append(rec)
    return out


def tune(params, spec, eos_id: int, geometries: Sequence[Tuple[int, int, int]],
         rates: Sequence[float], n_requests: int, beam_size: int = 1, seed: int = 0,
         device=None) -> Tuple[List[dict], List[dict]]:
    """Drive every (R, A, S) geometry over the workload of ``seed`` at every
    rate, printing one JSON line per (geometry, rate) and then the ``best``
    lines -> (rows, bests)."""
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    device = resolve_device(device)
    feats, arrivals = make_workload(spec, n_requests, rates, seed)
    results = []
    for r, a, s in geometries:
        cc = ContinuousCaptioner(params, spec, slots=r, admit_chunk=a, step_chunk=s,
                                 eos_id=eos_id, beam_size=max(beam_size, 1), rng=seed,
                                 device=device)
        # warm the pool outside the timed window (one admission and its
        # ticks); the same pool then serves every rate
        list(cc.caption_stream([(-(j + 1), feats[j]) for j in range(min(2, r))]))
        for rate in rates:
            for k in cc.stats:
                cc.stats[k] = 0
            row = {"slots": r, "admit_chunk": a, "step_chunk": s, "rate": rate,
                   **run_config(cc, feats, arrivals[rate])}
            print(json.dumps(row), flush=True)
            results.append(row)
    bests = pick_best(results, rates)
    for rec in bests:
        print(json.dumps(rec), flush=True)
    return results, bests


def synthetic_model(seed: int, device):
    """The JAX script's --synthetic S2VT (float32, H=256), weights from
    ``seed`` -> (params, spec, eos_id)."""
    from vcr_tpu_torch import entry

    spec, params = entry.make_spec_and_params(**SYNTHETIC, seed=seed,
                                              compute_dtype="float32", vocab_pad_to=1,
                                              device=device)
    spec = spec.with_(dropout_p=0.0)
    return params, spec, spec.sos_id + 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save_path", default="",
                   help="checkpoint directory (tools.load_inference_state); "
                        "omit with --synthetic")
    p.add_argument("--data_dir", default="")
    p.add_argument("--corpus", default="msvd_vgg")
    p.add_argument("--glove_emb_file", default="glove.6B.300d.txt")
    p.add_argument("--synthetic", action="store_true",
                   help="a small seeded S2VT instead of a checkpoint")
    p.add_argument("--slots", default="16,32,64")
    p.add_argument("--admit_chunk", default="4,8")
    p.add_argument("--step_chunk", default="2,4")
    p.add_argument("--rate", default="100",
                   help="comma list of mean Poisson arrival rates, req/s (0: all "
                        "arrive at t=0). Each rate is a full sweep axis: a burst "
                        "sizes for capacity, a finite rate for latency")
    p.add_argument("--n_requests", type=int, default=200)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the pool runs (default: the card)")
    args = p.parse_args(argv)
    if args.n_requests < 1:
        p.error("--n_requests must be >= 1")

    if args.device == "cuda":
        from vcr_tpu_torch.utils import backend_probe

        ok, diag = backend_probe.ensure_backend()
        if not ok:
            backend_probe.emit_failure_json("serving tuner", "captions/s", diag)
            return 1
    if args.synthetic:
        params, spec, eos_id = synthetic_model(args.seed, args.device)
    else:
        from vcr_tpu_torch.config import Config
        from vcr_tpu_torch.serving import resolve_eos_id
        from vcr_tpu_torch.tools import load_inference_state

        cfg = Config(data_dir=args.data_dir, corpus=args.corpus,
                     glove_emb_file=args.glove_emb_file, save_path=args.save_path)
        cfg, params, spec, vocab = load_inference_state(cfg, device=args.device)
        eos_id = resolve_eos_id(spec, None, vocab)
    rates = [float(x) for x in args.rate.split(",")]
    geometries = [(r, a, s)
                  for r in map(int, args.slots.split(","))
                  for a in map(int, args.admit_chunk.split(","))
                  for s in map(int, args.step_chunk.split(","))
                  if 1 <= a <= r]
    tune(params, spec, eos_id, geometries, rates, args.n_requests, args.beam_size,
         args.seed, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
