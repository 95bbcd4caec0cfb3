"""Where the time of the port's captioners goes, on one CUDA card.

    python scripts/profile_torch_s2vt.py
        [--model s2vt|rationale|s2vt-att|spatial|transformer] [--train]
        [--batch N] [--calls 3]

Builds the flagship S2VT greedy captioner (vcr_tpu_torch.entry.FLAGSHIP),
RationaleNet over it (entry.RATIONALE), S2VT-att (entry.S2VT_ATT),
SpatialNet over S2VT (entry.SPATIAL, on (30, 1024, 13, 13) grid features)
or the Transformer (entry.TRANSFORMER, its KV-cached greedy decode), with
random weights from a seed, at its serving batch (2048, 1024, 1024, 64 and
512) unless ``--batch`` says otherwise, warms it up, then runs ``--calls``
captioner calls under torch.profiler. With ``--train`` a call is one train
step instead (train.step.build_step_fns, Adam with the clip, static tf=1.0,
bench_train.py's batch of 1024, 512, 1024, 16 and 128 drawn on the card). Prints
JSON lines: the wall time per call, the share of that time in which the
card ran no kernel (the union of kernel intervals against the host clock),
the peak device memory of a call, and the kernels by device time per
call; for SpatialNet's serving call also the peak of its conv trunk alone,
beside the bytes of the trunk's input and output. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="s2vt",
                    choices=("s2vt", "rationale", "s2vt-att", "spatial", "transformer"))
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_s2vt: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from vcr_tpu_torch import entry, serving

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    config, default_batch = {"s2vt": (entry.FLAGSHIP, 1024 if args.train else 2048),
                             "rationale": (entry.RATIONALE, 512 if args.train else 1024),
                             "s2vt-att": (entry.S2VT_ATT, 1024),
                             "spatial": (entry.SPATIAL, 16 if args.train else 64),
                             "transformer": (entry.TRANSFORMER, 128 if args.train else 512),
                             }[args.model]
    batch = args.batch or default_batch
    spec, params = entry.make_spec_and_params(**config, device="cuda")
    grid = (spec.grid_size,) * 2 if args.model == "spatial" else ()
    extra = {}
    if args.train:
        from vcr_tpu_torch.train import optim, step

        opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
        state = opt.init(params)
        train, _ = step.build_step_fns(args.model, spec, opt, static_tf=1.0)
        g = torch.Generator(device="cuda").manual_seed(0)
        data = {"vid_feats": torch.randn((batch, spec.num_frames, spec.vid_feat_size, *grid),
                                         generator=g, device="cuda").to(
                                             torch.float32 if grid else spec.cdtype),
                "sent": torch.randint(0, spec.vocab_size, (batch, spec.max_len),
                                      generator=g, device="cuda", dtype=torch.int32),
                "sent_len": torch.full((batch,), 12, dtype=torch.int32, device="cuda"),
                "valid": torch.ones((batch,), device="cuda")}

        def run():
            train(params, state, data, 0, 1.0)
    else:
        feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (batch, spec.num_frames, spec.vid_feat_size, *grid)).astype(np.float32)).cuda()
        caption = serving.build_captioner(params, spec)

        def run():
            caption(feats)
        if grid:
            from vcr_tpu_torch.models import spatial

            frames = feats.reshape(-1, spec.vid_feat_size, *grid)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.inference_mode():
                out, _ = spatial.conv_trunk(params, spec, frames, False)
                torch.cuda.synchronize()
            extra = {"conv_trunk_peak_bytes_above_start": torch.cuda.max_memory_allocated()
                     - base, "conv_trunk_input_bytes": frames.numel() * 4,
                     "conv_trunk_output_bytes": out.numel() * 4}
            del out
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    extra["peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    print(json.dumps({"model": args.model, "train": args.train, "batch": batch,
                      "calls": args.calls,
                      "wall_ms_per_call": wall_us / 1e3 / args.calls,
                      "kernel_busy_ms_per_call": busy / 1e3 / args.calls,
                      "device_idle_share": 1.0 - busy / wall_us,
                      "kernels_per_call": len(kernels) / args.calls, **extra,
                      "nvidia_smi": smi}))
    for name, (ms, n) in top:
        print(json.dumps({"kernel": name[:90], "ms_per_call": ms / args.calls,
                          "launches_per_call": n / args.calls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
