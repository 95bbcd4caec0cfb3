"""Where the time of the port's HTTP caption daemon goes, on one CUDA card.

    python scripts/profile_torch_daemon.py [--slots 512] [--admit 64]
        [--requests 1024] [--threads 32] [--batch 256]
        [--switch-intervals 0.005 0.0005] [--profile-seconds 2]

Starts a CaptionServer on port 0 over the flagship S2VT's continuous pool
(vcr_tpu_torch.entry.FLAGSHIP, random weights from a seed, bf16), and sends
it chip_smoke.py phase 11's load from a client process of its own:
``--requests`` POST /caption from ``--threads`` CaptionClient threads and
one POST /caption_batch of ``--batch`` rows, (30, 4096) features each. One
load per interpreter switch interval (``sys.setswitchinterval``, the
longest a thread waits for the interpreter lock before it asks for it
back), in turns, each interval twice. For each load it prints one JSON
line: captions/s, the scheduler's rounds (ticks) and admission chunks, and
the host-clock seconds the scheduler thread spent in each of the pool's
operations (encode_admit, tick, poll_active, read_tokens), the rest of the
wall being its request source and cancel sweeps. Last, a POST /profile of
``--profile-seconds`` in the middle of one more load at the default
interval: the card's busy share over the capture (the union of kernel
intervals), kernels and rounds in it. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed_ops(pool, seconds: dict) -> None:
    """Wrap the pool's scheduler operations to add their host-clock seconds
    into ``seconds`` (one scheduler thread calls them)."""
    for name in ("encode_admit", "tick", "poll_active", "read_tokens"):
        fn = getattr(pool, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t
        setattr(pool, name, timed)


def run_load(url: str, args, frames: int, width: int) -> dict:
    from chip_smoke import LOAD_CLIENT

    out = subprocess.run(
        [sys.executable, "-c", LOAD_CLIENT, url] + [str(x) for x in (
            args.requests, args.threads, args.batch, 11, frames, width)],
        cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    return json.loads(out.stdout)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=512)
    ap.add_argument("--admit", type=int, default=64)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--switch-intervals", type=float, nargs="+", default=[0.005, 0.0005])
    ap.add_argument("--profile-seconds", type=float, default=2.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_daemon: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from profile_torch_s2vt import busy_us
    from vcr_tpu_torch import entry
    from vcr_tpu_torch.client import CaptionClient
    from vcr_tpu_torch.server import CaptionServer
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
    frames, width = spec.num_frames, spec.vid_feat_size
    warm = np.random.default_rng(0).standard_normal((frames, width), dtype=np.float32)
    default_interval = sys.getswitchinterval()
    seconds: dict = {}
    pool = ContinuousCaptioner(params, spec, slots=args.slots, admit_chunk=args.admit)
    timed_ops(pool, seconds)
    with tempfile.TemporaryDirectory() as tmp, \
            CaptionServer(pool, port=0, profile_dir=tmp) as server:
        url = f"http://127.0.0.1:{server.port}"
        client = CaptionClient(url, timeout_s=600, retries=0)
        client.caption(warm)
        for interval in args.switch_intervals * 2:
            sys.setswitchinterval(interval)
            before, seconds_before = client.health(), dict(seconds)
            load = run_load(url, args, frames, width)
            after = client.health()
            rows = len(load["singles"]) + len(load["batch"])
            print(json.dumps({
                "switch_interval_s": interval, "slots": args.slots, "admit_chunk": args.admit,
                "seconds": load["seconds"], "captions_per_s": rows / load["seconds"],
                "ticks": after["ticks"] - before["ticks"],
                "admit_chunks": after["admit_chunks"] - before["admit_chunks"],
                "scheduler_seconds": {k: v - seconds_before.get(k, 0.0)
                                      for k, v in seconds.items()},
                "nvidia_smi": smi}), flush=True)
        sys.setswitchinterval(default_interval)

        # a capture in the middle of one more load
        result, before = {}, client.health()
        loader = threading.Thread(target=lambda: result.update(
            run_load(url, args, frames, width)))
        loader.start()
        time.sleep(2.0)
        with urllib.request.urlopen(urllib.request.Request(
                f"{url}/profile?seconds={args.profile_seconds}", data=b""),
                timeout=args.profile_seconds + 60) as r:
            capture = json.load(r)
        during = client.health()
        loader.join()
        with open(os.path.join(capture["trace_dir"], "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ops = [e for e in events if e.get("cat") == "cpu_op"]
        span_us = (max(e["ts"] + e.get("dur", 0) for e in ops + kernels)
                   - min(e["ts"] for e in ops + kernels)) if ops + kernels else 0.0
        busy = busy_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
        print(json.dumps({
            "profile_seconds": args.profile_seconds, "trace_span_ms": span_us / 1e3,
            "kernel_busy_ms": busy / 1e3,
            "device_busy_share": busy / span_us if span_us else None,
            "kernels": len(kernels), "cpu_ops": len(ops),
            "ticks_by_then": during["ticks"] - before["ticks"],
            "load_captions_per_s": (len(result["singles"]) + len(result["batch"]))
            / result["seconds"], "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
