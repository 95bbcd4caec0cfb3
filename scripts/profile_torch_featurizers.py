"""Where the time of the port's featurizers goes, on one CUDA card.

    python scripts/profile_torch_featurizers.py [--backbone vgg16|resnet34|darknet]
        [--calls 2] [--gap_frames 8]

Runs each backbone of the fused featurizers (VGG16 to fc7 and ResNet-34 at
224x224, Darknet-53 with YOLOv3's first head at 416x416, random weights from
a seed) in bf16 on chip_smoke.py phase 14's frames (240, 480 and 60 frames)
and prints JSON lines:

* the backbone call under torch.profiler: wall ms per call, the card's busy
  ms and idle share, the convolution kernels' ms (cuDNN's) against all the
  other kernels' (the float32 passes around each conv: up-cast, bias or
  BatchNorm, activation, down-cast, pools), the kernels by device time;
* two conv routes side by side, the backbone's ms of each (CUDA events,
  best of 3 after a warm-up, in turns) and its features' largest gap
  against the CPU on ``--gap_frames`` frames, relative to the largest
  |feature|: "bf16" is the package's (``nn.layers.conv2d_f32``: cuDNN on
  bf16 operands, whose output is rounded to bf16), "tf32_of_bf16" a cuDNN
  float32 conv with TF32 on, of the bf16-rounded operands up-cast (TF32
  holds a bf16 value exactly, so its products are exact and its sums
  float32: the JAX package's ``preferred_element_type=float32``), timed here
  only.

Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

FRAMES = {"vgg16": (240, 224), "resnet34": (480, 224), "darknet": (60, 416)}


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


def best_ms(fn, reps: int = 3) -> float:
    fn()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def tf32_of_bf16(x, w, stride=1, padding=0, compute_dtype=torch.bfloat16):
    """The alternative route: bf16-rounded operands, up-cast, one cuDNN
    float32 conv with TF32 on; a float32 result, no second rounding."""
    xc, wc = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return F.conv2d(xc, wc, stride=stride, padding=padding)
    finally:
        torch.backends.cudnn.allow_tf32 = old


def backbone(name):
    """(featurize(params, frames), params on the CPU)."""
    from vcr_tpu_torch.models import darknet, resnet, vgg

    gen = torch.Generator().manual_seed(0)
    if name == "vgg16":
        return vgg.extract_fc7, vgg.init_params(gen)
    if name == "resnet34":
        return resnet.extract_features, resnet.init_params(gen, "resnet34")
    blocks = darknet.parse_cfg_text(darknet.yolov3_first_head_cfg(FRAMES[name][1]))
    net = darknet.Darknet.from_blocks(blocks, darknet.init_params(gen, blocks), None)
    return (lambda p, x, cd: net.get_feats(x, cd, params=p)), net.params


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", choices=sorted(FRAMES), default=None)
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--gap_frames", type=int, default=8)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_featurizers: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.nn import layers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    package_conv = layers.conv2d_f32
    routes = {"bf16": package_conv, "tf32_of_bf16": tf32_of_bf16}
    for name in [args.backbone] if args.backbone else sorted(FRAMES):
        n, size = FRAMES[name]
        featurize, params_cpu = backbone(name)
        params = params_to(params_cpu, "cuda")
        g = torch.Generator(device="cuda").manual_seed(14)
        frames = torch.randn((n, 3, size, size), generator=g, device="cuda").to(
            torch.bfloat16)

        def run():
            with torch.inference_mode():
                featurize(params, frames, torch.bfloat16)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.calls):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
        by_name = {}
        for e in kernels:
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, k + 1)
        conv_words = ("conv", "xmma", "implicit", "cudnn", "sm90_", "wgrad", "dgrad")
        conv_ms = sum(ms for k, (ms, _) in by_name.items()
                      if any(w in k.lower() for w in conv_words))
        all_ms = sum(ms for ms, _ in by_name.values())
        print(json.dumps({"backbone": name, "frames": n, "image_size": size,
                          "calls": args.calls,
                          "wall_ms_per_call": wall_us / 1e3 / args.calls,
                          "kernel_busy_ms_per_call": busy / 1e3 / args.calls,
                          "device_idle_share": 1.0 - busy / wall_us,
                          "conv_kernel_ms_per_call": conv_ms / args.calls,
                          "other_kernel_ms_per_call": (all_ms - conv_ms) / args.calls,
                          "kernels_per_call": len(kernels) / args.calls,
                          "nvidia_smi": smi}), flush=True)
        for k, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
            print(json.dumps({"backbone": name, "kernel": k[:90],
                              "ms_per_call": ms / args.calls,
                              "launches_per_call": cnt / args.calls}), flush=True)

        # the two conv routes, in turns, and each one's gap against the CPU
        x_gap = frames[:args.gap_frames]
        with torch.inference_mode():
            want = featurize(params_cpu, x_gap.float().cpu(), torch.bfloat16)
        result = {}
        for route in ("bf16", "tf32_of_bf16", "tf32_of_bf16", "bf16"):
            layers.conv2d_f32 = routes[route]
            try:
                ms = best_ms(run)
                with torch.inference_mode():
                    got = featurize(params, x_gap, torch.bfloat16).float().cpu()
            finally:
                layers.conv2d_f32 = package_conv
            gap = ((got - want).abs().max() / want.abs().max()).item()
            result.setdefault(route, {"ms": [], "feature_rel_gap": gap})["ms"].append(ms)
        print(json.dumps({"backbone": name, "frames": n, "routes": result,
                          "gap_frames": args.gap_frames, "nvidia_smi": smi}), flush=True)
        del params, frames
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
