"""Token agreement of ResNet-34 -> S2VT-att on one CUDA card against the CPU,
under the two routes of the backbones' bf16 conv.

    python scripts/featurizer_token_agreement.py [--videos 16]

chip_smoke.py phase 14's ResNet-34 -> S2VT-att case (seeded random weights,
``--videos`` videos of 30 frames at 224x224 in bf16, the frames of its
seed) is captioned on the CPU, whose conv is the JAX package's arithmetic
(a float32 conv of the bf16-rounded operands, unrounded), and on the card
under each route, in turns:

* "bf16": the package's ``nn.layers.conv2d_f32``, cuDNN on bf16 operands,
  whose output cuDNN rounds to bf16 (one rounding per layer more than JAX);
* "tf32_of_bf16": the bf16-rounded operands up-cast and one cuDNN float32
  conv with TF32 on (TF32 holds a bf16 value exactly, so the products are
  exact and the sums float32).

Prints one JSON line per route: the token agreement with the CPU over all
videos, the rows equal, the features' largest gap relative to the largest
|feature|, and the backbone's best ms (CUDA events), with nvidia-smi's name
and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from profile_torch_featurizers import tf32_of_bf16  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--videos", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("featurizer_token_agreement: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import resnet
    from vcr_tpu_torch.nn import layers
    from vcr_tpu_torch.utils.benchutil import time_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    spec, params = entry.make_spec_and_params(**entry.S2VT_ATT, device="cuda")
    fp_cpu = resnet.init_params(torch.Generator().manual_seed(0), "resnet34")
    fp = params_to(fp_cpu, "cuda")
    g = torch.Generator(device="cuda").manual_seed(14)
    frames = torch.randn((args.videos, spec.num_frames, 3, 224, 224), generator=g,
                         device="cuda").to(torch.bfloat16)
    x_cpu = frames.float().cpu()
    featurize = serving.make_featurize(spec, "resnet")
    with torch.inference_mode():
        want_feats = featurize(fp_cpu, x_cpu)
        want = serving.build_captioner(params_to(params, "cpu"), spec, "resnet", fp_cpu,
                                       device="cpu")(x_cpu)
    package_conv = layers.conv2d_f32
    routes = {"bf16": package_conv, "tf32_of_bf16": tf32_of_bf16}
    caption = serving.build_captioner(params, spec, "resnet", fp, device="cuda")
    result = {}
    for route in ("bf16", "tf32_of_bf16", "tf32_of_bf16", "bf16"):
        layers.conv2d_f32 = routes[route]
        try:
            with torch.inference_mode():
                tokens = caption(frames).cpu()
                feats = featurize(fp, frames).float().cpu()
                ms = time_ms(lambda: featurize(fp, frames))
        finally:
            layers.conv2d_f32 = package_conv
        rec = result.setdefault(route, {
            "token_agreement": (tokens == want).float().mean().item(),
            "rows_equal": int((tokens == want).all(dim=1).sum()),
            "feature_rel_gap": ((feats - want_feats).abs().max()
                                / want_feats.abs().max()).item(),
            "backbone_ms": []})
        rec["backbone_ms"].append(ms)
    for route, rec in result.items():
        print(json.dumps({"route": route, "videos": args.videos,
                          "tokens": args.videos * spec.max_len, **rec,
                          "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
