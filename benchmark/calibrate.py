"""The readings that a cell's limits are set from, on the card at the cell's
own size: the numbers its check compares, over many seeds, for the program
and for what is put in its place (the control, a planted fault).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--variants program,control,half,frozen] [--requests 4] [--margins]

A variant is "program", "control" (the driver puts the reference, at the
control's precision, in the program's place) or a fault of ``FAULTS``,
planted in the program from outside by wrapping the driver's ``issue``.
One process reads every seed of every variant, so the card's set-up is paid
once. A seed's run is the benchmark's own: set-up from the seed, ``--requests``
requests of the window's call, then the check. ``--margins`` adds, for a
cell with a frame selector, the widest departure of the selection margins
computed with bf16 operands from the float32 reference's. Each reading is
one JSON line on standard output. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
sys.path.insert(0, str(ROOT))


def half_batch(driver) -> None:
    """A training step that sees the first half of its batch, the mean taken
    over it."""
    issue = driver.issue

    def call(i):
        k = i % len(driver.batches)
        whole = driver.batches[k]
        driver.batches[k] = {n: x[: x.shape[0] // 2] for n, x in whole.items()}
        try:
            return issue(i)
        finally:
            driver.batches[k] = whole
    driver.issue = call


def frozen_state(driver) -> None:
    """A training step that leaves the parameters as they were."""
    import torch

    issue = driver.issue

    def call(i):
        before = [leaf.detach().clone() for leaf in driver.opt_state.leaves]
        out = issue(i)
        with torch.no_grad():
            for leaf, old in zip(driver.opt_state.leaves, before):
                leaf.copy_(old)
        return out
    driver.issue = call


FAULTS = {"half": half_batch, "frozen": frozen_state}


def readings(workload: str, seed: int, variant: str, device, requests: int = 4,
             log=None):
    """One seed's run of ``workload`` with ``variant`` in the program's place
    -> (the check's numbers by name, the driver)."""
    import torch

    from benchmark import core

    ctx = core.build_context(workload, seed, 0.0, False, device,
                             variant="control" if variant == "control" else None)
    if log is not None:
        ctx.log = log
    driver = ctx.driver_module.Driver(ctx)
    if variant in FAULTS:
        FAULTS[variant](driver)
    elif variant not in ("program", "control"):
        raise ValueError(f"unknown variant {variant!r}")
    driver.setup()
    if ctx.mix["kind"] == "train" and variant == "control":
        window = {"start": 0, "requests": 0, "failed": 0}   # the reference trains alone
    else:
        window = core.closed_loop(driver, driver.next_request, count=requests)
    driver.release()
    torch.cuda.empty_cache()
    return {c["name"]: c["value"] for c in driver.check(window)}, driver


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variants", default="program")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--margins", action="store_true")
    args = p.parse_args(argv)
    import torch

    from benchmark.reference.common import exact_float32

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            got, driver = readings(args.workload, seed, variant, dev, args.requests,
                                   log=lambda line: print(line, file=sys.stderr, flush=True))
            line = {"workload": args.workload, "variant": variant, "seed": seed,
                    "checks": got, "seconds": time.time() - t0}
            ctx = driver.ctx
            if args.margins and ctx.model["arch"] == "rationale":
                sd = {k: v.to(dev) for k, v in driver.sd.items()}
                with torch.no_grad(), exact_float32():
                    f, n = driver.feats[0], driver.noise[0]
                    a = ctx.reference.margins(sd, ctx.model, f, n, "fp32")
                    b = ctx.reference.margins(sd, ctx.model, f, n, "bf16")
                line["margin_bf16_max"] = float((a - b).abs().max())
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
