"""Run one cell of the benchmark once, on the card this machine holds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics; ``--trace 1`` measures its per-layer metrics: the same window
unprofiled (host time per request, MFU), then a short stretch under
``torch.profiler`` (launches, idle share, rooflines). Either way the window's
output is then checked against the plain reference (``benchmark/reference``),
each number compared is printed beside its limit as the last lines of
standard error, and the last line of standard output is the result: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``.

It exits with 2, printing no result, where there is no card or fewer than
the cell asks for, or where the program under test (``vcr_tpu_torch``) is
not beside this folder; with 3 where JAX, Flax or the JAX package was loaded.
Build caches (the kernels', Triton's, Python's bytecode) stay inside the
checkout, at fixed paths under ``.bench_cache/`` and the program's own
``vcr_tpu_torch/_kernels_build/``.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The wall-clock time at which this process started (Linux's
    /proc/self/stat), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Python's compiled bytecode of everything the run imports (torch's thousands
# of modules included) is kept inside the checkout, at a fixed path, so that
# only a checkout's first run compiles it
sys.pycache_prefix = str(ROOT / ".bench_cache" / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

# run as a script, this folder heads sys.path, where its modules would shadow
# others of the same name
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if importlib.util.find_spec("vcr_tpu_torch") is None:
        log(f"the program under test, vcr_tpu_torch, is not in {ROOT}")
        return 2
    import torch

    from benchmark import core

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no workload named {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.set_num_threads(2)
    ctx = core.build_context(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), bench=bench)
    result = core.run(ctx, T_START, log)
    bad = core.forbidden_modules()
    if bad:
        log(f"modules that the run may not load were loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
