"""One run of one cell: find its files by name, set up, measure a closed-loop
window, optionally profile a short stretch, check what the window produced
against the plain reference, and print the result line.

Everything that belongs to one thing lives in a file named after it, under
this folder, and is found by that name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<traffic>.json``: a traffic mix, whose ``kind`` names its
  driver ``traffic/<kind>.py`` (a class ``Driver``);
* ``workloads/<cell>.json``: the cell's sample sizes and the limits of the
  numbers its check compares;
* ``metrics/<metric>.py``: the reader of one metric (``read(ctx)``, None
  where it finds nothing to read); ``<quantity>.serve`` and
  ``<quantity>.train`` share ``metrics/<quantity>.py`` where they have no
  file of their own;
* ``reference/<arch>.py``: the plain reference of a model family.

``BENCHMARK.json`` at the root names the cells and which metrics each
reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, Optional

from benchmark import arith

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vcr_tpu")


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r}: {path} is missing")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """The module ``<base>/<kind>/<name>.py``, loaded by its path (names may
    hold dots)."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r}: {path} is missing")
    mod_name = f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, where a name
    ``<quantity>.<suffix>`` has no file of its own, the quantity's shared
    ``metrics/<quantity>.py``."""
    own = (base / "metrics" / f"{name}.py").is_file()
    return load_module("metrics", name if own else name.split(".")[0], base)


def reference_module(arch: str) -> ModuleType:
    return importlib.import_module(f"benchmark.reference.{arch}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics ``cell`` reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones. A metric with ``workloads`` is reported in
    those cells; a per-layer metric without it in every cell that reports
    the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Context(SimpleNamespace):
    """What the drivers and the metric readers share: the cell's files
    (``bench``, ``entry``, ``model``, ``mix``, ``cell``), the run's
    arguments, the device, and the readings as they come (``setup_s``,
    ``window``, ``profile``, ``flops_per_request``, ``peaks``)."""


def build_context(workload: str, seed: int, seconds: float, trace: bool, device,
                  bench: Optional[dict] = None, base: Path = HERE,
                  variant: Optional[str] = None) -> Context:
    bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    entry = entries[0]
    model = load_json("configs", entry["config"], base)
    mix = load_json("traffic", entry["traffic"], base)
    return Context(bench=bench, entry=entry, model=model, mix=mix,
                   cell=load_json("workloads", workload, base), base=base,
                   workload=workload, seed=seed, seconds=seconds, trace=trace,
                   device=device, variant=variant,
                   reference=reference_module(model["arch"]),
                   driver_module=load_module("traffic", mix["kind"], base),
                   window=None, profile=None, peaks=None, setup_s=None,
                   log=lambda line: None)


def closed_loop(driver, start: int, seconds: Optional[float] = None,
                count: Optional[int] = None) -> Dict:
    """Requests ``start``, ``start + 1``, ... one after another until
    ``seconds`` have passed on the host's clock or ``count`` requests were
    issued, then a synchronise: every request issued counts, and the
    window closes when the last one is done.

    -> {"requests", "window_s", "host_s" (each request's time inside the
    program's call), "latency_s" (issue to result on the host; for a driver
    that does not wait per request, issue to the end of its call), "start",
    "failed"}."""
    sync = getattr(driver, "sync", lambda: None)
    sync()
    t0 = time.perf_counter()
    host, latency, failed, i = [], [], 0, start
    while True:
        ts = time.perf_counter()
        try:
            out = driver.issue(i)
            th = time.perf_counter()
            driver.complete(i, out)
        except Exception:  # a failed request is counted, not fatal
            failed += 1
            th = time.perf_counter()
            traceback.print_exc()
        te = time.perf_counter()
        host.append(th - ts)
        latency.append(te - ts)
        i += 1
        if (count is not None and i - start >= count) or (
                seconds is not None and te - t0 >= seconds):
            break
    sync()
    return {"requests": i - start, "window_s": time.perf_counter() - t0, "host_s": host,
            "latency_s": latency, "start": start, "failed": failed}


def read_metrics(ctx: Context, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], ctx.base).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def profiled(driver, start: int, count: int) -> Dict:
    """``count`` requests under ``torch.profiler`` -> the trace's reduction
    (``traces.reduce``) plus "requests". Only the card's activity is
    recorded: its kernels and copies and the host's CUDA calls (recording
    every host operator as well doubled a greedy call's time)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import traces

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window = closed_loop(driver, start, count=count)
    out = traces.reduce(prof, window["window_s"])
    out["requests"] = window["requests"]
    return out


def run(ctx: Context, t_start: float, log: Callable[[str], None]) -> Dict:
    """Set up, measure, profile where asked, check -> the result dict, the
    numbers compared last under ``checks``."""
    import torch

    cuda = torch.device(ctx.device).type == "cuda"
    ctx.log = lambda line: log(f"[{time.time() - t_start:8.3f} s] {line}")
    if cuda:
        log(f"card: {power_limit()}")
    driver = ctx.driver_module.Driver(ctx)
    driver.setup()
    ctx.flops_per_request = driver.flops_per_request
    ctx.units_per_request = driver.units_per_request
    ctx.setup_s = time.time() - t_start
    log(f"setup_s {ctx.setup_s:.3f}")
    ctx.window = closed_loop(driver, driver.next_request, seconds=ctx.seconds)
    log(f"window: {ctx.window['requests']} requests in {ctx.window['window_s']:.3f} s")
    next_request = driver.next_request + ctx.window["requests"]
    if ctx.trace:
        ctx.profile = profiled(driver, next_request, ctx.mix["profiled_requests"])
    kind = torch.cuda.get_device_name(ctx.device) if cuda else "cpu"
    ctx.peaks = arith.card_peaks(kind)
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": ctx.entry["chips"], "memory_peak_bytes": int(peak)}
    metrics = read_metrics(ctx, cell_metrics(ctx.bench, ctx.workload, ctx.trace))
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(ctx.window)
    failed = ctx.window["failed"]
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": ctx.window["requests"], "failed": failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = ctx.profile["busy_s"]
        device["window_s"] = ctx.profile["window_s"]
        result["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                               "idle_gaps": ctx.profile["idle_gaps"]}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result
