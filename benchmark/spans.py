"""The spans stretch of a traced run: where a caption call's card time goes,
by the program's own spans.

Under ``--trace 1``, after the profiled stretch of ``core.run``, the first
reader of a spans metric runs ``profiled_requests`` more requests under the
same profiler settings (the card's activity alone) with the program's span
recorder on (``vcr_tpu_torch.utils.profiling.recording``), and keeps the
reduction as ``ctx.spans``. Spans and the profiler's events share the
host's realtime clock (``time.time_ns``), so:

* each kernel or copy is put down to the innermost span that was open on
  the launching thread when its runtime launch call started (joined by
  correlation id), else to "outside the program";
* each idle gap of the stretch (no kernel or copy on the card) is put down
  to the innermost span open at its midpoint, on any thread;
* the program's idle time is the part of the stretch in which a
  ``caption`` span is open and the card is idle;
* per request means per ``caption`` span, whose count must equal the
  requests issued.

A span is known by its path, the names from its root down to it; a reader
asks for the device time under some names (children included) or by the
innermost name. The stretch prints, per span name per request, device ms,
launches, host self ms and idle ms to standard error.

``core.run`` keeps its driver in a local, so the stretch finds the cell's
driver among the live objects (the instance of the cell's ``Driver`` built
on this context). A program without the recorder, or a run on the CPU,
gives None, and so does every reader of these metrics.
"""

from __future__ import annotations

import bisect
import gc
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.traces import LAUNCH_PREFIXES

OUTSIDE = "outside the program"
ROOT_SPAN = "caption"

Path = Tuple[str, ...]
# (index, name, start_ns, end_ns, parent index or -1, thread key)
SpanRow = Tuple[int, str, int, int, int, int]
# (start_ns, end_ns, correlation id, name)
DeviceOp = Tuple[int, int, int, str]
# (start_ns, end_ns, correlation id, name, thread key)
RuntimeCall = Tuple[int, int, int, str, int]


def thread_key(ident: int) -> int:
    """The key under which the profiler's runtime events name a thread (their
    ``device_resource_id``): its ``threading.get_ident()`` as a signed 32-bit
    number."""
    low = ident & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


class _Spans:
    """The innermost span open at a time, on one thread or on any."""

    def __init__(self, rows: Sequence[SpanRow]):
        self.rows = {r[0]: r for r in rows}
        self.paths: Dict[int, Path] = {}
        for r in sorted(rows):              # a parent opened before its children
            self.paths[r[0]] = self.paths.get(r[4], ()) + (r[1],)
        self.by_thread: Dict[int, List[SpanRow]] = defaultdict(list)
        for r in sorted(rows, key=lambda r: (r[2], r[0])):
            self.by_thread[r[5]].append(r)
        self.starts = {t: [r[2] for r in rs] for t, rs in self.by_thread.items()}

    def at(self, t: int, thread: Optional[int] = None) -> Path:
        """The path of the innermost span open at ``t`` (on ``thread``, or the
        latest-opened of every thread's), () where none is."""
        best = None
        for th in ([thread] if thread is not None else list(self.by_thread)):
            i = bisect.bisect_right(self.starts.get(th, []), t) - 1
            row = self.by_thread[th][i] if i >= 0 else None
            # spans of one thread nest: the innermost open one is the last
            # opened before t or one of its ancestors
            while row is not None and row[3] < t:
                row = self.rows.get(row[4])
            if row is not None and (best is None or row[2] > best[2]):
                best = row
        return self.paths[best[0]] if best is not None else ()


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(spans: Sequence[SpanRow], ops: Sequence[DeviceOp], calls: Sequence[RuntimeCall],
           start_ns: int, end_ns: int) -> Dict:
    """-> {"requests" (``caption`` spans), "window_ns", "busy_ns", and by span
    path: "device_ns", "launches", "idle_ns"; "program_idle_ns"} of one
    stretch from ``start_ns`` to ``end_ns``."""
    index = _Spans(spans)
    first_call: Dict[int, RuntimeCall] = {}
    for c in sorted(calls):                 # the API call before what it nests
        first_call.setdefault(c[2], c)
    device_ns: Dict[Path, int] = defaultdict(int)
    for s, e, corr, _ in ops:
        call = first_call.get(corr)
        device_ns[index.at(call[0], call[4]) if call else ()] += e - s
    launches: Dict[Path, int] = defaultdict(int)
    for c in calls:
        if c[3].startswith(LAUNCH_PREFIXES):
            launches[index.at(c[0], c[4])] += 1
    busy = _union((max(s, start_ns), min(e, end_ns)) for s, e, _, _ in ops
                  if e > start_ns and s < end_ns)
    idle = [(a, b) for a, b in zip([start_ns] + [e for _, e in busy],
                                   [s for s, _ in busy] + [end_ns]) if b > a]
    idle_ns: Dict[Path, int] = defaultdict(int)
    for a, b in idle:
        idle_ns[index.at((a + b) // 2)] += b - a
    roots = _union((r[2], r[3]) for r in spans if r[1] == ROOT_SPAN)
    return {"requests": sum(1 for r in spans if r[1] == ROOT_SPAN),
            "window_ns": end_ns - start_ns, "busy_ns": sum(e - s for s, e in busy),
            "device_ns": dict(device_ns), "launches": dict(launches),
            "idle_ns": dict(idle_ns), "program_idle_ns": _overlap(roots, idle)}


def under(by_path: Dict[Path, float], names: Iterable[str]) -> float:
    """The sum over the paths that pass through any of ``names``."""
    names = set(names)
    return sum(v for p, v in by_path.items() if names.intersection(p))


def by_innermost(by_path: Dict[Path, float]) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for p, v in by_path.items():
        out[p[-1] if p else OUTSIDE] += v
    return dict(out)


# --------------------------------------------------------------- on the card

def kineto_events(prof) -> Tuple[List[DeviceOp], List[RuntimeCall]]:
    """The card's kernels and copies, and the host's runtime and driver calls,
    of a finished ``torch.profiler`` run, on the host's realtime clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append((e.start_ns(), e.end_ns(), e.correlation_id(), e.name()))
        else:
            calls.append((e.start_ns(), e.end_ns(), e.correlation_id(), e.name(),
                          e.device_resource_id()))
    return ops, calls


def cell_driver(ctx):
    """The driver ``core.run`` built on ``ctx``, found among the live objects."""
    cls = ctx.driver_module.Driver
    # type(), not isinstance(): the latter reads __class__, which some of
    # torch's deprecated module objects answer with a warning
    return next((o for o in gc.get_objects() if type(o) is cls and o.ctx is ctx), None)


def measure(ctx) -> Optional[Dict]:
    """Run the spans stretch once -> its reduction, with "host" (the
    recorder's summary by name), "call_ms" (the stretch's length per request)
    and "host_ms" (the host's mean time inside a call); None on the CPU,
    outside a traced run, or for a program without the recorder."""
    import torch

    if not ctx.trace or ctx.profile is None or torch.device(ctx.device).type != "cuda":
        return None
    try:
        from vcr_tpu_torch.utils.profiling import recording
    except ImportError:     # a program from before the recorder
        ctx.log("spans: the program records no spans; the spans metrics are left out")
        return None
    from torch.profiler import ProfilerActivity, profile

    from benchmark import core

    driver = cell_driver(ctx)
    if driver is None:
        raise RuntimeError(f"no live {ctx.driver_module.__name__}.Driver built on this run")
    start = ctx.window["start"] + ctx.window["requests"] + ctx.profile["requests"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as rec:
        window = core.closed_loop(driver, start, count=ctx.mix["profiled_requests"])
        end_ns = time.time_ns()
    ops, calls = kineto_events(prof)
    rows = [(s.index, s.name, s.start_ns, s.end_ns, s.parent, thread_key(s.thread))
            for s in rec.closed()]
    start_ns = min((r[2] for r in rows if r[1] == ROOT_SPAN), default=end_ns)
    out = reduce(rows, ops, calls, start_ns, end_ns)
    if out["requests"] != window["requests"]:
        raise RuntimeError(f"the spans stretch issued {window['requests']} requests but "
                           f"recorded {out['requests']} {ROOT_SPAN!r} spans")
    out["host"] = rec.summary()
    out["call_ms"] = window["window_s"] * 1e3 / window["requests"]
    out["host_ms"] = statistics.fmean(window["host_s"]) * 1e3
    _log_table(ctx, out)
    return out


def measured(ctx) -> Optional[Dict]:
    """``ctx.spans``, measured on first use."""
    if not hasattr(ctx, "spans"):
        ctx.spans = measure(ctx)
    return ctx.spans


def device_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms per request under any of the spans ``names``, children
    included."""
    s = measured(ctx)
    if s is None or not s["requests"]:
        return None
    return under(s["device_ns"], names) / 1e6 / s["requests"]


def _log_table(ctx, s: Dict) -> None:
    n = s["requests"]
    dev, idle = by_innermost(s["device_ns"]), by_innermost(s["idle_ns"])
    launches = by_innermost(s["launches"])
    host = {k: v["self_ms"] for k, v in s["host"].items()}
    names = sorted(set(dev) | set(idle) | set(launches) | set(host),
                   key=lambda k: -dev.get(k, 0.0))
    total = sum(s["device_ns"].values())
    ctx.log(f"spans: {n} requests; per request: window {s['window_ns'] / 1e6 / n:.3f} ms, "
            f"busy {s['busy_ns'] / 1e6 / n:.3f} ms, device ops {total / 1e6 / n:.3f} ms, "
            f"{under(s['device_ns'], [ROOT_SPAN]) / max(total, 1):.4%} of them under "
            f"{ROOT_SPAN!r}, program idle {s['program_idle_ns'] / 1e6 / n:.3f} ms")
    ctx.log(f"spans: recorder on: {s['call_ms']:.3f} ms a request, {s['host_ms']:.3f} ms "
            f"of host time inside the call; recorder off: "
            f"{ctx.profile['window_s'] * 1e3 / ctx.profile['requests']:.3f} ms a request "
            f"(the profiled stretch), {statistics.fmean(ctx.window['host_s']) * 1e3:.3f} ms "
            f"inside the call (the unprofiled window)")
    ctx.log(f"spans: {'span':<22} {'device ms':>10} {'launches':>9} {'host self ms':>13} "
            f"{'idle ms':>9}  (per request, by innermost span)")
    for k in names:
        ctx.log(f"spans: {k:<22} {dev.get(k, 0.0) / 1e6 / n:10.4f} "
                f"{launches.get(k, 0) / n:9.2f} {host.get(k, 0.0) / n:13.4f} "
                f"{idle.get(k, 0.0) / 1e6 / n:9.4f}")
