"""The reduction of a ``torch.profiler`` trace of the profiled stretch to what
the per-layer metrics read: device busy time (the union of every kernel's and
copy's interval), device time by kernel name, the host's launch calls, and
the breakdown the result line carries.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict

from benchmark.arith import union_length

# host calls that put work on the card: kernel launches, whatever API, and
# graph launches
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def short_name(name: str, width: int = 90) -> str:
    """A kernel's name without its return type and parameter list, cut to
    ``width`` characters (its template arguments, which name the functor of
    PyTorch's elementwise kernels, are kept)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def reduce(prof, window_s: float, top: int = 10) -> Dict:
    """-> {"busy_s", "window_s", "kernel_s" {name: seconds}, "launches",
    "device_ops" [[name, s]], "idle_gaps" [[what the host did, s]]} of a
    finished profile of the card's activity (kernels, copies, and the host's
    CUDA runtime and driver calls). An idle gap is named after the runtime
    call in flight at its midpoint (a copy or a synchronise), else after the
    device operation that ends it: the host was busy before launching it."""
    import torch

    device, host = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(e)
        else:
            host.append(e)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device)
    kernel_s: Dict[str, float] = defaultdict(float)
    for start, end, name in spans:
        kernel_s[name] += (end - start) / 1e6
    launches = sum(1 for e in host if e.name.startswith(LAUNCH_PREFIXES))
    calls = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                   if not e.name.startswith(LAUNCH_PREFIXES))
    starts = [c[0] for c in calls]
    gaps: Dict[str, float] = defaultdict(float)
    reach = None
    for start, end, name in spans:
        if reach is not None and start > reach:
            mid = (reach + start) / 2
            i = bisect.bisect_right(starts, mid) - 1
            what = (calls[i][2] if i >= 0 and calls[i][1] >= mid
                    else "host, before " + short_name(name))
            gaps[what] += (start - reach) / 1e6
        reach = end if reach is None else max(reach, end)
    by = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_length((s, e) for s, e, _ in spans) / 1e6,
            "window_s": window_s, "kernel_s": dict(kernel_s), "launches": launches,
            "device_ops": by(kernel_s), "idle_gaps": by(gaps)}
