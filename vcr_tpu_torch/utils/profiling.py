"""Profiling and tracing hooks: the counterpart of
``vcr_tpu/utils/profiling.py``.

* :func:`span` -- a named span at a layer boundary of the program: the
  caption call (``caption``), its ``encode`` and ``prime``, each decode
  step's ``decode.cell``, ``decode.pick`` and ``decode.reorder``, the train
  step and its forward, backward and optimizer, the slot pool's admission,
  tick, poll and harvest. With no recorder on, it returns one shared no-op
  context manager after a single check: no clock read, no tensor read, no
  ``record_function``.
* :func:`recording` -- turns a :class:`Recorder` on for its block. The
  recorder keeps each span in memory: its name, its start and end on the
  host's realtime clock (``time.time_ns``, the clock of ``torch.profiler``'s
  events, so spans and kernel launches share one timeline), its parent on
  its own thread's stack, the id of its root, its thread and its attrs.
* :func:`trace` -- a ``torch.profiler`` run over its block, with the
  recorder on, that writes a Chrome trace (``trace.json``) holding the spans
  under ``VCR_TRACE_DIR`` or a given path.
* :class:`StepTimer` -- per-step wall-clock statistics (EMA and
  percentiles) for the train loop, reported through the logger.

This module imports torch only inside :func:`trace`, so the host-side
scheduler can span its rounds without loading it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

_recorder: Optional["Recorder"] = None
_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A span named ``name`` over a ``with`` block, recorded when a
    :func:`recording` is on; ``attrs`` are kept as given (never computed
    from a tensor's value)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return Span(rec, name, attrs)


class Span:
    """One recorded span; ``parent`` is the index of the enclosing span of
    the same thread in :attr:`Recorder.spans` (-1 for a root), ``root`` the
    id its root took, ``thread`` the thread's ``threading.get_ident()`` and
    ``tid`` its native id. ``end_ns`` is None while it is open."""

    __slots__ = ("rec", "name", "attrs", "index", "parent", "root", "thread", "tid",
                 "start_ns", "end_ns")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.end_ns = None

    def __enter__(self) -> "Span":
        rec = self.rec
        local = rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.ident, local.tid = threading.get_ident(), threading.get_native_id()
        if stack:
            self.parent, self.root = stack[-1].index, stack[-1].root
        else:
            self.parent, self.root = -1, next(rec._roots)
        self.thread, self.tid = local.ident, local.tid
        with rec._lock:
            self.index = len(rec.spans)
            rec.spans.append(self)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        self.rec._local.stack.pop()
        return False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Recorder:
    """The spans of one :func:`recording`, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._roots = itertools.count(1)

    def closed(self) -> List[Span]:
        return [s for s in self.spans if s.end_ns is not None]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """-> {name: {"count", "total_ms", "self_ms"}} over the closed spans;
        a span's self time is its duration less what its children cover
        (children run on their parent's thread, inside it, one at a time)."""
        closed = self.closed()
        covered: Dict[int, int] = defaultdict(int)
        for s in closed:
            if s.parent >= 0:
                covered[s.parent] += s.duration_ns
        out: Dict[str, Dict[str, float]] = {}
        for s in closed:
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += s.duration_ns / 1e6
            row["self_ms"] += max(s.duration_ns - covered[s.index], 0) / 1e6
        return out

    def chrome_events(self, base_ns: int = 0) -> List[dict]:
        """The closed spans as Chrome-trace complete events, their times in
        microseconds after ``base_ns``."""
        pid = os.getpid()
        return [{"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
                 "ts": (s.start_ns - base_ns) / 1e3, "dur": s.duration_ns / 1e3,
                 "args": {"root": s.root, "parent": s.parent, **s.attrs}}
                for s in self.closed()]


@contextlib.contextmanager
def recording():
    """Record every :func:`span` of every thread while the block runs;
    yields the :class:`Recorder`."""
    global _recorder
    rec, previous = Recorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = previous


def add_spans_to_chrome_trace(path: str, rec: Recorder) -> None:
    """Append ``rec``'s spans to the Chrome trace that ``torch.profiler``
    wrote at ``path``, on its timeline (its events' ``ts`` count from
    ``baseTimeNanoseconds``)."""
    with open(path) as f:
        data = json.load(f)
    data.setdefault("traceEvents", []).extend(
        rec.chrome_events(int(data.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(data, f, default=str)


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """Profile the block (host, and the card where there is one), with the
    span recorder on, when ``trace_dir`` or ``VCR_TRACE_DIR`` names a
    directory; else do nothing."""
    trace_dir = trace_dir or os.environ.get("VCR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, recording() as rec:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    add_spans_to_chrome_trace(path, rec)


class StepTimer:
    """Wall-clock step statistics with EMA, without a device sync per step:
    the interval between successive ticks, which in steady state is the
    step's time."""

    def __init__(self, ema: float = 0.05):
        self._ema_w = ema
        self.ema_ms: Optional[float] = None
        self._samples = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) * 1e3
            self._samples.append(dt)
            self.ema_ms = dt if self.ema_ms is None else (
                (1 - self._ema_w) * self.ema_ms + self._ema_w * dt)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._samples:
            return {}
        arr = np.asarray(self._samples)
        return {
            "step_ms_mean": float(arr.mean()),
            "step_ms_p50": float(np.percentile(arr, 50)),
            "step_ms_p95": float(np.percentile(arr, 95)),
            "step_ms_ema": float(self.ema_ms or 0.0),
            "steps": float(len(arr)),
        }

    def reset(self) -> None:
        self._samples = []
        self._last = None
