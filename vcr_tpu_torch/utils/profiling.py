"""Profiling and tracing hooks: the counterpart of
``vcr_tpu/utils/profiling.py``.

* :func:`trace` -- a ``torch.profiler`` run over its block that writes a
  Chrome trace (``trace.json``) under ``VCR_TRACE_DIR`` or a given path.
* :class:`StepTimer` -- per-step wall-clock statistics (EMA and
  percentiles) for the train loop, reported through the logger.
* :func:`annotate` -- a named span (``torch.profiler.record_function``) for
  host-side phases such as evaluation and checkpointing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """Profile the block (host, and the card where there is one) when
    ``trace_dir`` or ``VCR_TRACE_DIR`` names a directory; else do nothing."""
    trace_dir = trace_dir or os.environ.get("VCR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def annotate(name: str):
    """A named span in the profiler's timeline."""
    return torch.profiler.record_function(name)


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
