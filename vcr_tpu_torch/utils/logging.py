"""Tensorboard logging with windowed scalar means: the counterpart of
``vcr_tpu/utils/logging.py``.

``set(keys)`` declares scalar names, ``update(metrics)`` accumulates and
flushes windowed means to ``train/<k>`` every ``log_iter`` updates,
``log_valid`` writes ``val/<k>``. Values may be 0-d tensors on the card: a
window is stacked and copied to the host once, at flush time, not once per
scalar. ``tensorboardX`` is optional; without it the means are printed only.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


class TrainLogger:
    def __init__(self, start_epoch: int, log_iter: int, log_dir: Optional[str]):
        self.log_iter = log_iter
        self.writer = SummaryWriter(log_dir=log_dir) if (
            SummaryWriter is not None and log_dir) else None
        self.n_iter = 0
        self.epoch = start_epoch - 1
        self.time_start = time.time()
        self.num_batches = 0
        self.log_keys: List[str] = []
        self._window: List[Dict] = []

    def set(self, log_keys: Sequence[str]) -> None:
        self.log_keys = list(log_keys)
        self.reset()

    def reset(self) -> None:
        self.num_batches = 0
        self.time_start = time.time()
        self._window = []

    def step(self) -> None:
        self.epoch += 1

    def update(self, metrics: Dict) -> None:
        """Accumulate one batch's metrics (tensors on the card stay there
        until the window flushes)."""
        self._window.append(metrics)
        self.n_iter += 1
        self.num_batches += 1
        if self.num_batches and self.n_iter % self.log_iter == 0:
            self.log_train()

    def _window_values(self) -> np.ndarray:
        """(updates, keys) float64 values of the window: one stack of every
        scalar and one copy to the host."""
        rows = [torch.stack([torch.as_tensor(m[k], dtype=torch.float32)
                             for k in self.log_keys]) for m in self._window]
        return torch.stack(rows).cpu().double().numpy()

    def log_train(self) -> None:
        if not self.num_batches:
            raise RuntimeError("log_train with an empty window")
        time_taken = time.time() - self.time_start
        values = self._window_values()
        means = {k: float(np.mean(values[:, i])) for i, k in enumerate(self.log_keys)}
        # divergence guard on the window's one host copy: a non-finite
        # windowed loss means the run cannot recover, so stop it here
        if not np.isfinite(means.get("loss", 0.0)):
            raise FloatingPointError(
                f"non-finite train loss at update {self.n_iter} "
                f"(window means: {means}): diverged; lower lr / raise "
                "max_norm clip, or resume from the last finite checkpoint")
        if self.writer:
            for k, v in means.items():
                self.writer.add_scalar("train/" + k, v, self.n_iter)
        vals = ", ".join(f"train_{k}: {means[k]:.5f}" for k in self.log_keys)
        print(f"epoch: {self.epoch}, updates: {self.n_iter}, "
              f"time: {time_taken:.2f}, {vals}")
        self.reset()

    def log_valid(self, time_taken: float, metrics: Dict) -> None:
        # validation time does not count toward the next train window
        self.time_start += time_taken
        vals = {k: float(metrics[k]) for k in self.log_keys}
        if self.writer:
            for k, v in vals.items():
                self.writer.add_scalar("val/" + k, v, self.n_iter)
        s = ", ".join(f"val_{k}: {vals[k]:.5f}" for k in self.log_keys)
        print(f"epoch: {self.epoch}, updates: {self.n_iter}, "
              f"time: {time_taken:.2f}, {s}")

    def log_scalar(self, tag: str, value: float) -> None:
        if self.writer:
            self.writer.add_scalar(tag, value, self.n_iter)
