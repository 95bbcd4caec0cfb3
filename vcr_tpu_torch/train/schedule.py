"""The scheduled-sampling probability schedule, per epoch.

Counterpart of ``vcr_tpu/train/schedule.py``: inverse sigmoid
k / (k + e^(i/k)) with k = 140 when scheduled sampling is on, else a
constant 1.0 (full teacher forcing).
"""

from __future__ import annotations

import numpy as np


def inverse_sigmoid(length: int, k: float = 140.0) -> np.ndarray:
    return k / (k + np.exp(np.arange(length) / k))


def teacher_force_schedule(epochs: int, schedule_sample: bool) -> np.ndarray:
    if schedule_sample:
        return inverse_sigmoid(epochs)
    return np.ones(epochs)
