"""Gumbel-Softmax with straight-through hard sampling.

Counterpart of ``vcr_tpu/nn/gumbel.py``, with torch.nn.functional.gumbel_softmax
semantics: soft samples while training, hard (one-hot, straight-through)
samples at eval. The noise comes from an explicit ``torch.Generator``, or is
injected; zero noise is ``noise=torch.zeros_like(logits)``.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape`` in float32, -log(-log(u) + 1e-20) with u
    uniform in [1e-20, 1) from ``generator``, which lives on ``device``."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(1e-20, 1.0, generator=generator)
    return -torch.log(-torch.log(u) + 1e-20)


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample from the Gumbel-Softmax distribution over the last axis.

    soft: y = softmax((logits + g) / tau), g ~ Gumbel(0, 1)
    hard: one_hot(argmax(y)) with straight-through gradients,
          y_hard - y.detach() + y, as in torch.

    ``noise`` injects pre-drawn Gumbel(0, 1) noise; otherwise it is drawn
    from ``generator``, which must live on ``logits``' device.
    """
    if noise is None:
        if generator is None:
            raise ValueError("gumbel_softmax needs injected noise or a generator")
        noise = sample_gumbel(logits.shape, generator, logits.device)
    y_soft = torch.softmax((logits + noise) / tau, dim=-1)
    if not hard:
        return y_soft
    idx = y_soft.argmax(dim=-1)
    y_hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
    # the same arithmetic as the JAX package, so the result matches it bit
    # for bit: (1 - y) + y is not always exactly 1
    return y_hard - y_soft.detach() + y_soft
