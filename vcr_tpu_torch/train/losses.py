"""Loss and metric primitives of the captioners' training.

Counterpart of ``vcr_tpu/train/losses.py``: the sentence mask from lengths,
masked cross-entropy (per-sentence mean, then batch mean), masked token
accuracy, and RationaleNet's continuity and brevity losses.

Under an mp split of the vocabulary (``shard``) the logits are one rank's
columns: the cross-entropy and the accuracy reduce over the split without
gathering them.

``valid`` (B,) 0/1 leaves padding rows of a short final batch out of every
mean: they get no weight, and so no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from vcr_tpu_torch.parallel.mesh import VocabShard, sharded_argmax, vocab_parallel_nll


def sentence_mask(max_len: int, s_len: torch.Tensor) -> torch.Tensor:
    """(B,) lengths -> (B, L) float32 0/1 mask."""
    pos = torch.arange(max_len, device=s_len.device)[None, :]
    return (pos < s_len[:, None]).float()


def _valid_mean(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of per-row values over the valid rows (all rows without ``valid``)."""
    if valid is None:
        return x.mean()
    return (x * valid).sum() / valid.sum().clamp(min=1.0)


def masked_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                         s_len: torch.Tensor,
                         valid: Optional[torch.Tensor] = None,
                         shard: Optional[VocabShard] = None) -> torch.Tensor:
    """logits (B, L, V), target (B, L) int, s_len (B,) -> scalar.

    Per-token cross-entropy averaged within each sentence over its valid
    tokens, then over the (valid) sentences: the two-stage mean. With
    ``shard`` the logits are this rank's columns of an mp split, and each
    token's log-softmax is reduced over mp (``parallel.mesh``)."""
    if shard is not None:
        nll = vocab_parallel_nll(logits, target, shard)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, target.long()[..., None])[..., 0]
    mask = sentence_mask(logits.shape[1], s_len)
    per_sent = (nll * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
    return _valid_mean(per_sent, valid)


def masked_accuracy(logits: torch.Tensor, target: torch.Tensor, s_len: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    shard: Optional[VocabShard] = None) -> torch.Tensor:
    """Token accuracy over the valid positions of all sentences together;
    with ``shard``, of an mp split's logits."""
    pred = (logits.argmax(dim=-1) if shard is None
            else sharded_argmax(logits.detach(), shard))
    correct = (pred == target).float()
    mask = sentence_mask(logits.shape[1], s_len)
    if valid is not None:
        mask = mask * valid[:, None]
    return (correct * mask).sum() / mask.sum().clamp(min=1.0)


def continuity_loss(probs: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """probs (B, N, 2): mean |z_t - z_{t-1}| over the selection channel."""
    z = probs[:, :, 1]
    return _valid_mean((z[:, 1:] - z[:, :-1]).abs().mean(dim=1), valid)


def brevity_loss(probs: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """probs (B, N, 2): the mean over the batch of sum_t z_t."""
    return _valid_mean(probs[:, :, 1].sum(dim=1), valid)


def rationale_length(probs: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean count of selected frames (the logged ``len``)."""
    return _valid_mean(probs[:, :, 1].sum(dim=1), valid)
