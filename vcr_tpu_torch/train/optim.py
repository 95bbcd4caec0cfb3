"""The optimizer: global-norm clipping, then L2 weight decay into the
gradient, then Adam or SGD with momentum, then the step of -lr.

Counterpart of ``vcr_tpu/train/optim.py``, which builds that chain in optax
to reproduce ``torch.optim.Adam(lr, weight_decay)`` after
``torch.nn.utils.clip_grad_norm_``. Here it is those torch calls:

    clip_grad_norm_(max_norm) -> Adam(b1 0.9, b2 0.999, eps 1e-8,
                                      weight_decay=wd)      ("adam")
                              -> SGD(momentum, dampening 0,
                                     weight_decay=wd)       ("sgd")

``clip_grad_norm_`` scales every gradient by min(max_norm / (norm + 1e-6), 1),
the formula of the JAX package's ``clip_by_global_norm_torch``, so it takes
that function's place. Both optimizers add wd * param to the gradient before
their moments, as the optax chain does.

Parameters are the port's nested dicts of tensors. The optimizer updates
their trainable leaves in place; frozen leaves (:func:`trainable_labels`) get
no step, no decay and no share of the clip norm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from vcr_tpu_torch.parallel.mesh import clip_sum_of_squares

# Leaves that are buffers in the reference torch models, not parameters:
# positional-encoding tables ("pe") and BatchNorm running statistics
# ("mean", "var"). torch's optimizer and clip see only parameters.
_BUFFER_KEYS = frozenset({"pe", "mean", "var"})


def trainable_labels(params) -> dict:
    """A nested dict of 'trainable' / 'frozen' labels mirroring ``params``,
    keyed on each leaf's own dict key (:data:`_BUFFER_KEYS`).

    A Transformer's ``decoder.norm`` is frozen too where ``decoder.norm_out``
    sits beside it: the reference creates both but only calls ``norm_out``,
    so ``norm`` has no gradient there and torch's Adam skips it, weight decay
    included."""

    def walk(node, key, frozen=False):
        if isinstance(node, dict):
            return {k: walk(v, k, frozen) for k, v in node.items()}
        return "frozen" if frozen or key in _BUFFER_KEYS else "trainable"

    labels = walk(params, None)
    dec = params.get("decoder") if isinstance(params, dict) else None
    if isinstance(dec, dict) and "norm" in dec and "norm_out" in dec:
        labels["decoder"]["norm"] = walk(dec["norm"], "norm", frozen=True)
    return labels


def trainable_leaves(params) -> Tuple[List[Tuple[str, ...]], List[torch.Tensor]]:
    """(paths, tensors) of the trainable leaves, in the dicts' order."""
    paths, leaves = [], []

    def walk(node, label, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, label[k], path + (k,))
        elif label == "trainable":
            paths.append(path)
            leaves.append(node)

    walk(params, trainable_labels(params), ())
    return paths, leaves


@dataclass
class OptState:
    """A torch optimizer bound to the trainable leaves of one parameter dict
    (``leaves``, at ``paths``), and the clip norm."""

    optimizer: torch.optim.Optimizer
    paths: List[Tuple[str, ...]]
    leaves: List[torch.Tensor]
    max_norm: float


@dataclass(frozen=True)
class Optimizer:
    name: str
    lr: float
    wd: float
    max_norm: float
    momentum: float = 0.9

    def init(self, params) -> OptState:
        """Bind a new torch optimizer to ``params``' trainable leaves, which
        are set to require grad. The leaves stay the caller's tensors."""
        paths, leaves = trainable_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if self.name == "adam":
            opt = torch.optim.Adam(leaves, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=self.wd)
        else:
            opt = torch.optim.SGD(leaves, lr=self.lr, momentum=self.momentum,
                                  dampening=0.0, weight_decay=self.wd)
        return OptState(opt, paths, leaves, self.max_norm)

    @staticmethod
    def step(state: OptState, grads: Sequence[torch.Tensor],
             split: Optional[Sequence[bool]] = None, group=None) -> None:
        """One update of ``state.leaves`` in place, from ``grads`` in the
        order of ``state.paths``: clip, decay, moments, step.

        ``split`` marks the leaves that are this rank's blocks of an mp split
        over the process group ``group``: the clip's global norm then sums
        their squares over mp and counts each replicated leaf once
        (:func:`clip_split_`)."""
        if len(grads) != len(state.leaves):
            raise ValueError(f"{len(grads)} gradients for {len(state.leaves)} "
                             "trainable leaves")
        for leaf, g in zip(state.leaves, grads):
            leaf.grad = g
        if split is None:
            torch.nn.utils.clip_grad_norm_(state.leaves, state.max_norm)
        else:
            clip_split_([leaf.grad for leaf in state.leaves], split, group,
                        state.max_norm)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)


@torch.no_grad()
def clip_split_(grads: Sequence[torch.Tensor], split: Sequence[bool], group,
                max_norm: float) -> torch.Tensor:
    """``clip_grad_norm_``'s scaling, min(max_norm / (norm + 1e-6), 1), of
    gradients of which the ``split`` ones are mp blocks: the global norm sums
    their squares over mp and each replicated gradient's once. Scales
    ``grads`` in place and returns the norm."""
    norm = clip_sum_of_squares(grads, split, group).sqrt()
    coef = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    for g in grads:
        g.mul_(coef.to(g.dtype))
    return norm


def build_optimizer(name: str, lr: float, wd: float, max_norm: float,
                    momentum: float = 0.9) -> Optimizer:
    """``name`` is "adam" or "sgd" (the reference parses a momentum but only
    wires Adam)."""
    if name not in ("adam", "sgd"):
        raise NotImplementedError("Unknown optim type")
    return Optimizer(name, lr, wd, max_norm, momentum)
