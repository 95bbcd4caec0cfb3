"""Train and eval steps of the captioners: the counterpart of
``vcr_tpu/train/step.py``.

A step is a function of its inputs: params, optimizer state, a batch, a seed
and the teacher-forcing probability in; params, optimizer state, metrics and
greedy predictions out. PyTorch runs it eagerly: the optimizer updates the
parameter tensors in place and the step returns them. Metrics stay on the
device as 0-d tensors until the caller reads them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from vcr_tpu_torch.device import resolve_device
from vcr_tpu_torch.models import base
from vcr_tpu_torch.nn.layers import dp_scope, vocab_scope
from vcr_tpu_torch.nn.rnn import gate_remat_default
from vcr_tpu_torch.parallel import mesh as mesh_mod
from vcr_tpu_torch.train import losses
from vcr_tpu_torch.train.optim import OptState, Optimizer, trainable_leaves
from vcr_tpu_torch.utils.profiling import span

BATCH_KEYS = ("vid_feats", "sent", "sent_len", "valid")


def _forward(model_name: str, fwd: Callable, params, batch, rng, tf_prob,
             lambda_brev: float, lambda_cont: float, shard=None):
    """Run a bound forward ``fwd(params, vid_feats, sent, sent_len, rng,
    tf_prob)`` and compute (loss, metrics, pred, aux) for the family; aux
    holds SpatialNet's new BatchNorm state under ``bn_state``. ``shard``:
    the logits are this rank's columns of an mp split of the vocab."""
    valid = batch["valid"]
    out = fwd(params, batch["vid_feats"], batch["sent"], batch["sent_len"], rng, tf_prob)
    aux: Dict = {}
    if model_name == "rationale":
        logits, probs = out
        ce = losses.masked_cross_entropy(logits, batch["sent"], batch["sent_len"], valid,
                                         shard)
        brev = losses.brevity_loss(probs, valid) * lambda_brev
        cont = losses.continuity_loss(probs, valid) * lambda_cont
        loss = ce + brev + cont
        metrics = {"loss": loss, "loss_ce": ce, "loss_brev": brev, "loss_cont": cont,
                   "len": losses.rationale_length(probs, valid)}
    else:
        logits = out
        if model_name == "spatial":
            logits, _seq_alphas, aux["bn_state"] = out
        loss = losses.masked_cross_entropy(logits, batch["sent"], batch["sent_len"], valid,
                                           shard)
        metrics = {"loss": loss}
    metrics["acc"] = losses.masked_accuracy(logits, batch["sent"], batch["sent_len"], valid,
                                            shard)
    pred = (logits.argmax(dim=-1) if shard is None
            else mesh_mod.sharded_argmax(logits.detach(), shard))
    return loss, metrics, pred.to(torch.int32), aux


@torch.no_grad()
def _merge_bn(params, bn_state) -> None:
    """Write the forward's new BatchNorm running stats into ``params``, in
    place: they are state, not parameters the optimizer trains."""
    for name, stats in bn_state.items():
        for k in ("mean", "var"):
            params[name][k].copy_(stats[k])


def microbatch_seed(rng: int, i: int, grad_accum: int) -> int:
    """The seed of microbatch ``i`` of a step seeded with ``rng``: rng *
    grad_accum + i, so no two microbatches of successive seeds share one,
    and grad_accum=1 keeps ``rng``."""
    return rng * grad_accum + i


def _same_device(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and device.index in (None, t.device.index)


class StepFns:
    """The steps of one model family, spec and optimizer
    (:func:`build_step_fns`); :meth:`loss` and :meth:`grads` are the
    forward alone and the forward with its backward."""

    def __init__(self, model_name: str, spec: base.ModelSpec, optimizer: Optimizer,
                 lambda_brev: float, lambda_cont: float, remat: bool, grad_accum: int,
                 static_tf, device: torch.device, mesh=None, specs=None):
        _, self._apply = base.build_model(model_name)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.model_name, self.spec, self.optimizer = model_name, spec, optimizer
        self.lambdas = (lambda_brev, lambda_cont)
        self.remat, self.grad_accum, self.static_tf = remat, grad_accum, static_tf
        self.device = device
        self.mesh, self.specs = mesh, specs

    def _shard(self, params):
        """The mp split of the vocab of ``params`` (None without one)."""
        if self.mesh is None or self.mesh.mp == 1:
            return None
        return mesh_mod.vocab_shard_for(params, self.specs, self.mesh,
                                        self.spec.padded_vocab_size)

    def _fwd(self, train: bool) -> Callable:
        def fn(params, vid_feats, sent, sent_len, rng, tf_prob):
            if train and self.static_tf is not None:
                tf_prob = self.static_tf
            # S2VT and S2VT-att train with gate remat by default, as in the
            # JAX package; RationaleNet and SpatialNet keep it off. The scopes
            # are entered here, inside what remat=True checkpoints, so that
            # its replay sees them too.
            with gate_remat_default(train and self.model_name in ("s2vt", "s2vt-att")), \
                    vocab_scope(self._shard(params)), dp_scope(self.mesh):
                return self._apply(params, self.spec, vid_feats, sent, sent_len, rng=rng,
                                   train=train, teacher_force_prob=tf_prob)

        if train and self.remat:
            return lambda *args: torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False)
        return fn

    def _check(self, params, batch) -> None:
        """Raise unless every parameter and batch tensor is on the step's
        device: nothing is moved."""
        _, leaves = trainable_leaves(params)
        for name in BATCH_KEYS:
            x = batch[name]
            if not isinstance(x, torch.Tensor) or not _same_device(x, self.device):
                raise ValueError(f"batch[{name!r}] must be a tensor on {self.device} "
                                 "(device_batch moves a batch there)")
        if not all(_same_device(x, self.device) for x in leaves):
            raise ValueError(f"the parameters must be on {self.device}")

    def loss(self, params, batch, rng: int, tf_prob):
        """The train forward under autograd: (loss, metrics, pred, aux)."""
        with torch.enable_grad():
            return _forward(self.model_name, self._fwd(True), params, batch, rng, tf_prob,
                            *self.lambdas, shard=self._shard(params))

    def grads(self, params, leaves: List[torch.Tensor], batch, rng: int, tf_prob,
              seed=None):
        """(gradients of the loss for ``leaves``, detached metrics, pred,
        aux); ``seed`` (a 0-d tensor) scales the loss's gradient."""
        with span("train.forward"):
            loss, metrics, pred, aux = self.loss(params, batch, rng, tf_prob)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, grad_outputs=seed, allow_unused=True,
                                        materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}, pred, aux

    def _accum_grads(self, params, leaves, batch, rng: int, tf_prob, total=None):
        """The full-batch gradient from ``grad_accum`` microbatches: each
        microbatch's gradient weighted by its count of valid rows, the sum
        divided by the batch's. Metrics take the same weights; aux (the
        BatchNorm state) is the last microbatch's forward from the step's
        starting stats, as the JAX package's scan takes ``aux[-1]``. That
        is neither one big batch's stats nor what torch's chained in-place
        ``F.batch_norm`` would leave (the momentum applied once per
        microbatch).

        ``total`` (under dp, the global batch's count of valid rows): each
        microbatch's backward is seeded with its count over ``total``
        instead, and the gradients are summed, to be summed over dp next."""
        b, k = batch["vid_feats"].shape[0], self.grad_accum
        if b % k:
            raise ValueError(f"batch size {b} not divisible by grad_accum={k}")
        m = b // k
        g_sum, ms, preds, ns = None, [], [], []
        for i in range(k):
            micro = {name: x[i * m:(i + 1) * m] for name, x in batch.items()}
            n = micro["valid"].float().sum()
            grads, metrics, pred, aux = self.grads(
                params, leaves, micro, microbatch_seed(rng, i, k), tf_prob,
                None if total is None else n / total)
            if total is not None:
                g_sum = grads if g_sum is None else [a + g for a, g in zip(g_sum, grads)]
            else:
                g_sum = ([g * n for g in grads] if g_sum is None
                         else [a + g * n for a, g in zip(g_sum, grads)])
            ms.append(metrics)
            preds.append(pred)
            ns.append(n)
        w_sum = torch.stack(ns).sum().clamp(min=1.0)
        metrics = {name: sum(mi[name] * (n / w_sum) for mi, n in zip(ms, ns))
                   for name in ms[0]}
        if total is not None:
            return g_sum, metrics, torch.cat(preds), aux
        return [g / w_sum for g in g_sum], metrics, torch.cat(preds), aux

    def train_step(self, params, opt_state: OptState, batch: Dict[str, torch.Tensor],
                   rng: int, tf_prob):
        """-> (params, opt_state, metrics, pred): one optimizer update of
        ``params``' trainable leaves, in place; then SpatialNet's new
        BatchNorm running stats, written in place. The span ``train.step``
        holds ``train.forward``, ``train.backward`` (per microbatch) and
        ``train.optimizer``."""
        with span("train.step"):
            return self._train_step(params, opt_state, batch, rng, tf_prob)

    def _train_step(self, params, opt_state: OptState, batch: Dict[str, torch.Tensor],
                    rng: int, tf_prob):
        self._check(params, batch)
        _, leaves = trainable_leaves(params)
        if len(leaves) != len(opt_state.leaves) or any(
                x is not y for x, y in zip(leaves, opt_state.leaves)):
            raise ValueError("opt_state was built for other parameter tensors: "
                             "call optimizer.init(params)")
        if self.mesh is not None and self.mesh.dp > 1:
            # each rank's backward seeded with its share of the global batch's
            # valid rows, the gradients summed over dp: the gradient of one
            # process on the global batch, BatchNorm's terms through the other
            # ranks' rows included (their sums' backward sums over dp too)
            total = mesh_mod.sum_grads_over_dp([batch["valid"].float().sum()],
                                               self.mesh)[0].clamp(min=1.0)
            grads, metrics, pred, aux = self._accum_grads(params, leaves, batch, rng,
                                                          tf_prob, total)
            grads = mesh_mod.sum_grads_over_dp(grads, self.mesh)
        elif self.grad_accum > 1:
            grads, metrics, pred, aux = self._accum_grads(params, leaves, batch, rng,
                                                          tf_prob)
        else:
            grads, metrics, pred, aux = self.grads(params, leaves, batch, rng, tf_prob)
        if self.mesh is not None:
            metrics = self._sync_metrics(metrics, batch)
        with span("train.optimizer"):
            if self.mesh is None:
                self.optimizer.step(opt_state, grads)
            else:
                split = [mesh_mod.spec_at(self.specs, path) is not None
                         for path in opt_state.paths]
                self.optimizer.step(opt_state, grads, split if any(split) else None,
                                    self.mesh.mp_group)
        if "bn_state" in aux:
            _merge_bn(params, aux["bn_state"])
        return params, opt_state, metrics, pred

    def eval_step(self, params, batch: Dict[str, torch.Tensor], rng=None):
        """-> (metrics, pred): the greedy eval forward. ``rng`` seeds
        RationaleNet's Gumbel noise (None: 0); S2VT ignores it."""
        self._check(params, batch)
        with torch.no_grad():
            _, metrics, pred, _ = _forward(self.model_name, self._fwd(False), params,
                                           batch, rng, 0.0, *self.lambdas,
                                           shard=self._shard(params))
            if self.mesh is not None:
                metrics = self._sync_metrics(metrics, batch)
        return metrics, pred

    def _sync_metrics(self, metrics, batch):
        """The global batch's metrics from each dp index's: means over valid
        rows, and the accuracy over valid tokens."""
        valid = batch["valid"].float()
        n = valid.sum()
        tokens = (losses.sentence_mask(batch["sent"].shape[1], batch["sent_len"])
                  * valid[:, None]).sum()
        names = list(metrics)
        by_rows = mesh_mod.weighted_mean([metrics[k] for k in names if k != "acc"], n,
                                         self.mesh)
        out = dict(zip([k for k in names if k != "acc"], by_rows))
        out["acc"] = mesh_mod.weighted_mean([metrics["acc"]], tokens, self.mesh)[0]
        return {k: out[k] for k in names}


def build_step_fns(model_name: str, spec: base.ModelSpec, optimizer: Optimizer,
                   lambda_brev: float = 1.0, lambda_cont: float = 1.0,
                   remat: bool = False, grad_accum: int = 1, static_tf=None,
                   device=None, mesh=None, specs=None) -> Tuple[Callable, Callable]:
    """-> (train_step, eval_step) for "s2vt", "s2vt-att", "transformer",
    "rationale" or "spatial" on ``device`` (None: the card; raises without
    one).

    train_step(params, opt_state, batch, rng, tf_prob)
        -> (params, opt_state, metrics, pred)
    eval_step(params, batch, rng=None) -> (metrics, pred)

    ``opt_state`` is ``optimizer.init(params)``: a torch optimizer bound to
    ``params``' trainable tensors, which train_step updates in place and
    returns. ``batch`` holds the tensors of :data:`BATCH_KEYS` on ``device``
    (:func:`device_batch`); ``rng`` is an int seed of the step's dropout,
    teacher-forcing coins and Gumbel noise. metrics: ``loss`` and ``acc``,
    for RationaleNet also ``loss_ce``, ``loss_brev``, ``loss_cont`` and
    ``len``; pred: the greedy tokens (B, L) int32 of the step's logits.

    remat: run the train forward under ``torch.utils.checkpoint``, so the
    backward recomputes it (B1, and B2, launched again) instead of keeping
    its activations. (A bf16 Transformer recomputes its Norms in the
    backward either way.)

    grad_accum: split the batch into that many microbatches, in order, and
    make one update from their gradients weighted by valid rows: the
    full-batch gradient. Microbatch i is seeded with
    :func:`microbatch_seed`. A batch the count does not divide raises.
    SpatialNet's BatchNorm stats follow the last microbatch.

    static_tf: a Python number that replaces ``tf_prob`` at train; at 1.0
    the decoders take their hoisted form (one vocab product after the loop).

    mesh / specs: this process's place in a (dp, mp) layout
    (``parallel.mesh.make_mesh``) and the split of each parameter
    (``param_specs``); ``params`` are then this rank's blocks
    (``shard_params``) and ``batch`` this dp index's rows. The logits stay
    split over mp, the gradients are averaged over dp weighted by valid
    rows (each rank's backward seeded with its share of the global batch's
    valid rows, then summed), SpatialNet's BatchNorm statistics are the
    global batch's, the clip's norm counts the split leaves over mp, and the
    metrics are the global batch's on every rank.

    Both steps are bound methods of one :class:`StepFns`."""
    fns = StepFns(model_name, spec, optimizer, lambda_brev, lambda_cont, remat,
                  grad_accum, static_tf, resolve_device(device), mesh, specs)
    return fns.train_step, fns.eval_step


def device_batch(batch: Dict, device=None) -> Dict[str, torch.Tensor]:
    """The array fields of a pipeline batch (:data:`BATCH_KEYS`) as tensors
    on ``device`` (None: the card); the other fields stay on the host."""
    device = resolve_device(device)
    return {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}
