"""RationaleNet: Gumbel-Softmax temporal rationale over frames + a wrapped captioner.

PyTorch counterpart of ``vcr_tpu/models/rationale.py``:

* generator: BiLSTM over the frames (kernel B2, ``ops.cuda_lstm``, one launch
  per direction, differentiable through ``cuda_lstm.LstmSequence``) ->
  dropout -> linear -> 2 logits per frame -> Gumbel-Softmax, soft at train
  and hard (straight-through) at eval; channel 1 scales the frame features.
* the selected features feed the wrapped captioner (S2VT or S2VT-att), with
  its own train branch at train.

Randomness: one generator on the features' device, seeded with ``rng``,
draws the generator's dropout mask (N, B, 2H) (at train, where
``dropout_p`` > 0), then the Gumbel noise (B, N, 2) (unless
``gumbel_noise`` is injected), both before the BiLSTM, then the caption
net's draws (its ``draw_train_noise``, before its own recurrences). None is
drawn inside a checkpointed region.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcr_tpu_torch.models import base, s2vt
from vcr_tpu_torch.nn.gumbel import gumbel_softmax, sample_gumbel
from vcr_tpu_torch.nn.layers import apply_keep_mask, dense, dense_init, keep_mask
from vcr_tpu_torch.nn.rnn import bilstm_init
from vcr_tpu_torch.ops.cuda_lstm import bilstm_sequence_fused
from vcr_tpu_torch.utils.profiling import span


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``."""
    return {
        "caption_net": base.base_module(spec).init_params(gen, spec, glove_vectors),
        "gen": {
            "rnn": bilstm_init(gen, spec.vid_feat_size, spec.hidden_size),
            "linear": dense_init(gen, 2 * spec.hidden_size, 2),
        },
    }


def generator(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
              gen: Optional[torch.Generator] = None,
              gumbel_noise: Optional[torch.Tensor] = None, train: bool = False,
              drop_keep: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame selection: vid_feats (B, N, V) -> (sel_vid_feats (B, N, V),
    probs (B, N, 2)); probs soft at train, one-hot per frame at eval.

    The Gumbel noise is ``gumbel_noise`` (B, N, 2) if given, else drawn from
    ``gen`` on ``vid_feats``' device. ``drop_keep`` (N, B, 2H) is the
    dropout keep-mask on the BiLSTM output, given at train only (None: no
    dropout)."""
    xs = vid_feats.transpose(0, 1)                                  # (N, B, V)
    out = bilstm_sequence_fused(params["rnn"], xs, compute_dtype=spec.cdtype)
    if drop_keep is not None:
        out = apply_keep_mask(out, drop_keep, spec.dropout_p)
    out = out.transpose(0, 1)                                       # (B, N, 2H)
    logits = dense(params["linear"], out, spec.cdtype)              # (B, N, 2)
    probs = gumbel_softmax(logits, tau=spec.tau, hard=not train, noise=gumbel_noise,
                           generator=gen)
    # a bf16 feature times a float32 prob is float32, as in the JAX package
    return vid_feats * probs[..., 1:2], probs


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          s: Optional[torch.Tensor] = None, s_len: Optional[torch.Tensor] = None,
          rng: Optional[int] = None, train: bool = False, teacher_force_prob=1.0,
          gumbel_noise: Optional[torch.Tensor] = None, emit: str = "logits",
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vid_feats (B, N, V) -> (logits (B, L, vocab) or greedy tokens (B, L),
    probs (B, N, 2)).

    The draws come from a generator on the features' device seeded with
    ``rng`` (None: 0), so one call is deterministic; ``gumbel_noise`` injects
    the Gumbel noise instead."""
    captioner = base.base_module(spec)
    s2vt._check_call(s, train, emit)
    gen = s2vt.generator_for(rng, vid_feats.device)
    with span("encode"), span("select_frames"):
        vid_feats = vid_feats.to(spec.cdtype)
        b, frames = vid_feats.shape[:2]
        drop_keep = None
        if train and spec.dropout_p > 0.0:
            drop_keep = keep_mask((frames, b, 2 * spec.hidden_size), spec.dropout_p, gen,
                                  vid_feats.device)
        if gumbel_noise is None:
            gumbel_noise = sample_gumbel((b, frames, 2), gen, vid_feats.device)
        sel, probs = generator(params["gen"], spec, vid_feats, gumbel_noise=gumbel_noise,
                               train=train, drop_keep=drop_keep)
    return captioner.apply(params["caption_net"], spec, sel, s, rng=gen, train=train,
                           teacher_force_prob=teacher_force_prob, emit=emit), probs


base.register("rationale", init_params, apply)
