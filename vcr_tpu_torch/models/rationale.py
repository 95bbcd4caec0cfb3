"""RationaleNet: Gumbel-Softmax temporal rationale over frames + a wrapped captioner.

PyTorch counterpart of ``vcr_tpu/models/rationale.py``, eval branch:

* generator: BiLSTM over the frames (kernel B2, ``ops.cuda_lstm``, one launch
  per direction) -> dropout (identity at eval) -> linear -> 2 logits per
  frame -> hard straight-through Gumbel-Softmax; channel 1 scales the frame
  features.
* the selected features feed the wrapped S2VT captioner.

Training (soft samples, dropout, the straight-through gradient) comes with
ROADMAP A5/A10; an S2VT-att base with A9.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcr_tpu_torch.models import base, s2vt
from vcr_tpu_torch.nn.gumbel import gumbel_softmax
from vcr_tpu_torch.nn.layers import dense, dense_init
from vcr_tpu_torch.nn.rnn import bilstm_init
from vcr_tpu_torch.ops.cuda_lstm import bilstm_sequence_fused


def base_module(spec: base.ModelSpec):
    """The wrapped captioner's module; raises for one not ported."""
    if spec.base_arch == "s2vt":
        return s2vt
    if spec.base_arch == "s2vt-att":
        raise NotImplementedError(
            "RationaleNet over s2vt-att is not ported yet: ROADMAP A9 (S2VT-att)")
    raise NotImplementedError(f"unknown video captioning arch {spec.base_arch!r}")


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``."""
    return {
        "caption_net": base_module(spec).init_params(gen, spec, glove_vectors),
        "gen": {
            "rnn": bilstm_init(gen, spec.vid_feat_size, spec.hidden_size),
            "linear": dense_init(gen, 2 * spec.hidden_size, 2),
        },
    }


def generator(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
              gen: Optional[torch.Generator] = None,
              gumbel_noise: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval frame selection: vid_feats (B, N, V) -> (sel_vid_feats (B, N, V),
    probs (B, N, 2)), probs one-hot per frame.

    The Gumbel noise is ``gumbel_noise`` (B, N, 2) if given, else drawn from
    ``gen`` on ``vid_feats``' device."""
    xs = vid_feats.transpose(0, 1)                                  # (N, B, V)
    out = bilstm_sequence_fused(params["rnn"], xs, compute_dtype=spec.cdtype)
    out = out.transpose(0, 1)                                       # (B, N, 2H)
    logits = dense(params["linear"], out, spec.cdtype)              # (B, N, 2)
    probs = gumbel_softmax(logits, tau=spec.tau, hard=True, noise=gumbel_noise,
                           generator=gen)
    # a bf16 feature times a float32 prob is float32, as in the JAX package
    return vid_feats * probs[..., 1:2], probs


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          train: bool = False, emit: str = "logits", rng: int = 0,
          gumbel_noise: Optional[torch.Tensor] = None,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval forward: vid_feats (B, N, V) -> (logits (B, L, vocab) or greedy
    tokens (B, L), probs (B, N, 2)).

    Without ``gumbel_noise`` the noise is drawn from a generator on the
    features' device seeded with ``rng``, so one call is deterministic."""
    if train:
        raise NotImplementedError(
            "the RationaleNet train step comes with ROADMAP A5/A10")
    captioner = base_module(spec)
    vid_feats = vid_feats.to(spec.cdtype)
    gen = None
    if gumbel_noise is None:
        gen = torch.Generator(device=vid_feats.device).manual_seed(rng)
    sel, probs = generator(params["gen"], spec, vid_feats, gen, gumbel_noise)
    return captioner.apply(params["caption_net"], spec, sel, emit=emit), probs


base.register("rationale", init_params, apply)
