"""SpatialNet: spatial attention over YOLO grid features, spliced into a
captioner. The counterpart of ``vcr_tpu/models/spatial.py``:

* a trunk of 2x (3x3 conv + BatchNorm + ReLU), F -> H, over all B·N frames
  at once (``nn.layers.conv2d``: bf16 cuDNN on the card);
* per frame, Bahdanau attention over the K² grid cells with the encoder's
  state as the query: the keys are the trunk's features, projected once for
  all B·N·K² cells before the loop; the values are the raw F-wide features,
  so the context is F-wide. The context feeds the wrapped captioner's
  ``encode_step``, one step a frame, in a plain loop;
* each frame's K×K attention map, stacked to ``seq_alphas`` (B, N, K, K);
* decoding by the wrapped captioner: ``s2vt.decode`` on the (N, B, H)
  outputs, whose prime pass runs kernel B1 once, or ``s2vt_att.decode`` on
  (B, N, H).

BatchNorm's running statistics are functional state: :func:`apply` returns
them, and the train step writes them into the parameters after its
optimizer update.

Randomness: the train branch's draws (S2VT's coins and dropout masks, or
S2VT-att's output mask) come from one generator on the features' device,
seeded with ``rng``, before the trunk and the loop; nothing else is random.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vcr_tpu_torch.models import base, s2vt, s2vt_att
from vcr_tpu_torch.nn.attention import bahdanau_attend, bahdanau_init, bahdanau_project_keys
from vcr_tpu_torch.nn.layers import batchnorm, batchnorm_init, conv2d, conv2d_init
from vcr_tpu_torch.utils.profiling import span


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``."""
    return {
        "caption_net": base.base_module(spec).init_params(gen, spec, glove_vectors),
        "conv1": conv2d_init(gen, spec.vid_feat_size, spec.hidden_size, 3),
        "bn1": batchnorm_init(spec.hidden_size),
        "conv2": conv2d_init(gen, spec.hidden_size, spec.hidden_size, 3),
        "bn2": batchnorm_init(spec.hidden_size),
        "attention": bahdanau_init(gen, spec.hidden_size),
    }


def conv_trunk(params, spec: base.ModelSpec, frames: torch.Tensor, train: bool):
    """frames (B·N, F, K, K) -> (feats (B·N, H, K, K), new BN state)."""
    x = conv2d(params["conv1"], frames, spec.cdtype)
    x, bn1 = batchnorm(params["bn1"], x, train)
    x = conv2d(params["conv2"], torch.relu(x), spec.cdtype)
    x, bn2 = batchnorm(params["bn2"], x, train)
    return torch.relu(x), {"bn1": bn1, "bn2": bn2}


def encode_spatial(params, spec: base.ModelSpec, vid_feats: torch.Tensor, train: bool):
    """vid_feats (B, N, F, K, K) -> (output1 (N, B, H), rnn_state (B, H),
    seq_alphas (B, N, K, K), new BN state)."""
    b, n, f, k, _ = vid_feats.shape
    cd, hidden, cells = spec.cdtype, spec.hidden_size, k * k
    feats, bn_state = conv_trunk(params, spec, vid_feats.reshape(b * n, f, k, k), train)
    keys = feats.reshape(b, n, hidden, cells).transpose(2, 3)          # (B, N, K², H)
    proj_keys = bahdanau_project_keys(params["attention"], keys, cd)   # one product
    # the values are read only through the context product's rounding, so
    # they are rounded once here: the same bits
    values = vid_feats.reshape(b, n, f, cells).transpose(2, 3).to(cd)  # (B, N, K², F)
    cap = base.base_module(spec)
    state = torch.zeros((b, hidden), dtype=torch.float32, device=vid_feats.device)
    outs, alphas = [], []
    for t in range(n):
        context, a = bahdanau_attend(params["attention"], state, proj_keys[:, t],
                                     values[:, t], cd)                  # (B, F), (B, K²)
        out, state = cap.encode_step(params["caption_net"], spec, context, state)
        outs.append(out)
        alphas.append(a)
    seq_alphas = torch.stack(alphas, dim=1).reshape(b, n, k, k)
    return torch.stack(outs), state, seq_alphas, bn_state


def encode_for_base(params, spec: base.ModelSpec, vid_feats: torch.Tensor, train: bool):
    """:func:`encode_spatial` with its outputs in the layout of the wrapped
    captioner's decoder: (outs (N, B, H) for S2VT, (B, N, H) for S2VT-att,
    final state (B, H), seq_alphas (B, N, K, K), new BN state)."""
    with span("encode"):
        output1, state, seq_alphas, bn_state = encode_spatial(params, spec, vid_feats, train)
    if base.base_module(spec) is s2vt_att:
        output1 = output1.transpose(0, 1)
    return output1, state, seq_alphas, bn_state


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          s: Optional[torch.Tensor] = None, s_len: Optional[torch.Tensor] = None,
          rng: s2vt.Rng = None, train: bool = False, teacher_force_prob=1.0,
          emit: str = "logits") -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """vid_feats (B, N, F, K, K) -> (logits (B, L, vocab) or greedy tokens
    (B, L), seq_alphas (B, N, K, K), new BN state). ``s_len`` is unused, as
    in the JAX package."""
    del s_len
    s2vt._check_call(s, train, emit)
    cap = base.base_module(spec)
    b, device = vid_feats.shape[0], vid_feats.device
    noise = None
    if train:
        noise = cap.draw_train_noise(s2vt.generator_for(rng, device), spec, b, device)
    outs, rnn_state, seq_alphas, bn_state = encode_for_base(params, spec, vid_feats,
                                                            train)
    if cap is s2vt:
        out = s2vt.decode(params["caption_net"], spec, outs, rnn_state, s, train=train,
                          teacher_force_prob=teacher_force_prob, emit=emit, noise=noise)
    else:
        out = s2vt_att.decode(params["caption_net"], spec, outs, rnn_state, s,
                              train=train, emit=emit, out_keep=noise)
    return out, seq_alphas, bn_state


base.register("spatial", init_params, apply)
