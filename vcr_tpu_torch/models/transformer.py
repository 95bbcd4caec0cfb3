"""The Transformer captioner: the counterpart of ``vcr_tpu/models/transformer.py``
(the reference's TransformerNet), with its quirks kept for checkpoint and
decode parity:

* the encoder runs at the raw feature width (4096) and the decoder at the
  word-vector width (300); attention projects width -> hidden (512) ->
  width, the feed-forward width <-> 2048;
* ``Norm`` is a hand-rolled LayerNorm with the unbiased std
  (``nn.layers.torch_norm``);
* the positional encoding scales by sqrt(seq_len), not sqrt(d_model), and
  its cos channel takes the exponent 2(i+1)/d;
* training feeds the *unshifted* target sentence to the decoder;
* the internal dropouts are the hard-coded :data:`INTERNAL_DROPOUT`; only the
  output projection's input uses ``spec.dropout_p``.

Three decodes, which differ on purpose:

* :func:`decode_greedy`, the parity decode of eval and the command line:
  each step re-runs the whole decoder stack on the padded prefix, because
  the sqrt(prefix length) scale changes every prefix embedding each step;
* :func:`make_cached_stepper` and :func:`decode_greedy_fast`, the KV-cached
  serving decode: each token keeps the sqrt(i+1) scale of the step that
  emitted it, so its keys and values are reused. Its tokens are not the
  parity decode's; with :func:`_pe_scale` neutralized they are;
* the stepper's ``lineage=True`` form for beam search, whose caches are
  written once and never reordered: an ancestry matrix says which row holds
  each beam's history, and both reads through it are true gathers.

The KV-cached steppers also serve the quantized modes: int8 or int4 K/V
caches (``ops/kvquant.py``) and int8 decoder weights (``ops/wquant.py``,
:func:`quantize_decoder_params`), bounded-error modes whose tokens are not
the bf16 stepper's.

Training keeps the residual stream in the compute dtype when that is bf16
(:func:`_stream_cast`), and recomputes each norm of such a stream in the
backward (:func:`_norm`, ``torch.utils.checkpoint``). The JAX package's
``VCR_TF_F32_STREAM`` and ``VCR_TF_FF_REMAT`` overrides are not ported: this
package reads no environment variable.

Randomness: the train branch's dropout keep-masks are all drawn before the
forward (:func:`draw_train_noise`), from a generator on the features' device
(an int seed, or a ``torch.Generator``), in the order the layers use them.

The layers are stacked on a leading axis, as the JAX package stacks them for
its scan, so ``bridge.from_jax_params`` maps a parameter tree leaf for leaf;
the stack runs as a Python loop over that axis. No kernel of this package
runs here: the products are ``torch`` products, as they are XLA's in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from vcr_tpu_torch.models import base
from vcr_tpu_torch.models.s2vt import Rng, _check_call, generator_for
from vcr_tpu_torch.nn.attention import mha_apply, mha_init
from vcr_tpu_torch.nn.layers import (apply_keep_mask, bmm_f32, dense, dense_init, embed,
                                     embedding_init, keep_mask, mask_vocab_pad,
                                     vocab_argmax, norm_init,
                                     torch_norm)
from vcr_tpu_torch.ops import kvquant, wquant

INTERNAL_DROPOUT = 0.1  # the reference hard-codes 0.1 for every internal dropout
D_FF = 2048


def _width(flag: str, spec: base.ModelSpec) -> int:
    """The encoder's layers run at the raw feature width, the decoder's at
    the word-vector width."""
    return spec.vid_feat_size if flag == "e" else spec.embed_size


def make_positional_encoding(d_model: int, max_seq_len: int = 80) -> np.ndarray:
    """The reference's PE table, with its 2(i+1)/d exponent on the cos
    channel; an odd width's last sin has no cos partner."""
    pe = np.zeros((max_seq_len, d_model), dtype=np.float32)
    for pos in range(max_seq_len):
        for i in range(0, d_model, 2):
            pe[pos, i] = math.sin(pos / (10000 ** ((2 * i) / d_model)))
            if i + 1 < d_model:
                pe[pos, i + 1] = math.cos(pos / (10000 ** ((2 * (i + 1)) / d_model)))
    return pe


# ---------------------------------------------------------------- layers

def _ff_init(gen: torch.Generator, flag: str, spec: base.ModelSpec) -> dict:
    size = _width(flag, spec)
    return {"linear_1": dense_init(gen, size, D_FF), "linear_2": dense_init(gen, D_FF, size)}


def _drop(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if keep is None else apply_keep_mask(x, keep, rate)


def _ff_apply(params, x: torch.Tensor, cdtype: torch.dtype,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = torch.relu(_dn(params["linear_1"], x, cdtype))
    return _dn(params["linear_2"], _drop(h, keep, INTERNAL_DROPOUT), cdtype)


def _stream_cast(x: torch.Tensor, train: bool, cdtype: torch.dtype) -> torch.Tensor:
    """At train under a bf16 compute dtype the residual stream is kept in
    it; otherwise it stays float32."""
    return x.to(cdtype) if train and cdtype != torch.float32 else x


def _norm(params, x: torch.Tensor, train: bool) -> torch.Tensor:
    """The Norm; at train over a non-float32 stream it is recomputed in the
    backward from its bf16 input instead of keeping float32 intermediates,
    as the JAX package's ``_norm_remat``."""
    if train and x.dtype != torch.float32 and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(torch_norm, params, x, use_reentrant=False)
    return torch_norm(params, x)


def _encoder_layer_init(gen: torch.Generator, spec: base.ModelSpec) -> dict:
    w = _width("e", spec)
    return {"norm_1": norm_init(w), "norm_2": norm_init(w),
            "attn": mha_init(gen, spec.hidden_size, "e", spec.vid_feat_size,
                             spec.embed_size),
            "ff": _ff_init(gen, "e", spec)}


def _encoder_layer(params, x: torch.Tensor, mask, heads: int, train: bool,
                   cdtype: torch.dtype, keep: Optional[Dict] = None) -> torch.Tensor:
    keep = keep or {}
    x2 = _norm(params["norm_1"], x, train)
    a = mha_apply(params["attn"], heads, x2, x2, x2, mask, keep.get("attn"),
                  INTERNAL_DROPOUT, cdtype)
    x = x + _drop(a, keep.get("attn_out"), INTERNAL_DROPOUT).to(x.dtype)
    x2 = _norm(params["norm_2"], x, train)
    f = _ff_apply(params["ff"], x2, cdtype, keep.get("ff"))
    return x + _drop(f, keep.get("ff_out"), INTERNAL_DROPOUT).to(x.dtype)


def _decoder_layer_init(gen: torch.Generator, spec: base.ModelSpec) -> dict:
    w = _width("d", spec)
    return {"norm_1": norm_init(w), "norm_2": norm_init(w), "norm_3": norm_init(w),
            # self-attention at the decoder's width; cross: q at the
            # decoder's, k and v at the encoder's
            "attn_1": mha_init(gen, spec.hidden_size, "d", spec.vid_feat_size,
                               spec.embed_size),
            "attn_2": mha_init(gen, spec.hidden_size, "ed", spec.vid_feat_size,
                               spec.embed_size),
            "ff": _ff_init(gen, "d", spec)}


def _decoder_layer(params, x: torch.Tensor, e_outputs: torch.Tensor, src_mask, trg_mask,
                   heads: int, train: bool, cdtype: torch.dtype,
                   keep: Optional[Dict] = None) -> torch.Tensor:
    keep = keep or {}
    x2 = _norm(params["norm_1"], x, train)
    a = mha_apply(params["attn_1"], heads, x2, x2, x2, trg_mask, keep.get("self"),
                  INTERNAL_DROPOUT, cdtype)
    x = x + _drop(a, keep.get("self_out"), INTERNAL_DROPOUT).to(x.dtype)
    x2 = _norm(params["norm_2"], x, train)
    a = mha_apply(params["attn_2"], heads, x2, e_outputs, e_outputs, src_mask,
                  keep.get("cross"), INTERNAL_DROPOUT, cdtype)
    x = x + _drop(a, keep.get("cross_out"), INTERNAL_DROPOUT).to(x.dtype)
    x2 = _norm(params["norm_3"], x, train)
    f = _ff_apply(params["ff"], x2, cdtype, keep.get("ff"))
    return x + _drop(f, keep.get("ff_out"), INTERNAL_DROPOUT).to(x.dtype)


def stack_layers(dicts: List[dict]) -> dict:
    """Per-layer dicts -> one dict of tensors stacked on a leading axis."""
    return {k: stack_layers([d[k] for d in dicts]) if isinstance(dicts[0][k], dict)
            else torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def init_params(gen: torch.Generator, spec: base.ModelSpec, glove_vectors) -> dict:
    """Float32 parameters on the CPU, drawn from the CPU generator ``gen``:
    the encoder's layers, then the decoder's, then the output projection."""
    n = spec.tf_layers
    enc_layers = [_encoder_layer_init(gen, spec) for _ in range(n)]
    dec_layers = [_decoder_layer_init(gen, spec) for _ in range(n)]
    return {
        "encoder": {
            "pe": torch.from_numpy(make_positional_encoding(spec.vid_feat_size)),
            "layers": stack_layers(enc_layers),
            "norm": norm_init(_width("e", spec)),
        },
        "decoder": {
            "embedding": embedding_init(glove_vectors, spec.padded_vocab_size),
            "pe": torch.from_numpy(make_positional_encoding(spec.embed_size)),
            "layers": stack_layers(dec_layers),
            # the reference builds norm and norm_out and uses only norm_out;
            # both are kept for checkpoint conversion
            "norm": norm_init(_width("d", spec)),
            "norm_out": norm_init(_width("d", spec)),
            "pred_linear": dense_init(gen, _width("d", spec), spec.padded_vocab_size),
        },
    }


# ---------------------------------------------------------------- forward

def _pe_scale(scale_len) -> float:
    """The reference's sqrt(seq_len) embedding scale. Factored out so tests
    can neutralize it when holding the KV-cached decode against the parity
    decode."""
    return math.sqrt(scale_len)


def _apply_pe(pe: torch.Tensor, x: torch.Tensor, scale_len) -> torch.Tensor:
    """x * sqrt(scale_len) + pe[:L], in float32: in the JAX package a bf16 x
    times the float32 scale promotes to float32, where torch would keep
    bf16."""
    return x.float() * _pe_scale(scale_len) + pe[None, :x.shape[1]]


def draw_train_noise(gen: torch.Generator, spec: base.ModelSpec, batch: int,
                     frames: int, length: int, device) -> Dict:
    """The train forward's dropout keep-masks, drawn from ``gen`` in this
    order: per encoder layer the attention probabilities (B, h, N, N), the
    attention's output, the feed-forward's hidden (B, N, 2048) and its
    output; per decoder layer the self-attention's probabilities and
    output, the cross-attention's (B, h, L, N) and output, the
    feed-forward's hidden and output; then the output projection's input.
    Internal masks are None where :data:`INTERNAL_DROPOUT` is 0, the last
    where ``spec.dropout_p`` is."""
    h, rate = spec.tf_heads, INTERNAL_DROPOUT
    ew, dw = _width("e", spec), _width("d", spec)

    def draw(shape, p=rate):
        return keep_mask(shape, p, gen, device) if p > 0.0 else None

    encoder = [{"attn": draw((batch, h, frames, frames)),
                "attn_out": draw((batch, frames, ew)),
                "ff": draw((batch, frames, D_FF)),
                "ff_out": draw((batch, frames, ew))} for _ in range(spec.tf_layers)]
    decoder = [{"self": draw((batch, h, length, length)),
                "self_out": draw((batch, length, dw)),
                "cross": draw((batch, h, length, frames)),
                "cross_out": draw((batch, length, dw)),
                "ff": draw((batch, length, D_FF)),
                "ff_out": draw((batch, length, dw))} for _ in range(spec.tf_layers)]
    return {"encoder": encoder, "decoder": decoder,
            "pred": draw((batch, length, dw), spec.dropout_p)}


def encode(params, spec: base.ModelSpec, vid_features: torch.Tensor, src_mask,
           train: bool = False, noise: Optional[List[Dict]] = None) -> torch.Tensor:
    """(B, N, V) -> encoder outputs (B, N, V); ``noise`` the encoder
    layers' keep-masks (:func:`draw_train_noise`), none without it."""
    enc = params["encoder"]
    x = _stream_cast(_apply_pe(enc["pe"], vid_features, vid_features.shape[1]), train,
                     spec.cdtype)
    for i in range(spec.tf_layers):
        x = _encoder_layer(layer_params(enc["layers"], i), x, src_mask, spec.tf_heads,
                           train, spec.cdtype, noise[i] if noise else None)
    return _norm(enc["norm"], x, train)


def _run_decoder(params, spec: base.ModelSpec, x: torch.Tensor, e_outputs, src_mask,
                 trg_mask, train: bool, noise: Optional[List[Dict]] = None
                 ) -> torch.Tensor:
    layers = params["decoder"]["layers"]
    for i in range(spec.tf_layers):
        x = _decoder_layer(layer_params(layers, i), x, e_outputs, src_mask, trg_mask,
                           spec.tf_heads, train, spec.cdtype, noise[i] if noise else None)
    return x


def decode_train(params, spec: base.ModelSpec, e_outputs: torch.Tensor, s: torch.Tensor,
                 src_mask, trg_mask, train: bool = False, noise: Optional[Dict] = None
                 ) -> torch.Tensor:
    """The parallel training pass -> logits (B, L, padded vocab) float32.
    The input is the *unshifted* target sentence, as in the reference.
    ``noise``: :func:`draw_train_noise`'s dict, or None for no dropout."""
    dec = params["decoder"]
    x = embed(dec["embedding"], s.to(torch.int32))
    x = _stream_cast(_apply_pe(dec["pe"], x, x.shape[1]), train, spec.cdtype)
    x = _run_decoder(params, spec, x, e_outputs, src_mask, trg_mask, train,
                     noise["decoder"] if noise else None)
    x = _norm(dec["norm_out"], x, train)
    x = _drop(x, noise["pred"] if noise else None, spec.dropout_p)
    return mask_vocab_pad(dense(dec["pred_linear"], x, spec.cdtype), spec.vocab_size)


def _causal(length: int, device) -> torch.Tensor:
    """(1, 1, L, L), True where a row may attend."""
    return torch.ones((length, length), dtype=torch.bool, device=device).tril()[None, None]


def decode_greedy(params, spec: base.ModelSpec, e_outputs: torch.Tensor,
                  src_mask) -> torch.Tensor:
    """The parity greedy decode -> logits (B, L, padded vocab): each step
    re-runs the whole decoder stack on the prefix padded to L under the
    causal mask, with the sqrt(i+1) scale of that step. Row i of the padded
    run attends to columns <= i only, so it equals the reference's
    growing-prefix run."""
    dec = params["decoder"]
    b, length, device = e_outputs.shape[0], spec.max_len, e_outputs.device
    causal = _causal(length, device)
    outputs = torch.zeros((b, length), dtype=torch.int32, device=device)
    outputs[:, 0] = spec.sos_id
    logits_all = []
    for i in range(length):
        x = _apply_pe(dec["pe"], embed(dec["embedding"], outputs), i + 1)
        h = torch_norm(dec["norm_out"], _run_decoder(params, spec, x, e_outputs, src_mask,
                                                     causal, train=False))
        logits = mask_vocab_pad(dense(dec["pred_linear"], h[:, i], spec.cdtype),
                                spec.vocab_size)
        if i + 1 < length:
            outputs = outputs.clone()
            outputs[:, i + 1] = vocab_argmax(logits)
        logits_all.append(logits)
    return torch.stack(logits_all, dim=1)


# ---------------------------------------------------------------- the KV-cached stepper

def _lineage_select(scores_all: torch.Tensor, anc_b: torch.Tensor) -> torch.Tensor:
    """out[b, t, h, j] = scores_all[b, t, h, j, anc_b[b, t, j]]: a true
    gather, never a one-hot product, so the selected scores are the bits
    computed."""
    b, t, h, length, _ = scores_all.shape
    idx = anc_b[:, :, None, :, None].long().expand(b, t, h, length, 1)
    return torch.gather(scores_all, -1, idx)[..., 0]


def _lineage_gather_rows(cache_b: torch.Tensor, anc_b: torch.Tensor) -> torch.Tensor:
    """cache_b (B, s, h, L, d), anc_b (B, t, L) -> (B, t, h, L, d):
    out[b, t, h, j, :] = cache_b[b, anc_b[b, t, j], h, j, :], a true gather
    of each beam's history rows. Reducing the context over j after it makes
    the sums' order independent of the ancestry, so ancestry tracking gives
    the bits of physically reordered caches."""
    b, s, h, length, d = cache_b.shape
    idx = anc_b[:, :, None, :, None].long().expand(b, anc_b.shape[1], h, length, d)
    return torch.gather(cache_b, 1, idx)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(rows, S, hidden) -> (rows, h, S, d_k)."""
    return x.reshape(x.shape[0], -1, heads, x.shape[-1] // heads).transpose(1, 2)


def _dn(p, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """A dense dict's product: through its int8 codes where it holds them
    (``ops.wquant.dense_q``, the decoder under ``decode_weights="int8"``),
    else ``nn.layers.dense``."""
    return wquant.dense_q(p, x, cd) if "wq" in p else dense(p, x, cd)


def quantize_decoder_params(params: dict) -> dict:
    """W8 decode weights: the decoder's dense dicts (both attentions' q, k,
    v and out, the feed-forward, pred_linear) replaced by int8 codes and
    per-column scales (``ops.wquant.quantize_dense``; the stacked layers
    quantize per layer). The encoder, embedding, PE and norms are untouched.
    Idempotent: the slot pool quantizes once, and its steppers find the
    codes."""
    dec = params["decoder"]
    if "wq" in dec["pred_linear"]:
        return params
    layers = dict(dec["layers"])
    for name in ("attn_1", "attn_2", "ff"):
        layers[name] = {k: wquant.quantize_dense(v) for k, v in layers[name].items()}
    return dict(params, decoder=dict(dec, layers=layers,
                                     pred_linear=wquant.quantize_dense(dec["pred_linear"])))


def _maybe_quantize_decoder(params: dict, decode_weights: str) -> dict:
    """The parameters a stepper decodes with: the decoder quantized under
    ``decode_weights="int8"``, else as given."""
    return quantize_decoder_params(params) if decode_weights == "int8" else params


def _attn_hidden(layers: dict) -> int:
    """The attention's hidden width, read off a float or quantized tree."""
    q = layers["attn_1"]["q"]
    return (q["w"] if "w" in q else q["wq"]).shape[-1]


def _zero_kv(rows: int, heads: int, length: int, d_k: int, cd: torch.dtype,
             kv_cache: str, device) -> tuple:
    """An empty K/V cache of (rows, h, length) vectors, each leaf a tensor
    of its own: (k, v) in the compute dtype, or quantized (k codes, k
    scales, v codes, v scales) with float32 scales (rows, h, length)."""
    if kv_cache == "bf16":
        return tuple(torch.zeros((rows, heads, length, d_k), dtype=cd, device=device)
                     for _ in range(2))
    _, code_dtype = kvquant.mode_params(kv_cache)
    width = kvquant.code_width(kv_cache, d_k)
    return tuple(torch.zeros((rows, heads, length, width), dtype=code_dtype, device=device)
                 if j % 2 == 0 else
                 torch.zeros((rows, heads, length), dtype=torch.float32, device=device)
                 for j in range(4))


def _cross_kv(attn_p, e_outputs: torch.Tensor, heads: int, cd: torch.dtype,
              kv_cache: str = "bf16") -> tuple:
    """The cross-attention's K and V of the encoder outputs, (rows, h, S,
    d_k) in the compute dtype, or under a quantized ``kv_cache`` their codes
    and scales (``ops.kvquant.quantize_store`` of the compute-dtype
    vectors)."""
    k = _split_heads(_dn(attn_p["k"], e_outputs, cd), heads).to(cd)
    v = _split_heads(_dn(attn_p["v"], e_outputs, cd), heads).to(cd)
    if kv_cache == "bf16":
        return k, v
    return (*kvquant.quantize_store(k, kv_cache), *kvquant.quantize_store(v, kv_cache))


def _attend_cross(attn_p, x2: torch.Tensor, kv, heads: int, cd: torch.dtype) -> torch.Tensor:
    """One token's cross-attention over the video's K and V (a quantized
    ``kv``: K's scales fold into the scores, V's into the weights)."""
    q = _split_heads(_dn(attn_p["q"], x2, cd), heads)
    if len(kv) == 2:
        k, v = kv
        w = torch.softmax(bmm_f32(q, k.transpose(-1, -2), cd) / q.shape[-1] ** 0.5, dim=-1)
        ctx = bmm_f32(w, v, cd)
    else:
        kq, ks, vq, vs = kv
        scores = bmm_f32(q, kvquant.unpack(kq).transpose(-1, -2), cd) / q.shape[-1] ** 0.5
        w = torch.softmax(kvquant.fold_k(scores, ks[:, :, None, :]), dim=-1)
        ctx = bmm_f32(kvquant.fold_v(w, vs[:, :, None, :]), kvquant.unpack(vq), cd)
    out = ctx.transpose(1, 2).reshape(x2.shape[0], 1, -1)
    return _dn(attn_p["out"], out, cd)


def _attend_self(attn_p, q: torch.Tensor, cache, masked: torch.Tensor,
                 cd: torch.dtype) -> torch.Tensor:
    """One token's self-attention against its row's cache (k, v) or
    quantized (k codes, k scales, v codes, v scales), itself included;
    ``masked`` (broadcast to (rows, h, 1, L)) is True at positions not yet
    written."""
    if len(cache) == 2:
        ck, cv = cache
        scores = bmm_f32(q, ck.transpose(-1, -2), cd) / q.shape[-1] ** 0.5   # (rows, h, 1, L)
        w = torch.softmax(scores.masked_fill(masked, -1e9), dim=-1)
        ctx = bmm_f32(w, cv, cd)                                              # (rows, h, 1, d)
    else:
        ck, ks, cv, vs = cache
        scores = bmm_f32(q, kvquant.unpack(ck).transpose(-1, -2), cd) / q.shape[-1] ** 0.5
        scores = kvquant.fold_k(scores, ks[:, :, None, :])
        w = torch.softmax(scores.masked_fill(masked, -1e9), dim=-1)
        ctx = bmm_f32(kvquant.fold_v(w, vs[:, :, None, :]), kvquant.unpack(cv), cd)
    return _dn(attn_p["out"], ctx.transpose(1, 2).reshape(q.shape[0], 1, -1), cd)


def _attend_lineage(attn_p, q: torch.Tensor, cache, anc: torch.Tensor,
                    masked: torch.Tensor, beam_tile: int, cd: torch.dtype) -> torch.Tensor:
    """The lineage form of :func:`_attend_self`: each item's beam_tile rows
    are scored against every source row of the item, and the scores and the
    context's V rows are selected through the ancestry ``anc`` (rows, L),
    both true gathers; ``masked`` broadcasts to (items, beam_tile, h, L).
    A quantized cache folds K's scales into the scores of every source row
    before the select, and gathers V's scales beside its codes."""
    rows, heads, _, d_k = q.shape
    quant = len(cache) == 4
    ck, cv = (cache[0], cache[2]) if quant else cache
    length, k_b = ck.shape[2], beam_tile
    items = rows // k_b
    qb = q.reshape(items, k_b, heads, d_k).transpose(1, 2)                 # (B, h, t, d)
    kb = (kvquant.unpack(ck) if quant else ck).reshape(
        items, k_b, heads, length, d_k).transpose(1, 2).reshape(
        items, heads, k_b * length, d_k)                                    # (B, h, s*j, d)
    # every target beam against every source row: (B, t, h, j, s)
    scores_all = (bmm_f32(qb, kb.transpose(-1, -2), cd) / d_k ** 0.5).reshape(
        items, heads, k_b, k_b, length).permute(0, 2, 1, 4, 3)
    if quant:
        scores_all = kvquant.fold_k(
            scores_all, cache[1].reshape(items, k_b, heads, length).permute(0, 2, 3, 1)[:, None])
    anc_b = anc.reshape(items, k_b, length)
    scores = _lineage_select(scores_all, anc_b)                            # (B, t, h, L)
    w = torch.softmax(scores.masked_fill(masked, -1e9), dim=-1)
    vsel = _lineage_gather_rows(cv.reshape(items, k_b, heads, length, -1), anc_b)
    if quant:
        vs = _lineage_gather_rows(cache[3].reshape(items, k_b, heads, length, 1),
                                  anc_b)[..., 0]
        ctx = ((w.to(cd).float() * vs)[..., None]
               * kvquant.unpack(vsel).float()).sum(dim=3)                  # (B, t, h, d)
    else:
        ctx = (w.to(cd).float()[..., None] * vsel.float()).sum(dim=3)      # (B, t, h, d)
    return _dn(attn_p["out"], ctx.reshape(rows, 1, heads * d_k), cd)


def _decoder_step(dec, per_layer, spec: base.ModelSpec, x: torch.Tensor, state: dict,
                  cross, attend_self):
    """The decoder stack on one token per row: ``attend_self(attn_p, x2,
    cache) -> (out, cache)`` is a layer's self-attention against its cache
    ``state["c{li}"]``, ``cross[li]`` layer li's K and V. -> (the layers' new
    caches, logits (rows, V))."""
    caches = {}
    for li, lp in enumerate(per_layer):
        a, caches[f"c{li}"] = attend_self(lp["attn_1"], torch_norm(lp["norm_1"], x),
                                          state[f"c{li}"])
        x = x + a
        x = x + _attend_cross(lp["attn_2"], torch_norm(lp["norm_2"], x), cross[li],
                              spec.tf_heads, spec.cdtype)
        x = x + _ff_apply(lp["ff"], torch_norm(lp["norm_3"], x), spec.cdtype)
    h = torch_norm(dec["norm_out"], x)[:, 0]
    return caches, mask_vocab_pad(_dn(dec["pred_linear"], h, spec.cdtype), spec.vocab_size)


def _new_kv(attn_p, x2: torch.Tensor, heads: int, cd: torch.dtype, kv_cache: str):
    """This token's query and the K and V to write: in the compute dtype,
    or (codes, scales) pairs of the float32 products under a quantized
    cache."""
    q = _split_heads(_dn(attn_p["q"], x2, cd), heads)
    k = _split_heads(_dn(attn_p["k"], x2, cd), heads)
    v = _split_heads(_dn(attn_p["v"], x2, cd), heads)
    if kv_cache == "bf16":
        return q, ((k,), (v,))
    return q, (kvquant.quantize_store(k, kv_cache), kvquant.quantize_store(v, kv_cache))


def make_cached_stepper(params, spec: base.ModelSpec, e_outputs: torch.Tensor,
                        beam_tile: int = 1, lineage: bool = False,
                        kv_cache: Optional[str] = None,
                        decode_weights: Optional[str] = None):
    """The KV-cached one-token decoder step of serving, shared by the fast
    greedy decode, beam search and sampling.

    Not token-parity with the reference: each token keeps the sqrt(i+1)
    scale of the step that emitted it, so past keys and values are reused
    (use :func:`decode_greedy` for parity). ``e_outputs`` (B, S, V) is
    untiled; the stepper serves rows = B * beam_tile, each item's beams
    adjacent. The cross-attention's K and V are projected once from the
    untiled outputs and then repeated per beam.

    -> (step_fn(state, words (rows,), i) -> (state, logits (rows, V)),
    init_state), and with ``lineage=True`` also ``lineage_reorder(state,
    flat_src)``. The state is {"c0".."c{n-1}": (k, v)}, per-layer (rows, h,
    L, d_k) self-attention caches in the compute dtype, every leaf
    rows-leading, so beam search's default reorder gathers them; step_fn
    returns a new state and leaves the one it was given as it was.

    ``lineage=True``: the caches are written once at each row's own slot
    and never moved; the state also holds ``anc`` (rows, L) int32, which of
    the item's beam_tile rows holds beam r's token j, and the reorder
    permutes only that. The scores are taken against every source row of
    the item and selected through the ancestry, the context from the
    ancestry's V rows reduced over positions: both true gathers.

    ``kv_cache="int8"|"int4"`` stores the self and cross K/V quantized
    (``ops.kvquant``): each layer's state is (k codes, k scales, v codes, v
    scales), the scales float32 (rows, h, L), int4 codes packed two to a
    byte. ``decode_weights="int8"`` streams every decoder dense as int8
    codes (:func:`quantize_decoder_params`). Both are bounded-error modes:
    their tokens are not the bf16 stepper's. None means ``"bf16"``
    (``base.check_serving_modes``)."""
    kv_cache, decode_weights = base.check_serving_modes(kv_cache, decode_weights)
    dec = _maybe_quantize_decoder(params, decode_weights)["decoder"]
    rows = e_outputs.shape[0] * beam_tile
    length, heads, cd = spec.max_len, spec.tf_heads, spec.cdtype
    d_k = _attn_hidden(dec["layers"]) // heads
    device = e_outputs.device
    per_layer = [layer_params(dec["layers"], i) for i in range(spec.tf_layers)]
    cross = []
    for lp in per_layer:
        kv = _cross_kv(lp["attn_2"], e_outputs, heads, cd, kv_cache)
        if beam_tile > 1:
            # per-vector codes and scales: repeating them equals quantizing
            # the repeated vectors
            kv = tuple(t.repeat_interleave(beam_tile, 0) for t in kv)
        cross.append(kv)

    init_state = {f"c{i}": _zero_kv(rows, heads, length, d_k, cd, kv_cache, device)
                  for i in range(spec.tf_layers)}
    pos = torch.arange(length, device=device)
    row_local = (torch.arange(rows, device=device) % beam_tile).to(torch.int32)

    def step_fn(state, words, i):
        x = embed(dec["embedding"], words)[:, None, :]
        x = x.float() * _pe_scale(i + 1) + dec["pe"][i:i + 1][None]
        anc = None
        if lineage:
            # this step's K and V land in each row's own slot: claim column i
            # before attending (later columns hold stale values, masked off)
            anc = state["anc"].slice_scatter(row_local[:, None], 1, i, i + 1)
        masked = pos > i

        def attend(attn_p, x2, cache):
            q, (new_k, new_v) = _new_kv(attn_p, x2, heads, cd, kv_cache)
            new = (*new_k, *new_v)
            cache = tuple(c.slice_scatter(n.to(c.dtype), 2, i, i + 1)
                          for c, n in zip(cache, new))
            if lineage:
                return _attend_lineage(attn_p, q, cache, anc, masked, beam_tile, cd), cache
            return _attend_self(attn_p, q, cache, masked, cd), cache

        new_state, logits = _decoder_step(dec, per_layer, spec, x, state, cross, attend)
        if lineage:
            new_state["anc"] = anc
        return new_state, logits

    if not lineage:
        return step_fn, init_state

    init_state = dict(init_state, anc=row_local[:, None].repeat(1, length))

    def lineage_reorder(state, flat_src):
        """Only the ancestry matrix is permuted; the caches stay in place."""
        return {k: (v[flat_src] if k == "anc" else v) for k, v in state.items()}

    return step_fn, init_state, lineage_reorder


def make_slot_stepper(params, spec: base.ModelSpec, beam_tile: int = 1,
                      lineage: bool = False, kv_cache: Optional[str] = None,
                      decode_weights: Optional[str] = None):
    """The KV-cached decoder step of continuous-batching serving
    (:class:`vcr_tpu_torch.serving_continuous.ContinuousCaptioner`), where
    every row carries its own position ``i_vec`` (rows,) int: its slot was
    admitted at its own time. The three uses of the position are per row:
    this step's K and V are written at (row, :, i_vec[row], :), the causal
    mask is pos > i_vec[row], and the PE term and scale are pe[i_vec] and
    sqrt(i_vec + 1). With a uniform i_vec each step equals
    :func:`make_cached_stepper`'s element for element.

    The cross-attention's K and V depend on the slot's video, so they are
    slot state (``cross_state``, computed once per admission), not a
    closure.

    -> (step_fn(state, words (rows,), i_vec (rows,)) -> (state, logits
    (rows, V)), init_self_state(rows) -> {"c{l}": (k, v)} of zeros (rows,
    h, L, d_k) on the parameters' device, every leaf a tensor of its own,
    cross_state(e_outputs (rows, S, width)) -> {"x{l}": (k, v)} (rows, h,
    S, d_k)). The slot state is init_self_state's and cross_state's leaves
    together, all rows-leading, so admission can copy rows in; step_fn
    returns a new state and leaves the one it was given as it was.

    ``lineage=True`` with ``beam_tile=K`` is the continuous beam's cell:
    rows are slot-major groups of K beams, the caches are written once at
    each row's own slot and never moved, and the state also holds ``anc``
    (rows, L), the ancestry of :func:`make_cached_stepper`'s lineage form,
    here with per-row positions; reordering beams permutes only ``anc``.
    After admission each fresh group's ancestry must be re-armed to its
    local identity (row % K in every column).

    ``kv_cache`` and ``decode_weights``: :func:`make_cached_stepper`'s
    modes; under a quantized cache every (k, v) above is (k codes, k
    scales, v codes, v scales). Pass parameters already quantized by
    :func:`quantize_decoder_params` to quantize once."""
    kv_cache, decode_weights = base.check_serving_modes(kv_cache, decode_weights)
    dec = _maybe_quantize_decoder(params, decode_weights)["decoder"]
    length, heads, cd = spec.max_len, spec.tf_heads, spec.cdtype
    d_k = _attn_hidden(dec["layers"]) // heads
    device = dec["pe"].device
    per_layer = [layer_params(dec["layers"], i) for i in range(spec.tf_layers)]
    pos = torch.arange(length, device=device)

    def cross_state(e_outputs):
        return {f"x{li}": _cross_kv(lp["attn_2"], e_outputs, heads, cd, kv_cache)
                for li, lp in enumerate(per_layer)}

    def init_self_state(rows: int):
        out = {f"c{li}": _zero_kv(rows, heads, length, d_k, cd, kv_cache, device)
               for li in range(spec.tf_layers)}
        if lineage:
            row_local = (torch.arange(rows, device=device) % beam_tile).to(torch.int32)
            out["anc"] = row_local[:, None].repeat(1, length)
        return out

    def step_fn(state, words, i_vec):
        rows = words.shape[0]
        rows_idx = torch.arange(rows, device=device)
        i_long = i_vec.long()
        x = embed(dec["embedding"], words)[:, None, :]
        x = x.float() * (i_vec + 1).float().sqrt()[:, None, None] + dec["pe"][i_long][:, None]
        masked = pos[None, :] > i_vec[:, None]                          # (rows, L)
        anc = None
        if lineage:
            # this step's K and V land in each row's own slot: claim column
            # i_vec[row] before attending
            anc = state["anc"].clone()
            anc[rows_idx, i_long] = (rows_idx % beam_tile).to(anc.dtype)
            masked = masked.reshape(rows // beam_tile, beam_tile, 1, length)
        else:
            masked = masked[:, None, None, :]

        def write(c, new):
            """new (rows, h, 1, ...) at (row, :, i_vec[row])."""
            c = c.clone()
            c[rows_idx, :, i_long] = new[:, :, 0].to(c.dtype)
            return c

        def attend(attn_p, x2, cache):
            q, (new_k, new_v) = _new_kv(attn_p, x2, heads, cd, kv_cache)
            cache = tuple(write(c, n) for c, n in zip(cache, (*new_k, *new_v)))
            if lineage:
                return _attend_lineage(attn_p, q, cache, anc, masked, beam_tile, cd), cache
            return _attend_self(attn_p, q, cache, masked, cd), cache

        cross = [state[f"x{li}"] for li in range(spec.tf_layers)]
        caches, logits = _decoder_step(dec, per_layer, spec, x, state, cross, attend)
        new_state = dict(state, **caches)
        if lineage:
            new_state["anc"] = anc
        return new_state, logits

    return step_fn, init_self_state, cross_state


def decode_greedy_fast(params, spec: base.ModelSpec, e_outputs: torch.Tensor,
                       src_mask=None, kv_cache: Optional[str] = None,
                       decode_weights: Optional[str] = None) -> torch.Tensor:
    """The KV-cached greedy decode of serving -> tokens (B, L) int32 (see
    :func:`make_cached_stepper` for its scale, which is not the parity
    decode's)."""
    del src_mask
    step_fn, state = make_cached_stepper(params, spec, e_outputs, kv_cache=kv_cache,
                                         decode_weights=decode_weights)
    words = torch.full((e_outputs.shape[0],), spec.sos_id, dtype=torch.int32,
                       device=e_outputs.device)
    tokens = []
    for i in range(spec.max_len):
        state, logits = step_fn(state, words, i)
        words = logits.argmax(dim=-1).to(torch.int32)
        tokens.append(words)
    return torch.stack(tokens, dim=1)


# ---------------------------------------------------------------- masks and apply

def create_masks_inp(vid_features: torch.Tensor) -> torch.Tensor:
    """The all-ones source mask (B, 1, 1, N)."""
    b, n = vid_features.shape[:2]
    return torch.ones((b, 1, 1, n), device=vid_features.device)


def create_masks_trg(s: torch.Tensor, s_len: torch.Tensor) -> torch.Tensor:
    """Length mask and causal no-peek mask -> (B, 1, L, L) bool."""
    length = s.shape[1]
    cols = torch.arange(length, device=s.device)[None, :] < s_len[:, None]   # (B, L)
    return (cols[:, None, :] & _causal(length, s.device)[0])[:, None]


def apply(params, spec: base.ModelSpec, vid_feats: torch.Tensor,
          s: Optional[torch.Tensor] = None, s_len: Optional[torch.Tensor] = None,
          rng: Rng = None, train: bool = False, teacher_force_prob=1.0,
          emit: str = "logits", noise: Optional[Dict] = None) -> torch.Tensor:
    """The full forward -> logits (B, L, padded vocab) float32, or at eval
    with ``emit="tokens"`` the parity greedy tokens (B, L) int32. Train: the
    parallel pass under the length and causal target mask, its dropout
    keep-masks ``noise`` or drawn from ``rng``. Eval: the parity greedy
    decode. ``teacher_force_prob`` is unused, as in the JAX package."""
    del teacher_force_prob
    _check_call(s, train, emit)
    if train and emit != "logits":
        raise ValueError("emit='tokens' is eval-only")
    b, n = vid_feats.shape[:2]
    if train and noise is None:
        noise = draw_train_noise(generator_for(rng, vid_feats.device), spec, b, n,
                                 s.shape[1], vid_feats.device)
    src_mask = create_masks_inp(vid_feats)
    e_outputs = encode(params, spec, vid_feats, src_mask, train,
                       noise["encoder"] if train else None)
    if train:
        return decode_train(params, spec, e_outputs, s, src_mask,
                            create_masks_trg(s, s_len), train, noise)
    logits = decode_greedy(params, spec, e_outputs, src_mask)
    return logits.argmax(dim=-1).to(torch.int32) if emit == "tokens" else logits


base.register("transformer", init_params, apply)
