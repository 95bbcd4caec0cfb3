"""Decoding beyond greedy: beam search and sampling, for S2VT, S2VT-att, the
Transformer, and RationaleNet and SpatialNet over S2VT or S2VT-att. The
counterpart of those parts of ``vcr_tpu/decode.py``.

The beam folds into the batch axis: B*K rows go through the same cell as the
greedy decode (``_s2vt_stepper``, ``_s2vt_att_stepper``, the Transformer's
``make_cached_stepper``; plain PyTorch as in the JAX package), and
reordering the beams gathers the rows of the state. Encode (and S2VT's
prime) run once at B rows through kernel B1; S2VT-att's projected keys and
encoder outputs are tiled to B*K rows once, the outputs at the compute
dtype. Beam width 1 gives the greedy tokens up to and including the first
eos; after it the search holds finished rows at eos.

The Transformer has two beams, as in the JAX package:
:func:`transformer_beam_decode`, the parity beam of eval and the command
line, re-runs the whole decoder stack each step; serving's
:func:`transformer_beam_decode_fast` runs the KV-cached stepper, whose
caches are either gathered with their beams or, with ``lineage=True``, left
in place behind an ancestry matrix. Its sampling runs the KV-cached stepper
too.

Every family's beam picks its words through one function, :func:`beam_pick`
(the custom op ``vcr_tpu_torch::beam_pick``, ``ops/beam_pick.py``): on the
card one hand-written kernel a step (the log-softmax, the finished mask and
both top-k stages in one read of the logits; K <= 32), on the CPU its plain
version (the log-softmax, the ``where`` and two stable sorts). Both keep the
JAX package's ties, whose ``lax.top_k`` is index-stable: among equal scores
the lower word id wins within a beam, and the lower beam across beams.
``torch.topk`` promises no order among ties, so the plain version's
``ops.beam_pick.top_k`` takes the first k of a stable descending sort, and
the kernel orders its candidates by (value, index) exactly.

Sampling draws ``argmax(logits + g)`` with Gumbel noise g, which is
``jax.random.categorical``'s form; the noise comes from a ``torch.Generator``
seeded with an int, or is injected. Masked logits are ``NEG_INF``, a finite
number, so no noise draw makes a masked token win.

Quantized serving modes: ``decode_weights="int8"`` streams each stepper's
per-step dense weights as int8 codes with per-column scales
(``ops/wquant.py``; the GRU dicts are augmented, so the encoders keep
reading the float32 originals and run B1 and B2 as before), in the beam and
sampling decodes of every family; the Transformer's KV-cached decodes also
take ``kv_cache="int8"|"int4"`` (``ops/kvquant.py``). Both are
bounded-error modes: their tokens are not the bf16 decodes'. The
Transformer's parity beam has no stepper, and refuses int8 weights. An
unknown family raises. Nothing here reads an environment variable.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, s2vt, s2vt_att, spatial
from vcr_tpu_torch.models import transformer as tr
from vcr_tpu_torch.nn.attention import bahdanau_attend, bahdanau_project_keys
from vcr_tpu_torch.nn.gumbel import sample_gumbel
from vcr_tpu_torch.nn.layers import dense, embed, mask_vocab_pad, torch_norm, vdot
from vcr_tpu_torch.nn.rnn import gru_gates
from vcr_tpu_torch.ops import wquant
from vcr_tpu_torch.ops.beam_pick import NEG_INF
from vcr_tpu_torch.utils.profiling import span


def check_decode_mode(beam_size: int, temperature: float, top_k: int,
                      top_p: float) -> None:
    """Beam search and sampling exclude each other, and the sampling filters
    need sampling on: raise ValueError on a combination that would otherwise
    drop an option."""
    if temperature > 0 and beam_size > 1:
        raise ValueError("beam_size > 1 and sampling are mutually exclusive "
                         "(beam maximizes sequence log-prob; sampling draws "
                         "from it)")
    if temperature <= 0 and (top_k or top_p):
        raise ValueError("sample_top_k and sample_top_p filter sampling: set "
                         "sample_temperature > 0")


def _unknown(arch: str):
    """Raise for a name that is no family of this package."""
    model_base.build_model(arch)  # raises for an unknown family
    raise NotImplementedError(f"decode for {arch!r}")


def beam_pick(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
              k: int, eos_id: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam step's word pick over B items of k beams: logits (B*K, V),
    scores (B*K,) float32, finished (B*K,) bool -> (top_scores (B, K)
    float32, word_idx (B, K) int32, flat_src (B*K,) int64, the row each new
    beam continues). A finished beam continues with eos alone, at no cost.
    Through the custom op ``vcr_tpu_torch::beam_pick``: the kernel on CUDA
    tensors (k <= 32), the plain version on CPU tensors."""
    return torch.ops.vcr_tpu_torch.beam_pick(logits.float().contiguous(),
                                             scores.contiguous(), finished.contiguous(),
                                             k, eos_id)


def _tile_beam(tree, k: int):
    """Repeat each batch row k times: (B, ...) -> (B*K, ...)."""
    return {name: x.repeat_interleave(k, dim=0) for name, x in tree.items()}


def gather_rows(tree, idx: torch.Tensor):
    """Rows ``idx`` of every tensor of a nest of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: gather_rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(gather_rows(v, idx) for v in tree)
    return tree[idx]


def _device_of(tree) -> torch.device:
    """The device of the first tensor of a nest of dicts and tuples."""
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def beam_search(step_fn: Callable, init_state, batch: int, beam_size: int,
                max_len: int, sos_id: int, eos_id: int,
                reorder_fn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens (B, K, L) int32 sorted best-first, scores (B, K) float32).

    ``step_fn(state, words (B*K,), i) -> (state, logits (B*K, V))``;
    ``init_state`` a nest of dicts and tuples of tensors with B*K leading
    rows. Reordering the beams gathers the leading rows of every state
    tensor, or is ``reorder_fn(state, flat_src)`` where part of the state
    must not move (the Transformer's lineage stepper permutes only its
    ancestry matrix)."""
    k = beam_size
    reorder = reorder_fn or gather_rows
    device = _device_of(init_state)
    words = torch.full((batch * k,), sos_id, dtype=torch.int32, device=device)
    # only beam 0 of each item is live at step 0 (the beams start as copies)
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    scores = scores.reshape(-1)
    finished = torch.zeros((batch * k,), dtype=torch.bool, device=device)
    tokens = torch.zeros((batch * k, max_len), dtype=torch.int32, device=device)
    state = init_state
    for i in range(max_len):
        with span("decode.cell"):
            state, logits = step_fn(state, words, i)
        with span("decode.pick"):
            top_scores, word_idx, flat_src = beam_pick(logits, scores, finished, k, eos_id)
        with span("decode.reorder"):
            state = reorder(state, flat_src)
            # the histories follow their beams before step i is written
            tokens = tokens[flat_src]
            finished = finished[flat_src]
            words = word_idx.reshape(-1)
            tokens[:, i] = words
            finished = finished | (words == eos_id)
        scores = top_scores.reshape(-1)
    return tokens.reshape(batch, k, max_len), scores.reshape(batch, k)


def apply_sampling_filters(logits: torch.Tensor, temperature: float = 1.0,
                           top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """(rows, V) logits -> float32 logits scaled by 1/temperature with the
    non-candidates set to NEG_INF: optionally only the top_k, then optionally
    the top_p nucleus (the smallest probability-sorted set reaching mass
    top_p, over the already-filtered distribution)."""
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p and 0.0 < top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        sp = torch.sort(probs, dim=-1, descending=True).values
        before = torch.cumsum(sp, dim=-1) - sp            # mass strictly above
        keep = (before < top_p).sum(dim=-1, keepdim=True)  # >= 1
        thresh = sp.gather(-1, keep - 1)
        logits = torch.where(probs < thresh, NEG_INF, logits)
    return logits


def sample_search(step_fn: Callable, init_state, rows: int, max_len: int,
                  sos_id: int, eos_id: int, rng=0, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 0.0,
                  gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-step categorical sampling from softmax(logits / temperature),
    optionally restricted by top_k and/or top_p (:func:`apply_sampling_filters`).
    Rows that emitted eos keep emitting it. -> tokens (rows, max_len) int32.

    Step i adds Gumbel noise ``gumbel[i]`` (max_len, rows, V) where it is
    given, else a fresh (rows, V) draw from a generator seeded with ``rng``
    (an int, or a ``torch.Generator`` on the state's device)."""
    device = _device_of(init_state)
    gen = None if gumbel is not None else s2vt.generator_for(rng, device)
    words = torch.full((rows,), sos_id, dtype=torch.int32, device=device)
    finished = torch.zeros((rows,), dtype=torch.bool, device=device)
    state, out = init_state, []
    for i in range(max_len):
        with span("decode.cell"):
            state, logits = step_fn(state, words, i)
        with span("decode.pick"):
            logits = apply_sampling_filters(logits, temperature, top_k, top_p)
            noise = gumbel[i] if gumbel is not None else sample_gumbel(
                logits.shape, gen, device)
            sampled = (logits + noise).argmax(dim=-1).to(torch.int32)
            words = torch.where(finished, eos_id, sampled).to(torch.int32)
            finished = finished | (words == eos_id)
        out.append(words)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------- S2VT

def _x_gates(rnn, x: torch.Tensor, cd: torch.dtype, w8: bool) -> torch.Tensor:
    """x @ w_ih + b_ih, through the int8 codes under W8."""
    return wquant.gru_x_gates(rnn, x, cd) if w8 else vdot(x, rnn["w_ih"], cd) + rnn["b_ih"]


def _gru_step(xg: torch.Tensor, h: torch.Tensor, rnn, cd: torch.dtype,
              w8: bool) -> torch.Tensor:
    """One GRU step from its input gates, h @ w_hh through the codes under W8."""
    return gru_gates(xg, h, rnn, cd, h_gates=wquant.gru_h_gates(rnn, h, cd) if w8 else None)


def _vocab_logits(p, h: torch.Tensor, spec: model_base.ModelSpec, w8: bool) -> torch.Tensor:
    y = wquant.dense_aug(p, h, spec.cdtype) if w8 else dense(p, h, spec.cdtype)
    return mask_vocab_pad(y, spec.vocab_size)


def _s2vt_stepper(params, spec: model_base.ModelSpec, rows: int,
                  decode_weights: Optional[str] = None) -> Callable:
    """The S2VT decode cell as a (state, words, i) step over ``rows`` rows
    (B*K for beam search, B for sampling): the cell of the greedy decode
    (``s2vt.decode_from_states``).

    ``decode_weights="int8"``: GRU1's w_hh (its decode input is a zero
    frame, so w_ih is never read), GRU2's w_ih and w_hh and the vocabulary
    projection go through their int8 codes (:func:`augment_decode_weights`'s
    dicts; augmented here unless already)."""
    w8 = model_base.check_serving_modes(decode_weights=decode_weights)[1] == "int8"
    if w8:
        params = _augment_base(params, "s2vt")
    cd = spec.cdtype
    rnn1, rnn2 = params["rnn1"], params["rnn2"]
    # GRU1's decode-phase input is a zero frame: its input gates are b_ih
    xg1 = rnn1["b_ih"].expand(rows, 3 * spec.hidden_size)

    def step_fn(state, words, i):
        out1 = _gru_step(xg1, state["s1"], rnn1, cd, w8)
        emb = embed(params["embedding"], words)
        xg2 = _x_gates(rnn2, torch.cat([out1, emb], dim=-1), cd, w8)
        out2 = _gru_step(xg2, state["s2"], rnn2, cd, w8)
        return {"s1": out1, "s2": out2}, _vocab_logits(params["linear"], out2, spec, w8)

    return step_fn


def s2vt_beam_from_states(params, spec: model_base.ModelSpec, enc_outs: torch.Tensor,
                          state1: torch.Tensor, beam_size: int, eos_id: int,
                          decode_weights: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode from S2VT's encoder states: the prime through B1 at B
    rows, then the stepper at B*K rows."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B1 runs
    state2 = s2vt._prime_state2(params, spec, enc_outs)
    b = enc_outs.shape[1]
    init_state = _tile_beam({"s1": state1, "s2": state2}, beam_size)
    step_fn = _s2vt_stepper(params, spec, b * beam_size, decode_weights)
    return beam_search(step_fn, init_state, b, beam_size, spec.max_len,
                       spec.sos_id, eos_id)


def s2vt_sample_from_states(params, spec: model_base.ModelSpec, enc_outs: torch.Tensor,
                            state1: torch.Tensor, rng, eos_id: int,
                            temperature: float = 1.0, top_k: int = 0,
                            top_p: float = 0.0,
                            gumbel: Optional[torch.Tensor] = None,
                            decode_weights: Optional[str] = None) -> torch.Tensor:
    """Sampling decode from S2VT's encoder states."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B1 runs
    state2 = s2vt._prime_state2(params, spec, enc_outs)
    b = enc_outs.shape[1]
    step_fn = _s2vt_stepper(params, spec, b, decode_weights)
    return sample_search(step_fn, {"s1": state1, "s2": state2}, b, spec.max_len,
                         spec.sos_id, eos_id, rng, temperature, top_k, top_p,
                         gumbel=gumbel)


def s2vt_sample_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                       rng, eos_id: int, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0, gumbel: Optional[torch.Tensor] = None,
                       decode_weights: Optional[str] = None) -> torch.Tensor:
    """Temperature/top-k/top-p sampling decode for S2VT -> tokens (B, L)."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B1 runs
    with span("encode"):
        enc_outs, state1 = s2vt.encode(params, spec, vid_feats.to(spec.cdtype))
    return s2vt_sample_from_states(params, spec, enc_outs, state1, rng, eos_id,
                                   temperature, top_k, top_p, gumbel=gumbel,
                                   decode_weights=decode_weights)


def s2vt_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                     beam_size: int, eos_id: int,
                     decode_weights: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode for S2VT: the greedy decode's cell, B*K rows."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B1 runs
    with span("encode"):
        enc_outs, state1 = s2vt.encode(params, spec, vid_feats.to(spec.cdtype))
    return s2vt_beam_from_states(params, spec, enc_outs, state1, beam_size, eos_id,
                                 decode_weights=decode_weights)


# ------------------------------------------------------------ S2VT-att

def _s2vt_att_stepper(params, spec: model_base.ModelSpec, pk: torch.Tensor,
                      eo: torch.Tensor, decode_weights: Optional[str] = None) -> Callable:
    """The S2VT-att decode cell of the greedy decode (``s2vt_att.decode``)
    as a (state, words, i) step, closed over the (possibly beam-tiled)
    projected keys ``pk`` and encoder outputs ``eo``.

    ``decode_weights="int8"``: the GRU's w_ih and w_hh and the vocabulary
    projection go through their int8 codes; the attention's small denses
    stay float32 (the keys were projected at admission or encode)."""
    w8 = model_base.check_serving_modes(decode_weights=decode_weights)[1] == "int8"
    if w8:
        params = _augment_base(params, "s2vt-att")
    dec, cd = params["decoder"], spec.cdtype

    def step_fn(state, words, i):
        context, _ = bahdanau_attend(dec["attention"], state["h"], pk, eo, cd)
        emb = embed(dec["embedding"], words)
        if w8:
            xg = wquant.gru_x_gates(dec["rnn"], torch.cat([context, emb], dim=-1), cd)
            h = _gru_step(xg, state["h"], dec["rnn"], cd, w8)
        else:
            h = s2vt_att._gru_in(dec["rnn"], context, emb, state["h"], cd)
        return {"h": h}, _vocab_logits(dec["pred_linear"], h, spec, w8)

    return step_fn


def s2vt_att_beam_from_states(params, spec: model_base.ModelSpec,
                              encoder_outs: torch.Tensor, encoder_final: torch.Tensor,
                              beam_size: int, eos_id: int,
                              decode_weights: Optional[str] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode from S2VT-att's encoder states: the keys projected at B
    rows, then the stepper at B*K rows. The outputs are read only through
    the context product's rounding, so they are tiled at the compute dtype:
    the same bits."""
    model_base.check_serving_modes(decode_weights=decode_weights)
    proj_key = bahdanau_project_keys(params["decoder"]["attention"], encoder_outs,
                                     spec.cdtype)
    tiled = _tile_beam({"h": encoder_final, "pk": proj_key,
                        "eo": encoder_outs.to(spec.cdtype)}, beam_size)
    step_fn = _s2vt_att_stepper(params, spec, tiled["pk"], tiled["eo"], decode_weights)
    return beam_search(step_fn, {"h": tiled["h"]}, encoder_outs.shape[0], beam_size,
                       spec.max_len, spec.sos_id, eos_id)


def s2vt_att_sample_from_states(params, spec: model_base.ModelSpec,
                                encoder_outs: torch.Tensor, encoder_final: torch.Tensor,
                                rng, eos_id: int, temperature: float = 1.0,
                                top_k: int = 0, top_p: float = 0.0,
                                gumbel: Optional[torch.Tensor] = None,
                                decode_weights: Optional[str] = None) -> torch.Tensor:
    """Sampling decode from S2VT-att's encoder states."""
    proj_key = bahdanau_project_keys(params["decoder"]["attention"], encoder_outs,
                                     spec.cdtype)
    step_fn = _s2vt_att_stepper(params, spec, proj_key, encoder_outs.to(spec.cdtype),
                                decode_weights)
    return sample_search(step_fn, {"h": encoder_final}, encoder_outs.shape[0],
                         spec.max_len, spec.sos_id, eos_id, rng, temperature, top_k,
                         top_p, gumbel=gumbel)


def s2vt_att_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                         beam_size: int, eos_id: int,
                         decode_weights: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode for S2VT-att: the greedy decode's cell, B*K rows."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B1 runs
    with span("encode"):
        encoder_outs, encoder_final = s2vt_att.encode(params, spec,
                                                      vid_feats.to(spec.cdtype))
    return s2vt_att_beam_from_states(params, spec, encoder_outs, encoder_final, beam_size,
                                     eos_id, decode_weights=decode_weights)


# ------------------------------------------------------------ RationaleNet

def _rationale_select(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                      gen: torch.Generator,
                      gumbel_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Hard Gumbel frame selection (eval): the selected features (B, N, V).
    The noise is ``gumbel_noise`` (B, N, 2), else drawn from ``gen`` as
    ``rationale.apply`` draws it at eval."""
    model_base.base_module(spec)  # raises for a base not ported
    with span("encode"), span("select_frames"):
        vid_feats = vid_feats.to(spec.cdtype)
        if gumbel_noise is None:
            gumbel_noise = sample_gumbel((*vid_feats.shape[:2], 2), gen, vid_feats.device)
        sel, _ = rationale.generator(params["gen"], spec, vid_feats,
                                     gumbel_noise=gumbel_noise, train=False)
    return sel


def rationale_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                          beam_size: int, eos_id: int, rng=None,
                          decode_weights: Optional[str] = None,
                          gumbel_noise: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard Gumbel frame selection, then beam search on the wrapped captioner
    over the selected features. The selection's noise is drawn from a generator
    seeded with ``rng`` (None: 0), as the greedy ``rationale.apply`` draws it
    for that seed, or is ``gumbel_noise``."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before B2 runs
    gen = s2vt.generator_for(rng, vid_feats.device)
    sel = _rationale_select(params, spec, vid_feats, gen, gumbel_noise)
    return decode_tokens(params["caption_net"], spec.with_(arch=spec.base_arch), sel,
                         eos_id, beam_size, decode_weights=decode_weights)


# ------------------------------------------------------------ SpatialNet

def spatial_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                        beam_size: int, eos_id: int,
                        decode_weights: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial-attention encode at B rows, then beam search on the wrapped
    captioner's decoder (S2VT's prime through B1 at B rows)."""
    model_base.check_serving_modes(decode_weights=decode_weights)  # before the encoder
    outs, state, _, _ = spatial.encode_for_base(params, spec, vid_feats, train=False)
    beam = s2vt_beam_from_states if spec.base_arch == "s2vt" else s2vt_att_beam_from_states
    return beam(params["caption_net"], spec, outs, state, beam_size, eos_id,
                decode_weights=decode_weights)


# ------------------------------------------------------------ Transformer

def _transformer_encode(params, spec: model_base.ModelSpec,
                        vid_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(source mask, encoder outputs) of the eval encoder, on the features
    as given (serving casts them to the compute dtype first)."""
    with span("encode"):
        src_mask = tr.create_masks_inp(vid_feats)
        return src_mask, tr.encode(params, spec, vid_feats, src_mask)


def transformer_beam_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                            beam_size: int, eos_id: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parity beam: each step re-runs the whole decoder stack on the
    padded prefix with the reference's sqrt(prefix length) scale (a KV
    cache would change the numbers). Each beam's token history rides in the
    search state, so reordering keeps the prefixes with their beams."""
    src_mask, e_outputs = _transformer_encode(params, spec, vid_feats)
    b, length = vid_feats.shape[0], spec.max_len
    tiled = _tile_beam({"eo": e_outputs, "sm": src_mask}, beam_size)
    causal = tr._causal(length, vid_feats.device)
    dec = params["decoder"]

    def step_fn(state, words, i):
        # the prefix is [sos, w0 .. w_{i-1}]: words, the last pick, goes to i
        outputs = state["outputs"].clone()
        outputs[:, i] = words
        x = tr._apply_pe(dec["pe"], embed(dec["embedding"], outputs), i + 1)
        h = torch_norm(dec["norm_out"], tr._run_decoder(params, spec, x, tiled["eo"],
                                                        tiled["sm"], causal, train=False))
        logits = mask_vocab_pad(dense(dec["pred_linear"], h[:, i], spec.cdtype),
                                spec.vocab_size)
        return {"outputs": outputs}, logits

    init_state = {"outputs": torch.zeros((b * beam_size, length), dtype=torch.int32,
                                         device=vid_feats.device)}
    return beam_search(step_fn, init_state, b, beam_size, length, spec.sos_id, eos_id)


def transformer_beam_decode_fast(params, spec: model_base.ModelSpec,
                                 vid_feats: torch.Tensor, beam_size: int, eos_id: int,
                                 lineage: bool = False, kv_cache: Optional[str] = None,
                                 decode_weights: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV-cached beam of serving, with the fast greedy decode's scale
    (each token keeps its own step's sqrt(i+1)); width 1 gives
    ``decode_greedy_fast``'s tokens up to the first eos. The cross K/V are
    projected once per video and repeated per beam.

    ``lineage=False`` (the serving default): every cache leaf is gathered
    with its beam each step. ``lineage=True``: the caches stay in place and
    only an ancestry matrix is reordered. The two take products of other
    shapes, so in bf16 their logits differ by rounding and near-ties may
    pick other tokens; the ancestry bookkeeping itself equals a physical
    reorder bit for bit."""
    model_base.check_serving_modes(kv_cache, decode_weights)  # before the encoder runs
    _, e_outputs = _transformer_encode(params, spec, vid_feats)
    b = vid_feats.shape[0]
    stepper = tr.make_cached_stepper(params, spec, e_outputs, beam_tile=beam_size,
                                     lineage=lineage, kv_cache=kv_cache,
                                     decode_weights=decode_weights)
    step_fn, init_state = stepper[:2]
    return beam_search(step_fn, init_state, b, beam_size, spec.max_len, spec.sos_id,
                       eos_id, reorder_fn=stepper[2] if lineage else None)


def transformer_sample_decode(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                              rng, eos_id: int, temperature: float = 1.0, top_k: int = 0,
                              top_p: float = 0.0, gumbel: Optional[torch.Tensor] = None,
                              kv_cache: Optional[str] = None,
                              decode_weights: Optional[str] = None) -> torch.Tensor:
    """Sampling through the KV-cached stepper (sampling is not a parity
    decode), in its ``kv_cache`` and ``decode_weights`` modes; ``top_k=1``
    gives ``decode_greedy_fast``'s tokens up to the first eos."""
    model_base.check_serving_modes(kv_cache, decode_weights)  # before the encoder runs
    _, e_outputs = _transformer_encode(params, spec, vid_feats)
    step_fn, init_state = tr.make_cached_stepper(params, spec, e_outputs, kv_cache=kv_cache,
                                                 decode_weights=decode_weights)
    return sample_search(step_fn, init_state, vid_feats.shape[0], spec.max_len,
                         spec.sos_id, eos_id, rng, temperature, top_k, top_p,
                         gumbel=gumbel)


def sample_tokens(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                  eos_id: int, rng=0, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, gumbel: Optional[torch.Tensor] = None,
                  gumbel_noise: Optional[torch.Tensor] = None,
                  kv_cache: Optional[str] = None,
                  decode_weights: Optional[str] = None) -> torch.Tensor:
    """Stochastic decoding for S2VT, S2VT-att, the Transformer, RationaleNet
    and SpatialNet -> tokens (B, L).
    ``top_k=1`` is argmax: the greedy decode up to the first eos.
    ``decode_weights="int8"`` runs every family's stepper on int8 weights;
    a quantized ``kv_cache`` is the Transformer's only (the GRU families
    have no attention cache: it raises ValueError for them).

    One generator seeded with ``rng`` draws everything, in order:
    RationaleNet's frame-selection noise (unless ``gumbel_noise`` is given),
    then each step's sampling noise (unless ``gumbel`` is given)."""
    kv_cache, decode_weights = model_base.check_serving_modes(kv_cache, decode_weights)
    if spec.arch == "transformer":
        return transformer_sample_decode(params, spec, vid_feats, rng, eos_id, temperature,
                                         top_k, top_p, gumbel=gumbel, kv_cache=kv_cache,
                                         decode_weights=decode_weights)
    check_gru_kv_cache(spec, kv_cache)
    if spec.arch == "s2vt":
        return s2vt_sample_decode(params, spec, vid_feats, rng, eos_id, temperature,
                                  top_k, top_p, gumbel=gumbel, decode_weights=decode_weights)
    if spec.arch == "s2vt-att":
        with span("encode"):
            eo, ef = s2vt_att.encode(params, spec, vid_feats.to(spec.cdtype))
        return s2vt_att_sample_from_states(params, spec, eo, ef, rng, eos_id, temperature,
                                           top_k, top_p, gumbel=gumbel,
                                           decode_weights=decode_weights)
    if spec.arch == "rationale":
        gen = s2vt.generator_for(rng, vid_feats.device)
        sel = _rationale_select(params, spec, vid_feats, gen, gumbel_noise)
        return sample_tokens(params["caption_net"], spec.with_(arch=spec.base_arch),
                             sel, eos_id, gen, temperature, top_k, top_p, gumbel=gumbel,
                             decode_weights=decode_weights)
    if spec.arch == "spatial":
        outs, state, _, _ = spatial.encode_for_base(params, spec, vid_feats, train=False)
        sample = (s2vt_sample_from_states if spec.base_arch == "s2vt"
                  else s2vt_att_sample_from_states)
        return sample(params["caption_net"], spec, outs, state, rng, eos_id, temperature,
                      top_k, top_p, gumbel=gumbel, decode_weights=decode_weights)
    _unknown(spec.arch)


def check_gru_kv_cache(spec: model_base.ModelSpec, kv_cache: Optional[str]) -> None:
    """A quantized KV cache is the Transformer's: raise ValueError for a
    family with no attention cache, as the JAX package's slot pool does."""
    if (kv_cache or "bf16") != "bf16" and spec.arch != "transformer":
        raise ValueError(f"kv_cache={kv_cache!r} quantizes the Transformer's attention "
                         f"caches; arch {spec.arch!r} has none")


def _augment_base(p, arch: str):
    """A GRU captioner's tree with its per-step decode dicts augmented by
    their int8 codes (``ops.wquant``): S2VT's two GRUs and projection,
    S2VT-att's decoder GRU and projection."""
    if arch == "s2vt":
        return dict(p, rnn1=wquant.augment_gru(p["rnn1"]), rnn2=wquant.augment_gru(p["rnn2"]),
                    linear=wquant.augment_dense(p["linear"]))
    dec = p["decoder"]
    return dict(p, decoder=dict(dec, rnn=wquant.augment_gru(dec["rnn"]),
                                pred_linear=wquant.augment_dense(dec["pred_linear"])))


def augment_decode_weights(params, spec: model_base.ModelSpec):
    """W8 decode weights, quantized once (the slot pool's form): the GRU
    families' per-step dicts augmented by their int8 codes beside the
    float32 originals, so one tree serves the encoders (B1, B2) and the
    stepper; the Transformer's decoder denses replaced
    (``transformer.quantize_decoder_params``). Idempotent."""
    if spec.arch == "transformer":
        return tr.quantize_decoder_params(params)
    if spec.arch in ("spatial", "rationale"):
        return dict(params, caption_net=_augment_base(params["caption_net"], spec.base_arch))
    return _augment_base(params, spec.arch)


def decode_tokens(params, spec: model_base.ModelSpec, vid_feats: torch.Tensor,
                  eos_id: int, beam_size: int = 1, rng=None,
                  decode_weights: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode for S2VT, S2VT-att, the Transformer (its parity beam),
    RationaleNet and SpatialNet -> (tokens (B, K, L), scores (B, K)). Beam
    width 1's best row equals the greedy rollout up to the first eos.
    ``rng`` seeds RationaleNet's frame selection. ``decode_weights="int8"``
    runs the GRU families' beam on int8 weights. The Transformer's parity
    beam has no stepper to quantize: its int8 weights raise
    NotImplementedError, as in the JAX package
    (``transformer_beam_decode_fast`` is the serving beam)."""
    if spec.arch == "s2vt":
        return s2vt_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                decode_weights=decode_weights)
    if spec.arch == "s2vt-att":
        return s2vt_att_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                    decode_weights=decode_weights)
    if spec.arch == "transformer":
        if model_base.check_serving_modes(decode_weights=decode_weights)[1] != "bf16":
            raise NotImplementedError(
                "decode_tokens runs the Transformer's reference-parity beam (the whole "
                "stack each step, no stepper); use "
                "transformer_beam_decode_fast(decode_weights=...) for int8 weights")
        return transformer_beam_decode(params, spec, vid_feats, beam_size, eos_id)
    if spec.arch == "rationale":
        return rationale_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                     rng=rng, decode_weights=decode_weights)
    if spec.arch == "spatial":
        return spatial_beam_decode(params, spec, vid_feats, beam_size, eos_id,
                                   decode_weights=decode_weights)
    _unknown(spec.arch)
