"""Continuous-batching serving as a deployable artifact.

The counterpart of ``vcr_tpu/export_continuous.py``. ``export_serving``
freezes the whole-batch serving graph; this module freezes the slot pool of
``serving_continuous`` the same way: its three device functions, admission
encode, slot copy and decode tick, are exported by ``torch.export``, next to
the weights, the empty pool and metadata. A serving host runs the pool with
torch, numpy, the op library and the host scheduler
(``scheduler.run_slot_scheduler``), and no model code: the state is an
opaque list of tensors threaded between the programs, and the host reads
only the three bookkeeping leaves the metadata names (active, steps, toks).

Artifact layout:
    encode_fn.pt2   encode(weight_leaves, feats (A, ...), noise) -> the
                    leaves of A rows of slot state
    admit_fn.pt2    admit(state_leaves, new_leaves, ids (A,), valid (A,))
                    -> state leaves
    step_fn.pt2     step(weight_leaves, state_leaves) -> state leaves
                    (step_chunk greedy or beam tokens for every slot)
    weights.npz     the pool's tick tree, ordinal keys (w00000, ...)
    state0.npz      the empty slot pool (s00000, ...)
    meta.json       pool geometry, bookkeeping leaf indices, dtypes, ids

The programs are the live pool's own ``encode``, ``admit`` and ``step``, so
a live pool and its artifact decode identically, chunk for chunk. Every
state leaf has the sink slot R beside the R slots, where admission writes
the invalid rows of a chunk. The admit program writes the rows in place
(the loader's program copies them into the state tensors it was given);
the step program returns a new state, as the live tick does, and returns
the leaves a tick does not change (the encoder's keys and outputs, the
cross-attention caches) as they were, without a copy.

RationaleNet's per-admission frame-selection noise cannot be drawn inside
a program: ``ContinuousArtifact`` draws it on its device, from a generator
seeded as the live pool seeds it (``scheduler.stream_seed(seed, "select",
admission index)``), and passes it to the encode program. Sampling pools
stay live-only.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vcr_tpu_torch.export_serving import (FORMAT_VERSION, RUNTIME, _holds_float32_conv,
                                          _kernel_sources, _load_leaves, _save_leaves,
                                          check_kernel_sources, default_input_shape,
                                          draw_noise, dtype_name, fill_tree,
                                          flatten_tree, load_program, path_name,
                                          read_meta, save_program, tf32_scope,
                                          tree_skeleton)
from vcr_tpu_torch.scheduler import run_slot_scheduler, stream_seed

ENCODE_FILE = "encode_fn.pt2"
ADMIT_FILE = "admit_fn.pt2"
STEP_FILE = "step_fn.pt2"
WEIGHTS_FILE = "weights.npz"
STATE_FILE = "state0.npz"
META_FILE = "meta.json"

_BOOKKEEPING = ("active", "steps", "toks")


class _Encode(torch.nn.Module):
    def __init__(self, cc, p_skel):
        super().__init__()
        self._cc, self._p_skel = cc, p_skel

    def forward(self, weight_leaves, feats, noise):
        params = fill_tree(self._p_skel, weight_leaves)
        return flatten_tree(self._cc.encode(params, feats, *noise))[0]


class _Admit(torch.nn.Module):
    def __init__(self, cc, s_skel, n_skel):
        super().__init__()
        self._cc, self._s_skel, self._n_skel = cc, s_skel, n_skel

    def forward(self, state_leaves, new_leaves, ids, valid):
        state = fill_tree(self._s_skel, state_leaves)
        new = fill_tree(self._n_skel, new_leaves)
        return flatten_tree(self._cc.admit(state, new, ids, valid))[0]


class _Step(torch.nn.Module):
    def __init__(self, cc, p_skel, s_skel):
        super().__init__()
        self._cc, self._p_skel, self._s_skel = cc, p_skel, s_skel

    def forward(self, weight_leaves, state_leaves):
        params = fill_tree(self._p_skel, weight_leaves)
        state = fill_tree(self._s_skel, state_leaves)
        return flatten_tree(self._cc.step(params, state))[0]


def export_continuous(params, spec, out_dir: str, *,
                      slots: int = 64, admit_chunk: int = 8,
                      step_chunk: int = 4, beam_size: int = 1,
                      eos_id: Optional[int] = None, vocab=None,
                      seed: int = 0,
                      feat_item_shape: Optional[Sequence[int]] = None,
                      kv_cache: Optional[str] = None,
                      decode_weights: Optional[str] = None,
                      device=None) -> str:
    """Freeze a continuous-batching slot pool for (params, spec) into
    ``out_dir``, traced on ``device`` (the card unless given). The pool's
    geometry (slots, admit_chunk, step_chunk) is fixed in the programs.
    ``feat_item_shape`` overrides the per-video feature shape (SpatialNet
    grids that do not match ``spec.grid_size``). Returns ``out_dir``."""
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    cc = ContinuousCaptioner(params, spec, slots=slots, admit_chunk=admit_chunk,
                             step_chunk=step_chunk, beam_size=beam_size, eos_id=eos_id,
                             vocab=vocab, rng=seed, kv_cache=kv_cache,
                             decode_weights=decode_weights, device=device)
    dev = cc.device
    item_shape = (tuple(int(d) for d in feat_item_shape) if feat_item_shape is not None
                  else default_input_shape(spec))
    p_leaves = flatten_tree(cc._step_params)[0]
    with torch.no_grad():
        state0 = cc._init_state()
        s_leaves, s_paths = flatten_tree(state0)
    book = {name: s_paths.index((name,)) for name in _BOOKKEEPING}
    feats = torch.zeros((admit_chunk, *item_shape), dtype=torch.float32, device=dev)
    noise = ([torch.zeros((admit_chunk, spec.num_frames, 2), device=dev)]
             if spec.arch == "rationale" else [])
    ids = torch.arange(admit_chunk, dtype=torch.long, device=dev)
    valid = torch.ones((admit_chunk,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        new = cc.encode(cc._step_params, feats, *noise)
        n_leaves = flatten_tree(new)[0]
        p_skel, s_skel = tree_skeleton(cc._step_params), tree_skeleton(state0)
        encode = torch.export.export(_Encode(cc, p_skel), (p_leaves, feats, noise))
        admit = torch.export.export(_Admit(cc, s_skel, tree_skeleton(new)),
                                    ([x.clone() for x in s_leaves], n_leaves, ids, valid))
        step = torch.export.export(_Step(cc, p_skel, s_skel), (p_leaves, s_leaves))
    programs = (encode, admit, step)

    os.makedirs(out_dir, exist_ok=True)
    for fname, program in zip((ENCODE_FILE, ADMIT_FILE, STEP_FILE), programs):
        save_program(program, os.path.join(out_dir, fname))
    _save_leaves(os.path.join(out_dir, WEIGHTS_FILE), p_leaves)
    _save_leaves(os.path.join(out_dir, STATE_FILE), s_leaves, prefix="s")
    meta = {
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "kind": "continuous",
        "spec": dataclasses.asdict(spec),
        "feat_item_shape": list(item_shape),
        "slots": int(slots),
        "admit_chunk": int(admit_chunk),
        "step_chunk": int(cc.step_chunk),
        "beam_size": int(beam_size),
        "eos_id": int(cc.eos_id),
        "sos_id": int(spec.sos_id),
        "max_len": int(spec.max_len),
        "seed": int(seed),
        "kv_cache": cc.kv_cache,
        "decode_weights": cc.decode_weights,
        "bookkeeping_leaf_indices": book,
        "select_noise": ([admit_chunk, spec.num_frames, 2]
                         if spec.arch == "rationale" else None),
        "weight_leaf_dtypes": [dtype_name(t.dtype) for t in p_leaves],
        "state_leaf_dtypes": [dtype_name(t.dtype) for t in s_leaves],
        "state_leaf_paths": [path_name(p) for p in s_paths],
        "float32_conv": _holds_float32_conv(programs),
        "kernel_sources": _kernel_sources(programs),
        "exported_on": dev.type,
        "platforms": ["cpu", "cuda"],
        "torch_version": torch.__version__,
    }
    if vocab is not None:
        # the detokenizer, id -> word, so the serving host can emit caption
        # strings with no vocab or GloVe files
        meta["id_to_word"] = [vocab.get_word(i) for i in range(vocab.vocab_size)]
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


class _MetaVocab:
    """The detokenizer rebuilt from meta['id_to_word']: ``Vocab``'s
    ``get_sent_from_index`` (stop at <eos>) with no vocab files."""

    def __init__(self, words):
        self._words = words

    def get_sent_from_index(self, indexes) -> str:
        out = []
        for i in indexes:
            w = self._words[int(i)]
            if w == "<eos>":
                break
            out.append(w)
        return " ".join(out)


class ContinuousArtifact:
    """A loaded continuous-serving artifact: the scheduler-ops protocol of
    ``ContinuousCaptioner`` (``run_slot_scheduler`` drives it, a
    ``CaptionServer`` can front it), with every device function an exported
    program on ``device``. No model code runs on the serving host."""

    def __init__(self, artifact_dir: str, device=None):
        from vcr_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.meta = read_meta(artifact_dir, "continuous")
        check_kernel_sources(self.meta)

        def path(name):
            return os.path.join(artifact_dir, name)
        self._encode = load_program(path(ENCODE_FILE), self.device)
        self._admit = load_program(path(ADMIT_FILE), self.device)
        self._step = load_program(path(STEP_FILE), self.device)
        self._weights = _load_leaves(path(WEIGHTS_FILE), self.meta["weight_leaf_dtypes"],
                                     self.device)
        self._state = _load_leaves(path(STATE_FILE), self.meta["state_leaf_dtypes"],
                                   self.device)
        self._book = self.meta["bookkeeping_leaf_indices"]
        self._tf32 = tf32_scope(self.meta, self.device)
        self.slots = self.meta["slots"]
        self.admit_chunk = self.meta["admit_chunk"]
        self.step_chunk = self.meta["step_chunk"]
        self.beam_size = self.meta["beam_size"]
        self.eos_id = self.meta["eos_id"]
        self.stats = {"ticks": 0, "admit_chunks": 0, "served": 0,
                      "useful_steps": 0, "slot_steps": 0, "cancelled": 0}
        self.in_flight = 0
        self._admit_count = 0
        self.vocab = (_MetaVocab(self.meta["id_to_word"])
                      if "id_to_word" in self.meta else None)

    # ----------------------------------------------- scheduler ops protocol

    def check_feat_shape(self, shape) -> Optional[str]:
        """None if a request of this feature shape is admissible, else the
        reason: the encode program's item shape is fixed at export."""
        want = self.meta["feat_item_shape"]
        if list(shape) == list(want):
            return None
        return f"expected {tuple(want)} features, got {tuple(shape)}"

    def select_noise(self, admit: int) -> list:
        """RationaleNet's frame-selection noise of admission ``admit``, as
        the live pool draws it; empty for the other families."""
        shape = self.meta["select_noise"]
        if shape is None:
            return []
        return draw_noise([{"shape": shape}], stream_seed(self.meta["seed"], "select", admit),
                          shape[0], self.device)

    def encode_admit(self, feats, ids, valid) -> None:
        self._admit_count += 1
        dev = self.device
        with torch.no_grad(), self._tf32():
            new = self._encode(self._weights,
                               torch.as_tensor(feats, dtype=torch.float32, device=dev),
                               self.select_noise(self._admit_count))
            self._state = list(self._admit(
                self._state, list(new), torch.as_tensor(ids, dtype=torch.long, device=dev),
                torch.as_tensor(valid, dtype=torch.bool, device=dev)))

    def tick(self) -> None:
        with torch.no_grad():
            self._state = list(self._step(self._weights, self._state))

    def poll_active(self) -> np.ndarray:
        return self._state[self._book["active"]][:self.slots].cpu().numpy()

    def read_tokens(self):
        return (self._state[self._book["toks"]][:self.slots].cpu().numpy(),
                self._state[self._book["steps"]][:self.slots].cpu().numpy())

    # --------------------------------------------------------------- driving

    def caption_stream(self, requests, poll_cancelled=None):
        # no release program in the artifact: in-flight cancels are skipped
        # by the scheduler; queued cancels still drop before admission
        return run_slot_scheduler(self, requests, poll_cancelled=poll_cancelled)

    def caption_all(self, feats_by_key: Dict) -> Dict:
        return dict(self.caption_stream(feats_by_key.items()))


def load_continuous(artifact_dir: str, device=None) -> ContinuousArtifact:
    """Load a continuous-serving artifact onto ``device`` (the card unless
    given; none raises)."""
    return ContinuousArtifact(artifact_dir, device)
