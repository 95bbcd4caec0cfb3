"""Inference over a corpus split: the counterpart of ``load_inference_state``,
``decode_corpus`` and ``greedy_captions`` in ``vcr_tpu/tools.py``.

The JAX package's other tools are not ported yet: ``verify_parity`` and
``export_reference`` need the reference-checkpoint converter (ROADMAP A8),
``serve`` the continuous-batching daemon (A14), and the two ``export_*``
artifacts A16; their modes raise in :mod:`vcr_tpu_torch.cli`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vcr_tpu_torch import decode, serving
from vcr_tpu_torch.config import Config, adopt_checkpoint_config
from vcr_tpu_torch.data.pipeline import CaptionDataset
from vcr_tpu_torch.device import resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.train import checkpoint as ckpt
from vcr_tpu_torch.train.loop import fold_seed, load_vocab
from vcr_tpu_torch.vocab import Vocab


def load_inference_state(cfg: Config, checkpoint_path: str = "", device=None):
    """Checkpoint -> ``(cfg, params on device, spec, vocab)``. Model
    hyperparameters come from the checkpoint's embedded config; a
    train_rationale checkpoint gives RationaleNet's spec (``cfg.arch`` stays
    its base captioner)."""
    device = resolve_device(device)
    path = checkpoint_path or ckpt.best_path(cfg.save_path)
    params, _, meta = ckpt.load_checkpoint(path, device)
    cfg = adopt_checkpoint_config(cfg, meta)
    vocab = load_vocab(cfg)
    spec = model_base.spec_from_config(cfg, vocab)
    if cfg.mode == "train_rationale":
        spec = spec.with_(arch="rationale")
    return cfg, params, spec, vocab


def decode_features(params, spec, eos_id: int, feats: np.ndarray, chunk: int,
                    beam_size: int = 1, sample_temperature: float = 0.0,
                    sample_top_k: int = 0, sample_top_p: float = 0.0, seed: int = 0,
                    device=None) -> np.ndarray:
    """feats (N_vids, num_frames, V) -> tokens (N_vids, L) int32: greedy, the
    best beam, or sampled (chunk i seeded with ``fold_seed(seed, i)``), in
    chunks of ``chunk`` videos, the last one zero-padded (rows are
    independent at eval, so padding changes no real row). Each chunk goes
    through ``serving.make_caption_fn``."""
    device = resolve_device(device)
    decode.check_decode_mode(beam_size, sample_temperature, sample_top_k, sample_top_p)

    def run(v, i):
        # only sampling re-seeds per chunk; greedy and beam draw RationaleNet's
        # frame selection from seed 0, as the JAX package's rng=None does
        rng = fold_seed(seed, i) if sample_temperature > 0 else 0
        caption = serving.make_caption_fn(spec, beam_size=beam_size, eos_id=eos_id,
                                          sample_temperature=sample_temperature,
                                          sample_top_k=sample_top_k,
                                          sample_top_p=sample_top_p, rng=rng)
        return caption(params, v)

    parts = []
    with torch.inference_mode():
        for ci, start in enumerate(range(0, len(feats), chunk)):
            part = feats[start:start + chunk]
            n = len(part)
            if n < chunk:
                part = np.concatenate(
                    [part, np.zeros((chunk - n, *part.shape[1:]), part.dtype)])
            parts.append(run(torch.as_tensor(part, device=device), ci).cpu().numpy()[:n])
    return np.concatenate(parts) if parts else np.zeros((0, spec.max_len), np.int32)


def greedy_captions(params, spec, vocab: Vocab, feats: np.ndarray, batch_size: int = 32,
                    device=None) -> List[Dict]:
    """feats (N_vids, num_frames, V) -> list of {tokens, caption}, greedy."""
    tokens = decode_features(params, spec, vocab.eos_id, feats, batch_size, device=device)
    return [{"tokens": row.tolist(), "caption": vocab.get_sent_from_index(row)}
            for row in tokens]


def load_split_features(cfg: Config, vocab: Vocab, split: str = "val"):
    """-> (features (N_vids, num_frames, V) float32, video keys) of a split."""
    ds = CaptionDataset(cfg.data_dir, cfg.corpus, split, vocab, cfg.num_frames,
                        cfg.max_len)
    feats = np.stack([ds.load_features(i) for i in range(len(ds))])
    return feats, [ds.captions[i][ds.key_field] for i in range(len(ds))]


def decode_corpus(cfg: Config, checkpoint_path: str = "",
                  out_file: Optional[str] = None, split: str = "val",
                  beam_size: int = 1, device=None) -> List[Dict]:
    """Caption every video of a split with a checkpoint (greedy, beam, or
    sampling with ``cfg.sample_temperature`` > 0), in chunks of ``--bsize``;
    write ``[{vid_key, tokens, caption}]`` to ``out_file`` when given."""
    device = resolve_device(device)
    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    feats, keys = load_split_features(cfg, vocab, split)
    chunk = min(max(1, cfg.bsize), max(len(feats), 1))
    tokens = decode_features(params, spec, vocab.eos_id, feats, chunk, beam_size,
                             cfg.sample_temperature, cfg.sample_top_k,
                             cfg.sample_top_p, cfg.seed, device)
    results = [{"vid_key": k, "tokens": t.tolist(),
                "caption": vocab.get_sent_from_index(t)}
               for k, t in zip(keys, tokens)]
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(results, f, indent=2)
    return results
