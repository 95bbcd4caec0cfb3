"""Inference over a corpus split, the serving daemon and the reference's
checkpoint format: the counterpart of ``load_inference_state``,
``decode_corpus``, ``greedy_captions``, ``serve_captions``,
``verify_parity``, ``export_reference_checkpoint``,
``export_serving_artifact`` and ``export_continuous_artifact`` in
``vcr_tpu/tools.py``. ``--mode serve`` also serves a frozen continuous
artifact of this package (``export_continuous``) with no model code.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from vcr_tpu_torch import decode, serving
from vcr_tpu_torch.config import Config, adopt_checkpoint_config
from vcr_tpu_torch.convert import export_state_dict, load_reference_checkpoint
from vcr_tpu_torch.data.pipeline import CaptionDataset
from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import transformer
from vcr_tpu_torch.train import checkpoint as ckpt
from vcr_tpu_torch.train.loop import feat_type, fold_seed, load_vocab, workload
from vcr_tpu_torch.vocab import Vocab


def load_inference_state(cfg: Config, checkpoint_path: str = "", device=None):
    """Checkpoint -> ``(cfg, params on device, spec, vocab)``. Model
    hyperparameters come from the checkpoint's embedded config; a
    train_rationale or train_spatial checkpoint gives RationaleNet's or
    SpatialNet's spec (``cfg.arch`` stays its base captioner)."""
    device = resolve_device(device)
    path = checkpoint_path or ckpt.best_path(cfg.save_path)
    params, _, meta = ckpt.load_checkpoint(path, device)
    cfg = adopt_checkpoint_config(cfg, meta)
    vocab = load_vocab(cfg)
    spec = model_base.spec_from_config(cfg, vocab)
    spec = spec.with_(arch=workload(cfg.mode)[0](cfg))
    return cfg, params, spec, vocab


def decode_features(params, spec, eos_id: int, feats: np.ndarray, chunk: int,
                    beam_size: int = 1, sample_temperature: float = 0.0,
                    sample_top_k: int = 0, sample_top_p: float = 0.0, seed: int = 0,
                    device=None) -> np.ndarray:
    """feats (N_vids, num_frames, ...) -> tokens (N_vids, L) int32: greedy, the
    best beam, or sampled (chunk i seeded with ``fold_seed(seed, i)``), in
    chunks of ``chunk`` videos, the last one zero-padded (rows are
    independent at eval, so padding changes no real row). Each chunk goes
    through ``serving.make_caption_fn``, except the Transformer's
    (:func:`_transformer_tokens`)."""
    device = resolve_device(device)
    decode.check_decode_mode(beam_size, sample_temperature, sample_top_k, sample_top_p)

    def run(v, i):
        # only sampling re-seeds per chunk; greedy and beam draw RationaleNet's
        # frame selection from seed 0, as the JAX package's rng=None does
        rng = fold_seed(seed, i) if sample_temperature > 0 else 0
        if spec.arch == "transformer":
            return _transformer_tokens(params, spec, eos_id, v, beam_size,
                                       sample_temperature, sample_top_k, sample_top_p, rng)
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


def _transformer_tokens(params, spec, eos_id: int, feats: torch.Tensor, beam_size: int,
                        sample_temperature: float, sample_top_k: int, sample_top_p: float,
                        rng: int) -> torch.Tensor:
    """The Transformer's decodes of the command line, on the features as
    stored, as the JAX package's ``decode_corpus`` and ``verify_parity``
    run them: the parity greedy decode, the parity beam, or sampling through
    the KV-cached stepper. Serving's greedy and beam are the KV-cached ones,
    whose tokens differ."""
    if sample_temperature > 0:
        return decode.sample_tokens(params, spec, feats, eos_id, rng, sample_temperature,
                                    sample_top_k, sample_top_p)
    if beam_size > 1:
        return decode.decode_tokens(params, spec, feats, eos_id, beam_size)[0][:, 0]
    return transformer.apply(params, spec, feats, emit="tokens")


def greedy_captions(params, spec, vocab: Vocab, feats: np.ndarray, batch_size: int = 32,
                    device=None) -> List[Dict]:
    """feats (N_vids, num_frames, ...) -> list of {tokens, caption}, greedy."""
    tokens = decode_features(params, spec, vocab.eos_id, feats, batch_size, device=device)
    return [{"tokens": row.tolist(), "caption": vocab.get_sent_from_index(row)}
            for row in tokens]


def load_split_features(cfg: Config, vocab: Vocab, split: str = "val",
                        feat_type: str = "cnn"):
    """-> (features (N_vids, num_frames, ...) float32, video keys) of a split:
    CNN features, or YOLO grid features with ``feat_type="yolo"``."""
    ds = CaptionDataset(cfg.data_dir, cfg.corpus, split, vocab, cfg.num_frames,
                        cfg.max_len, feat_type)
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
    feats, keys = load_split_features(cfg, vocab, split, feat_type(spec.arch))
    chunk = min(max(1, cfg.bsize), max(len(feats), 1))
    tokens = decode_features(params, spec, vocab.eos_id, feats, chunk, beam_size,
                             cfg.sample_temperature, cfg.sample_top_k,
                             cfg.sample_top_p, cfg.seed, device)
    results = [{"vid_key": k, "tokens": t.tolist(),
                "caption": vocab.get_sent_from_index(t)}
               for k, t in zip(keys, tokens)]
    _write_json(results, out_file)
    return results


def _write_json(results, out_file: Optional[str]) -> None:
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(results, f, indent=2)


def _build_serving_pool(cfg: Config, checkpoint_path: str = "", device=None):
    """(cfg, path) -> (continuous pool, vocab, arch). ``checkpoint_path`` is
    a checkpoint or a save_path directory holding ``model_best`` (as
    ``--serve_models`` entries give it); empty: ``cfg.save_path``'s best.
    Shared by the single- and multi-model daemons."""
    meta_path = os.path.join(checkpoint_path or "", "meta.json")
    if checkpoint_path and os.path.isfile(meta_path):
        with open(meta_path) as f:
            if json.load(f).get("kind") == "continuous":
                # a frozen pool (--mode export_continuous): served as it is,
                # with no model code; a JAX-made one raises ValueError
                from vcr_tpu_torch.export_continuous import load_continuous

                cc = load_continuous(checkpoint_path, device)
                return cc, cc.vocab, cc.meta["spec"]["arch"]
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    if checkpoint_path and os.path.isdir(os.path.join(checkpoint_path, "model_best")):
        cfg = cfg.replace(save_path=checkpoint_path)
        checkpoint_path = ""
    if cfg.mesh_dp > 1:
        raise NotImplementedError("--mesh_dp > 1: a mesh-sharded slot pool is not "
                                  "ported yet: ROADMAP A15b (multi-device serving)")
    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    cc = ContinuousCaptioner(params, spec, slots=cfg.serve_slots,
                             admit_chunk=cfg.serve_admit_chunk, vocab=vocab,
                             beam_size=max(cfg.beam_size, 1),
                             sample_temperature=cfg.sample_temperature,
                             sample_top_k=cfg.sample_top_k,
                             sample_top_p=cfg.sample_top_p,
                             # opt-in: it swaps argmax for the sorting
                             # filters on every token
                             request_sampling=cfg.serve_request_sampling,
                             kv_cache=cfg.serve_kv_cache,
                             decode_weights=cfg.serve_decode_weights,
                             rng=cfg.seed, device=device)
    return cc, vocab, spec.arch


def serve_captions(cfg: Config, checkpoint_path: str = "", block: bool = True,
                   device=None):
    """``--mode serve``: load a checkpoint and run the HTTP caption daemon
    (:mod:`vcr_tpu_torch.server`) over a continuous-batching slot pool
    (:mod:`vcr_tpu_torch.serving_continuous`) on ``device`` (the card by
    default). ``--serve_port/--serve_slots/--serve_admit_chunk`` size it;
    ``--serve_models name1=path1,name2=path2`` serves several checkpoints
    from one port (:mod:`vcr_tpu_torch.multiserver`: POST
    /caption/<name>, GET /models). Serves until SIGINT or SIGTERM; returns
    the started server when ``block=False``."""
    from vcr_tpu_torch.server import CaptionServer

    max_pending = None if cfg.serve_max_pending < 0 else cfg.serve_max_pending
    bounds = dict(request_timeout_s=cfg.serve_timeout_s, max_pending=max_pending,
                  profile_dir=cfg.serve_profile_dir or None,
                  auth_token=cfg.serve_auth_token or None,
                  max_body_mb=cfg.serve_max_body_mb)
    if cfg.serve_models:
        from vcr_tpu_torch.multiserver import MultiCaptionServer

        backends = {}
        for entry in cfg.serve_models.split(","):
            name, _, path = entry.partition("=")
            name, path = name.strip(), path.strip()
            if not name or not path:
                raise ValueError(f"--serve_models entry {entry!r} is not name=path")
            if name in backends:
                # an overwrite would route one name's traffic to the other
                # checkpoint and strand the first pool's memory
                raise ValueError(f"duplicate model name {name!r} in --serve_models")
            cc, vocab, _ = _build_serving_pool(cfg, path, device)
            backends[name] = (cc, vocab)
        server = MultiCaptionServer(backends, port=cfg.serve_port, **bounds).start()
        print(f"serving {len(backends)} models ({', '.join(sorted(backends))}) on "
              f"http://127.0.0.1:{server.port}: POST /caption/<model>, GET /models, "
              "GET /healthz; Ctrl-C to stop", flush=True)
    else:
        cc, vocab, arch = _build_serving_pool(cfg, checkpoint_path, device)
        server = CaptionServer(cc, vocab=vocab, port=cfg.serve_port, **bounds).start()
        print(f"serving {arch} captions on http://127.0.0.1:{server.port} "
              f"(R={cc.slots}, A={cc.admit_chunk}): POST /caption, GET /healthz; "
              "Ctrl-C to stop", flush=True)
    if not block:
        return server
    import signal
    import threading

    # SIGTERM drains like Ctrl-C: close() stops accepting, lets the
    # scheduler finish in-flight decodes and releases waiting clients
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(1.0):
            pass
        print("SIGTERM: shutting down")
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.close()


def export_serving_artifact(cfg: Config, checkpoint_path: str = "",
                            out_dir: Optional[str] = None, device=None) -> str:
    """``--mode export_serving``: a checkpoint as a deployable serving
    artifact (:mod:`vcr_tpu_torch.export_serving`) under
    ``<save_path>/serving_artifact``, traced on ``device`` (the card by
    default), which runs on the card or the CPU. The decode follows the
    checkpoint-adopted flags (--beam_size, --sample_temperature,
    --sample_top_k, --sample_top_p, --serve_kv_cache,
    --serve_decode_weights); its draws are seeded with --seed. --mesh_dp > 1
    (the JAX package's multi-chip artifact) raises naming A15b."""
    from vcr_tpu_torch import export_serving

    if cfg.mesh_dp > 1:
        raise NotImplementedError("--mesh_dp > 1: a multi-device artifact is not "
                                  "ported yet: ROADMAP A15b (multi-device serving)")
    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    out = out_dir or os.path.join(cfg.save_path, "serving_artifact")
    return export_serving.export_captioner(
        params, spec, out, featurizer="none", beam_size=cfg.beam_size, vocab=vocab,
        rng=cfg.seed, sample_temperature=cfg.sample_temperature,
        sample_top_k=cfg.sample_top_k, sample_top_p=cfg.sample_top_p,
        kv_cache=cfg.serve_kv_cache, decode_weights=cfg.serve_decode_weights,
        device=device)


def export_continuous_artifact(cfg: Config, checkpoint_path: str = "",
                               out_dir: Optional[str] = None, device=None) -> str:
    """``--mode export_continuous``: freeze a continuous-batching slot pool
    (encode, admit and step programs, weights, the empty pool;
    :mod:`vcr_tpu_torch.export_continuous`) under
    ``<save_path>/continuous_artifact``, traced on ``device`` (the card by
    default). The pool's geometry comes from --serve_slots and
    --serve_admit_chunk. Serve it with ``--mode serve --pretrained_base
    <dir>``, which runs no model code. Sampling pools are live-only and
    raise, as in the JAX package; --mesh_dp > 1 raises naming A15b."""
    from vcr_tpu_torch.export_continuous import export_continuous

    # sample_temperature is a command-line override: its value here is the
    # one the checkpoint's config would give, so refuse before loading it
    if cfg.sample_temperature > 0:
        raise NotImplementedError(
            "per-slot sampling is live-pool only (--mode serve); the frozen "
            "continuous artifact bakes greedy or beam argmax into its step program: "
            "export without --sample_temperature")
    if cfg.mesh_dp > 1:
        raise NotImplementedError("--mesh_dp > 1: a mesh-sharded slot pool is not "
                                  "ported yet: ROADMAP A15b (multi-device serving)")
    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    out = out_dir or os.path.join(cfg.save_path, "continuous_artifact")
    return export_continuous(params, spec, out, slots=cfg.serve_slots,
                             admit_chunk=cfg.serve_admit_chunk,
                             beam_size=max(cfg.beam_size, 1), vocab=vocab, seed=cfg.seed,
                             kv_cache=cfg.serve_kv_cache,
                             decode_weights=cfg.serve_decode_weights, device=device)


def verify_parity(cfg: Config, checkpoint_path: str, out_file: Optional[str] = None,
                  device=None) -> List[Dict]:
    """Caption every video of the val split greedily with a converted
    reference checkpoint (a ``.net`` file, :func:`convert.load_reference_checkpoint`)
    and write ``[{vid_key, tokens, caption}]`` to ``out_file`` when given.
    A wrapped family and its captioner are taken from the state_dict's keys;
    ``cfg.arch`` names the base captioner, as the reference's ``--arch``."""
    device = resolve_device(device)
    vocab = load_vocab(cfg)
    spec = model_base.spec_from_config(cfg, vocab)
    params, meta = load_reference_checkpoint(checkpoint_path, spec, cfg.arch)
    if meta["detected_arch"] in ("rationale", "spatial"):
        spec = spec.with_(arch=meta["detected_arch"])
    if meta["detected_base_arch"] is not None:
        spec = spec.with_(base_arch=meta["detected_base_arch"])
    feats, keys = load_split_features(cfg, vocab, feat_type=feat_type(spec.arch))
    captions = greedy_captions(params_to(params, device), spec, vocab, feats, cfg.bsize,
                               device)
    results = [{"vid_key": k, **c} for k, c in zip(keys, captions)]
    _write_json(results, out_file)
    return results


def export_reference_checkpoint(cfg: Config, checkpoint_path: str = "",
                                out_file: Optional[str] = None) -> str:
    """Write a checkpoint of this package as a reference ``.net`` file
    (``torch.save`` of {'state_dict', 'opts', 'epoch', 'n_iter',
    'val_meteor_score', 'best_val_meteor_score'}), which the PyTorch
    reference and :func:`verify_parity` load. The optimizer state is left
    out, as the reference never restores it. BatchNorm's
    ``num_batches_tracked`` counters hold the checkpoint's ``n_iter``: torch
    adds one per train forward, which is one per optimizer step. A conversion
    on the host: no device is used. -> the file's path (default
    ``save_path/model_export.net``)."""
    path = checkpoint_path or ckpt.best_path(cfg.save_path)
    params, _, meta = ckpt.load_checkpoint(path, "cpu")
    cfg = adopt_checkpoint_config(cfg, meta)
    spec = model_base.spec_from_config(cfg, load_vocab(cfg))
    sd = export_state_dict(params, spec, workload(cfg.mode)[0](cfg))
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(meta.get("n_iter", 0), dtype=torch.int64)
    out = out_file or os.path.join(cfg.save_path, "model_export.net")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({
        "epoch": meta.get("epoch", 0),
        "state_dict": sd,
        "n_iter": meta.get("n_iter", 0),
        # the reference reads checkpoint['opts'] as an argparse.Namespace
        "opts": argparse.Namespace(**meta.get("config", {})),
        "val_meteor_score": meta.get("val_meteor_score", 0.0),
        "best_val_meteor_score": meta.get("best_val_meteor_score", 0.0),
    }, out)
    return out
