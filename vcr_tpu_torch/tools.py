"""Inference over a corpus split, the serving daemon and the reference's
checkpoint format: the counterpart of ``load_inference_state``,
``decode_corpus``, ``greedy_captions``, ``serve_captions``,
``verify_parity``, ``export_reference_checkpoint``,
``export_serving_artifact`` and ``export_continuous_artifact`` in
``vcr_tpu/tools.py``. ``--mode serve`` also serves a frozen continuous
artifact of this package (``export_continuous``) with no model code.

Under ``--mesh_dp`` (x ``--mesh_mp``) these run over the processes of an
initialised ``torch.distributed`` group (``python -m
vcr_tpu_torch.parallel.launch``): ``--mode decode`` splits each chunk's
rows over dp, ``--mode serve`` shards its slot pools over dp (rank 0
serves HTTP, the other ranks follow it), and ``--mode export_serving``
writes a dp artifact (one process). A group of several processes without a
mesh raises.
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
                    device=None, mesh=None) -> np.ndarray:
    """feats (N_vids, num_frames, ...) -> tokens (N_vids, L) int32: greedy, the
    best beam, or sampled (chunk i seeded with ``fold_seed(seed, i)``), in
    chunks of ``chunk`` videos, the last one zero-padded (rows are
    independent at eval, so padding changes no real row). Each chunk goes
    through ``serving.make_caption_fn``, except the Transformer's
    (:func:`_transformer_tokens`).

    ``mesh`` (a ``parallel.mesh.Mesh``; ``chunk`` a multiple of its dp): dp
    index d decodes rows [d * chunk/dp, (d+1) * chunk/dp) of each chunk with
    the draws of the whole chunk sliced to its rows, and the rows are
    gathered over dp: every rank returns the one-process tokens."""
    device = resolve_device(device)
    decode.check_decode_mode(beam_size, sample_temperature, sample_top_k, sample_top_p)
    dp = 1 if mesh is None else mesh.dp
    if chunk % dp:
        raise ValueError(f"chunk {chunk} not divisible by dp={dp}")
    plan = serving.draw_plan(spec, beam_size, sample_temperature)

    def run(v, i):
        # only sampling re-seeds per chunk; greedy and beam draw RationaleNet's
        # frame selection from seed 0, as the JAX package's rng=None does
        rng = fold_seed(seed, i) if sample_temperature > 0 else 0
        noise = None
        if mesh is not None:
            from vcr_tpu_torch.export_serving import draw_noise, noise_rows

            rows = chunk // dp
            start = mesh.dp_index * rows
            noise = dict(zip([e["input"] for e in plan], noise_rows(
                plan, draw_noise(plan, rng, chunk, device), start, start + rows)))
            v = v[start:start + rows]
        if spec.arch == "transformer":
            return _transformer_tokens(params, spec, eos_id, v, beam_size,
                                       sample_temperature, sample_top_k, sample_top_p, rng,
                                       (noise or {}).get("steps"))
        caption = serving.make_caption_fn(spec, beam_size=beam_size, eos_id=eos_id,
                                          sample_temperature=sample_temperature,
                                          sample_top_k=sample_top_k,
                                          sample_top_p=sample_top_p, rng=rng)
        return caption(params, v, noise)

    parts = []
    with torch.inference_mode():
        for ci, start in enumerate(range(0, len(feats), chunk)):
            part = feats[start:start + chunk]
            n = len(part)
            if n < chunk:
                part = np.concatenate(
                    [part, np.zeros((chunk - n, *part.shape[1:]), part.dtype)])
            tokens = run(torch.as_tensor(part, device=device), ci).cpu().numpy()
            if mesh is not None:
                from vcr_tpu_torch.parallel.mesh import gather_global_rows

                tokens = gather_global_rows(tokens, mesh)
            parts.append(tokens[:n])
    return np.concatenate(parts) if parts else np.zeros((0, spec.max_len), np.int32)


def _transformer_tokens(params, spec, eos_id: int, feats: torch.Tensor, beam_size: int,
                        sample_temperature: float, sample_top_k: int, sample_top_p: float,
                        rng: int, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Transformer's decodes of the command line, on the features as
    stored, as the JAX package's ``decode_corpus`` and ``verify_parity``
    run them: the parity greedy decode, the parity beam, or sampling through
    the KV-cached stepper (its draws ``gumbel`` where given). Serving's
    greedy and beam are the KV-cached ones, whose tokens differ."""
    if sample_temperature > 0:
        return decode.sample_tokens(params, spec, feats, eos_id, rng, sample_temperature,
                                    sample_top_k, sample_top_p, gumbel=gumbel)
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


def _mesh_of(cfg: Config, dp: int, mp: int, device):
    """The (dp, mp) layout of this process's group (None for one process).
    A group of several processes without a mesh raises, as training does."""
    import torch.distributed as dist

    from vcr_tpu_torch.parallel.mesh import make_mesh

    if dp * mp > 1:
        return make_mesh(dp, mp, device)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1:
        raise RuntimeError(
            f"a launch of {world} processes needs a mesh spanning them: set --mesh_dp "
            f"(x --mesh_mp) to {world}, or each process would run --mode {cfg.mode} "
            "alone")
    return None


def decode_corpus(cfg: Config, checkpoint_path: str = "",
                  out_file: Optional[str] = None, split: str = "val",
                  beam_size: int = 1, device=None) -> List[Dict]:
    """Caption every video of a split with a checkpoint (greedy, beam, or
    sampling with ``cfg.sample_temperature`` > 0), in chunks of ``--bsize``;
    write ``[{vid_key, tokens, caption}]`` to ``out_file`` when given.

    Under ``--mesh_dp`` x ``--mesh_mp`` the chunk is rounded up to a
    multiple of dp and each dp index decodes its rows of it
    (:func:`decode_features`); every rank returns the one-process results
    and rank 0 writes them. Each rank decodes on the whole weights, as
    loaded: under mp the vocab is not split in the decode (the JAX package
    splits it; the tokens are the same)."""
    device = resolve_device(device)
    mesh = _mesh_of(cfg, cfg.mesh_dp, cfg.mesh_mp, device)
    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    feats, keys = load_split_features(cfg, vocab, split, feat_type(spec.arch))
    dp = max(cfg.mesh_dp, 1)
    chunk = min(max(1, cfg.bsize), max(len(feats), 1))
    chunk += (-chunk) % dp
    tokens = decode_features(params, spec, vocab.eos_id, feats, chunk, beam_size,
                             cfg.sample_temperature, cfg.sample_top_k,
                             cfg.sample_top_p, cfg.seed, device, mesh)
    results = [{"vid_key": k, "tokens": t.tolist(),
                "caption": vocab.get_sent_from_index(t)}
               for k, t in zip(keys, tokens)]
    if mesh is None or mesh.rank == 0:
        _write_json(results, out_file)
    return results


def _write_json(results, out_file: Optional[str]) -> None:
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(results, f, indent=2)


def _build_serving_pool(cfg: Config, checkpoint_path: str = "", device=None, channel=None):
    """(cfg, path) -> (continuous pool, vocab, arch). ``checkpoint_path`` is
    a checkpoint or a save_path directory holding ``model_best`` (as
    ``--serve_models`` entries give it); empty: ``cfg.save_path``'s best.
    Shared by the single- and multi-model daemons. Under ``channel`` (a
    ``serving_continuous.CommandChannel``) the pool's slots shard over its
    mesh's dp; a frozen pool is served unsharded, by rank 0, as the JAX
    package serves it."""
    meta_path = os.path.join(checkpoint_path or "", "meta.json")
    if checkpoint_path and os.path.isfile(meta_path):
        with open(meta_path) as f:
            if json.load(f).get("kind") == "continuous":
                # a frozen pool (--mode export_continuous): served as it is,
                # with no model code; a JAX-made one raises ValueError
                from vcr_tpu_torch.export_continuous import load_continuous

                cc = load_continuous(checkpoint_path, device)
                if channel is not None:
                    print(f"{checkpoint_path}: a frozen pool is served unsharded by "
                          f"rank 0; --mesh_dp {channel.mesh.dp} shards only live pools",
                          flush=True)
                return cc, cc.vocab, cc.meta["spec"]["arch"]
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    if checkpoint_path and os.path.isdir(os.path.join(checkpoint_path, "model_best")):
        cfg = cfg.replace(save_path=checkpoint_path)
        checkpoint_path = ""
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
                             rng=cfg.seed, device=device,
                             mesh=None if channel is None else channel.mesh,
                             channel=channel)
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
    the started server when ``block=False``.

    ``--mesh_dp N`` over N processes (``parallel.launch``) shards each live
    pool's slots over them: rank 0 serves HTTP and, after it drains, stops
    the others, which follow its pools (and ignore SIGINT and SIGTERM, which
    the launcher passes to every rank) and return None. A scheduler that
    fails under a mesh ends the daemon with RuntimeError."""
    import signal

    from vcr_tpu_torch.server import CaptionServer

    device = resolve_device(device)
    from vcr_tpu_torch import serving_continuous

    mesh = _mesh_of(cfg, cfg.mesh_dp, 1, device)
    # every pool this process builds on the mesh takes its commands here
    channel = None if mesh is None else serving_continuous.CommandChannel(mesh)
    if mesh is not None and mesh.rank != 0:
        # the launcher passes SIGTERM and SIGINT to every rank: rank 0 drains
        # and then stops the followers
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)
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
            cc, vocab, _ = _build_serving_pool(cfg, path, device, channel)
            backends[name] = (cc, vocab)
        if _follows(channel):
            return None
        server = MultiCaptionServer(backends, port=cfg.serve_port, **bounds).start()
        print(f"serving {len(backends)} models ({', '.join(sorted(backends))}) on "
              f"http://127.0.0.1:{server.port}: POST /caption/<model>, GET /models, "
              "GET /healthz; Ctrl-C to stop", flush=True)
    else:
        cc, vocab, arch = _build_serving_pool(cfg, checkpoint_path, device, channel)
        if _follows(channel):
            return None
        server = CaptionServer(cc, vocab=vocab, port=cfg.serve_port, **bounds).start()
        print(f"serving {arch} captions on http://127.0.0.1:{server.port} "
              f"(R={cc.slots}, A={cc.admit_chunk}"
              f"{'' if mesh is None else f', over dp={mesh.dp} processes'}): "
              "POST /caption, GET /healthz; Ctrl-C to stop", flush=True)
    if not block:
        # under a mesh the caller ends the followers after close(): any
        # live pool's stop()
        return server
    import threading

    # SIGTERM drains like Ctrl-C: close() stops accepting, lets the
    # scheduler finish in-flight decodes and releases waiting clients
    stop = threading.Event()
    prev = signal.signal(signal.SIGTERM, lambda *_: stop.set())
    failed = None
    try:
        while not stop.wait(1.0):
            if mesh is not None:
                # a broken group ends the daemon with an error, never a hang
                failed = _scheduler_error(server)
                if failed:
                    break
                serving_continuous.keepalive(channel)
        print("shutting down" if failed else "SIGTERM: shutting down", flush=True)
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.close()
        if mesh is not None and not failed:
            serving_continuous.stop_followers(channel)
    if failed:
        raise RuntimeError(f"the sharded pool failed: {failed}")


def _follows(channel) -> bool:
    """Ranks > 0 of a serving mesh: run rank 0's commands on the pools just
    built until it stops them -> True; rank 0 and one process: False."""
    if channel is None or channel.mesh.rank == 0:
        return False
    from vcr_tpu_torch.serving_continuous import follow

    print(f"rank {channel.mesh.rank}: following rank 0's sharded pools", flush=True)
    follow(channel)
    return True


def _scheduler_error(server) -> Optional[str]:
    """The error of a daemon's scheduler thread (any model's), or None."""
    servers = getattr(server, "servers", None) or {"": server}
    errors = [s.error for s in servers.values() if s.error]
    return "; ".join(errors) or None


def export_serving_artifact(cfg: Config, checkpoint_path: str = "",
                            out_dir: Optional[str] = None, device=None) -> str:
    """``--mode export_serving``: a checkpoint as a deployable serving
    artifact (:mod:`vcr_tpu_torch.export_serving`) under
    ``<save_path>/serving_artifact``, traced on ``device`` (the card by
    default), which runs on the card or the CPU. The decode follows the
    checkpoint-adopted flags (--beam_size, --sample_temperature,
    --sample_top_k, --sample_top_p, --serve_kv_cache,
    --serve_decode_weights); its draws are seeded with --seed. --mesh_dp N >
    1 exports a dp artifact (the batch split N ways, the weights replicated),
    in this one process."""
    from vcr_tpu_torch import export_serving

    cfg, params, spec, vocab = load_inference_state(cfg, checkpoint_path, device)
    out = out_dir or os.path.join(cfg.save_path, "serving_artifact")
    return export_serving.export_captioner(
        params, spec, out, featurizer="none", beam_size=cfg.beam_size, vocab=vocab,
        rng=cfg.seed, sample_temperature=cfg.sample_temperature,
        sample_top_k=cfg.sample_top_k, sample_top_p=cfg.sample_top_p,
        dp=max(cfg.mesh_dp, 1), kv_cache=cfg.serve_kv_cache,
        decode_weights=cfg.serve_decode_weights, device=device)


def export_continuous_artifact(cfg: Config, checkpoint_path: str = "",
                               out_dir: Optional[str] = None, device=None) -> str:
    """``--mode export_continuous``: freeze a continuous-batching slot pool
    (encode, admit and step programs, weights, the empty pool;
    :mod:`vcr_tpu_torch.export_continuous`) under
    ``<save_path>/continuous_artifact``, traced on ``device`` (the card by
    default). The pool's geometry comes from --serve_slots and
    --serve_admit_chunk. Serve it with ``--mode serve --pretrained_base
    <dir>``, which runs no model code. Sampling pools are live-only and
    raise, as in the JAX package. A mesh, which the JAX package ignores
    here, is refused by ``Config.validate``."""
    from vcr_tpu_torch.export_continuous import export_continuous

    # sample_temperature is a command-line override: its value here is the
    # one the checkpoint's config would give, so refuse before loading it
    if cfg.sample_temperature > 0:
        raise NotImplementedError(
            "per-slot sampling is live-pool only (--mode serve); the frozen "
            "continuous artifact bakes greedy or beam argmax into its step program: "
            "export without --sample_temperature")
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
