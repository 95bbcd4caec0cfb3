"""The training loop of the captioners: the counterpart of
``vcr_tpu/train/loop.py``, for the workloads ``train`` (S2VT, S2VT-att or
the Transformer, whose validation runs its parity greedy and beam decodes),
``train_rationale`` (RationaleNet over S2VT or S2VT-att) and
``train_spatial`` (SpatialNet over either, on YOLO grid features).

Per epoch: the teacher-forcing schedule, windowed train logging, a
validation pass with METEOR, BLEU-4, CIDEr-D, ROUGE-L and the embedding
metrics (greedy, or beam search with ``--beam_size``), sample sentences, and
the latest/best checkpoints keyed on validation METEOR (best on >=). Resume
adopts the saved config, restores the optimizer state, and restarts a
mid-epoch checkpoint (``--ckpt_iter``, or a SIGTERM/SIGINT) at its batch.

Multi-process training: under ``--mesh_dp`` x ``--mesh_mp`` the loop runs
in each process of an initialised ``torch.distributed`` group of that many
processes, one device each (``python -m vcr_tpu_torch.parallel.launch``
starts them). Each dp index reads its shard of the samples, bsize rows a
step; the vocab projection and the embedding are split over mp
(``parallel.mesh``); every rank scores the global validation batch; rank 0
writes the checkpoints, whole, so they equal a one-process run's; and a
signal to one process stops all of them at the same step boundary.

Seeds. Every random draw of a step (dropout masks, teacher-forcing coins,
Gumbel noise) comes from a generator seeded with one int,
``fold_seed(cfg.seed, n_iter + 1)`` for the update ``n_iter + 1``; the eval
forward of validation batch ``i`` (RationaleNet's frame selection) is seeded
with ``fold_seed(seed, i)``. Initial parameters come from
:func:`init_params`, drawn from a CPU generator seeded with ``cfg.seed``.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vcr_tpu_torch.config import Config, adopt_checkpoint_config
from vcr_tpu_torch.data.pipeline import BatchIterator, CaptionDataset, prefetch
from vcr_tpu_torch.decode import decode_tokens
from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.evals import metrics as qmetrics
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.parallel import mesh as pmesh
from vcr_tpu_torch.train import checkpoint as ckpt
from vcr_tpu_torch.train import optim, schedule
from vcr_tpu_torch.train.step import build_step_fns, device_batch
from vcr_tpu_torch.utils.logging import TrainLogger
from vcr_tpu_torch.utils.profiling import StepTimer, span, trace
from vcr_tpu_torch.utils.sampler import StreamSampler, print_sample_sents
from vcr_tpu_torch.vocab import Vocab

WORKLOADS = {
    # mode -> (model name from cfg, log keys, uses the tf schedule)
    "train": (lambda cfg: cfg.arch, ["acc", "loss"], True),
    "train_rationale": (lambda cfg: "rationale",
                        ["acc", "loss", "loss_ce", "loss_brev", "loss_cont", "len"],
                        False),
    "train_spatial": (lambda cfg: "spatial", ["acc", "loss"], True),
}


def workload(mode: str):
    """The WORKLOADS entry of ``mode``; eval-style modes train S2VT's."""
    return WORKLOADS[mode if mode in WORKLOADS else "train"]


def feat_type(model_name: str) -> str:
    """The features a family reads: SpatialNet YOLO grid features, the
    others CNN features (``CaptionDataset``'s feat_type)."""
    return "yolo" if model_name == "spatial" else "cnn"


def fold_seed(seed: int, i: int) -> int:
    """One int seed from (seed, i): seed * 2**32 + i, distinct for every
    0 <= i < 2**32."""
    if not 0 <= i < 2 ** 32:
        raise ValueError(f"fold_seed index {i} outside [0, 2**32)")
    return seed * 2 ** 32 + i


def init_params(cfg: Config, spec: model_base.ModelSpec, vocab: Vocab, device) -> dict:
    """The initial parameters of ``cfg``'s workload, drawn from a CPU
    generator seeded with ``cfg.seed``, on ``device``."""
    init_fn, _ = model_base.build_model(workload(cfg.mode)[0](cfg))
    return params_to(init_fn(torch.Generator().manual_seed(cfg.seed), spec,
                             vocab.vectors), device)


def load_vocab(cfg: Config) -> Vocab:
    return Vocab(os.path.join(cfg.data_dir, cfg.corpus, "glove", cfg.glove_emb_file),
                 seed=cfg.seed)


def make_datasets(cfg: Config, vocab: Vocab, with_train: bool = True, mesh=None
                  ) -> Tuple[Optional[BatchIterator], BatchIterator]:
    """The splits of ``cfg``'s workload, with its features;
    with_train=False reads only the val split (eval-only consumers). Under a
    mesh each dp index iterates its strided shard of the samples,
    ``cfg.bsize`` rows a step (the global batch is bsize x dp; the mp ranks
    of a dp index read the same rows), and the shards pad to one batch
    count so the collectives stay in lockstep."""
    feats = feat_type(workload(cfg.mode)[0](cfg))
    shards = (dict(num_shards=mesh.dp, shard_index=mesh.dp_index) if mesh is not None
              else {})
    val_ds = CaptionDataset(cfg.data_dir, cfg.corpus, "val", vocab,
                            cfg.num_frames, cfg.max_len, feats)
    train_it = None
    if with_train:
        train_ds = CaptionDataset(cfg.data_dir, cfg.corpus, "train", vocab,
                                  cfg.num_frames, cfg.max_len, feats)
        train_it = BatchIterator(train_ds, cfg.bsize, shuffle=True, seed=cfg.seed,
                                 num_threads=cfg.nworkers, **shards)
    val_it = BatchIterator(val_ds, cfg.bsize, shuffle=False, seed=cfg.seed,
                           num_threads=cfg.nworkers, **shards)
    return train_it, val_it


def _staged(it, device: torch.device):
    """Copy each batch's arrays to ``device`` from the prefetch thread. The
    copy is synchronous (``device_batch`` from host numpy memory returns
    once the data is on the device), so a step that later reads the tensors
    in the main thread finds them there."""
    for batch in it:
        batch["_device"] = device_batch(batch, device)
        yield batch


def _build_beam_fn(spec, model_name: str, vocab: Vocab, beam_size: int):
    """(params, vid_feats, rng) -> (tokens (B, K, L), scores) for a
    beam-search validation, or None for greedy (beam_size <= 1). Shared by
    train() and evaluate_checkpoint()."""
    if beam_size <= 1:
        return None
    beam_spec = spec.with_(arch=model_name)

    def beam_fn(params, vid_feats, rng):
        with torch.no_grad():
            return decode_tokens(params, beam_spec, vid_feats, vocab.eos_id, beam_size,
                                 rng=rng)

    return beam_fn


def _gather_global_rows(pred, batch, ds: CaptionDataset, vocab: Vocab, mesh):
    """(hyps, refs, vid_keys) of every valid row of the global batch, the
    same on every rank (collective over dp). The tokens travel with each
    row's dataset index in one gather; the references are read from the
    captions, which every rank loads."""
    local = np.concatenate([pmesh.local_rows(pred).astype(np.int32),
                            np.asarray(batch["sample_idx"], np.int32)[:, None]], axis=1)
    packed = pmesh.gather_global_rows(local, mesh)
    toks, idxs = packed[:, :-1], packed[:, -1]
    valid = idxs >= 0
    if not valid.any():
        return [], [], []
    hyps = vocab.get_sents_from_indexes(toks[valid])
    fields = [ds.text_fields(int(i), 0) for i in idxs[valid]]
    return hyps, [f["refs"] for f in fields], [f["vid_key"] for f in fields]


def evaluate(eval_step, params, val_it, vocab, log_keys, n_sample_sent, seed=0,
             device=None, beam_fn=None, mesh=None, specs=None):
    """Validation pass -> (metrics, sampled (hyp, ref, vid) triples,
    seconds): the log keys averaged over batches, per-sample METEOR averaged
    over batches, corpus BLEU-4, CIDEr-D, ROUGE-L and the embedding metrics.

    beam_fn: when given, the caption metrics score the best beams while the
    losses stay on the greedy eval logits. Batch i's forwards are seeded
    with ``fold_seed(seed, i)``.

    The seconds split into ``eval_decode_s`` (the device's forwards and the
    copies of their results to the host) and ``eval_host_metrics_s`` (the
    caption metrics on the host), both in the returned metrics.

    Under a mesh (``specs``: the split of ``params``) every rank scores the
    global batch: the hypotheses are gathered over dp, and the metrics of
    ``eval_step`` are the global batch's. The beam search runs on the whole
    parameters, gathered over mp once per pass."""
    device = resolve_device(device)
    beam_params = params
    if beam_fn is not None and mesh is not None and mesh.mp > 1:
        beam_params = pmesh.unshard_params(params, mesh, specs)
    t0 = time.time()
    sums: Dict[str, float] = {k: 0.0 for k in log_keys}
    meteor_sum, num_batches = 0.0, 0
    sampler = StreamSampler(n_sample_sent, seed=seed)
    all_hyps, all_refs = [], []
    rnd = np.random.default_rng(seed)
    decode_s = host_s = 0.0

    for n_seen, batch in enumerate(prefetch(_staged(val_it, device))):
        t = time.perf_counter()
        batch_seed = fold_seed(seed, n_seen)
        m, pred = eval_step(params, batch["_device"], batch_seed)
        if beam_fn is not None:
            tokens, _scores = beam_fn(beam_params, batch["_device"]["vid_feats"],
                                      batch_seed)
            pred = tokens[:, 0]  # the best beam
        if mesh is not None:
            hyps, refs_b, keys_b = _gather_global_rows(pred, batch, val_it.ds, vocab,
                                                       mesh)
            n_valid = len(hyps)
        else:
            n_valid = int(batch["valid"].sum())
        if n_valid == 0:
            continue
        # one copy of the batch's scalars and one of its tokens
        m_host = torch.stack([m[k].float() for k in log_keys]).cpu().tolist()
        pred = pred.cpu().numpy()
        decode_s += time.perf_counter() - t
        t = time.perf_counter()
        if mesh is None:
            hyps = vocab.get_sents_from_indexes(pred[:n_valid])
            refs_b, keys_b = batch["refs"], batch["vid_key"]
        for hyp, refs, vk in zip(hyps, refs_b, keys_b):
            sampler.add((hyp, refs[rnd.integers(len(refs))], vk))
        meteor_sum += qmetrics.batch_meteor(hyps, refs_b)
        all_hyps.extend(hyps)
        all_refs.extend(refs_b)
        for k, v in zip(log_keys, m_host):
            sums[k] += v
        num_batches += 1
        host_s += time.perf_counter() - t

    t = time.perf_counter()
    avg = {k: v / max(num_batches, 1) for k, v in sums.items()}
    avg["METEOR"] = meteor_sum / max(num_batches, 1)
    avg["BLEU4"] = qmetrics.corpus_bleu(all_hyps, all_refs)
    avg["CIDEr"] = qmetrics.cider_d(all_hyps, all_refs)
    avg["ROUGE_L"] = qmetrics.corpus_rouge_l(all_hyps, all_refs)
    avg.update(qmetrics.corpus_embedding_metrics(
        all_hyps, all_refs, qmetrics.vocab_lookup(vocab)))
    avg["eval_decode_s"] = decode_s
    avg["eval_host_metrics_s"] = host_s + time.perf_counter() - t
    return avg, sampler.get(), time.time() - t0


def evaluate_checkpoint(cfg: Config, ckpt_path: str = "", device=None) -> Dict[str, float]:
    """Eval only: load a checkpoint (default <save_path>/model_best) and run
    the validation pass. The model is rebuilt from the checkpoint's embedded
    config; the command line supplies I/O knobs only."""
    device = resolve_device(device)
    path = ckpt_path or ckpt.best_path(cfg.save_path)
    params, _, meta = ckpt.load_checkpoint(path, device)
    cfg = adopt_checkpoint_config(cfg, meta)
    model_name_fn, log_keys, _ = workload(cfg.mode)
    model_name = model_name_fn(cfg)

    vocab = load_vocab(cfg)
    spec = model_base.spec_from_config(cfg, vocab)
    _, val_it = make_datasets(cfg, vocab, with_train=False)
    optimizer = optim.build_optimizer(cfg.optim, cfg.lr, cfg.wd, cfg.max_norm)
    _, eval_step = build_step_fns(model_name, spec, optimizer, cfg.lambda_brev,
                                  cfg.lambda_cont, device=device)
    beam_fn = _build_beam_fn(spec, model_name, vocab, cfg.beam_size)
    metrics, samples, _ = evaluate(eval_step, params, val_it, vocab, log_keys,
                                   cfg.n_sample_sent, cfg.seed, device, beam_fn)
    print(f"Eval of {path} (epoch {meta.get('epoch')}): "
          + ", ".join(f"{k}={v:.5f}" for k, v in metrics.items()))
    print_sample_sents(samples)
    return metrics


def train(cfg: Config, device=None) -> Dict[str, float]:
    """Entry point of the modes train, train_rationale and train_spatial ->
    the last epoch's validation metrics, with its step times under
    ``perf/``."""
    device = resolve_device(device)
    # resume adopts the checkpointed config before the model is built, so
    # `--resume true` needs only I/O flags
    if cfg.resume:
        meta_early = ckpt.peek_meta(ckpt.latest_path(cfg.save_path))
        if meta_early is not None and meta_early.get("config"):
            cfg = Config.from_dict(meta_early["config"]).replace(resume=True)
    mesh = _make_mesh(cfg, device)

    model_name_fn, log_keys, use_tf_schedule = workload(cfg.mode)
    model_name = model_name_fn(cfg)
    vocab = load_vocab(cfg)
    spec = model_base.spec_from_config(cfg, vocab)
    train_it, val_it = make_datasets(cfg, vocab, mesh=mesh)
    print(f"====> Input route: {train_it.route} ({train_it.num_threads} threads)")
    params = init_params(cfg, spec, vocab, device)

    # RationaleNet's warm start from a captioner trained by this package
    if model_name == "rationale" and cfg.pretrained_base:
        base_params, _, _ = ckpt.load_checkpoint(cfg.pretrained_base, device)
        ckpt.restore_into(params["caption_net"], base_params)
        print(f"====> Loaded pretrained base from {cfg.pretrained_base}")

    specs = None
    if mesh is not None:
        # every rank starts from rank 0's weights, then keeps its blocks
        pmesh.replicate(params, mesh)
        specs = pmesh.param_specs(params, spec.padded_vocab_size, mesh.mp)
        params = pmesh.shard_params(params, mesh, specs)
        print(f"====> Mesh: dp={mesh.dp} x mp={mesh.mp}, rank {mesh.rank} "
              f"(dp {mesh.dp_index}, mp {mesh.mp_index}); global batch "
              f"{cfg.bsize * mesh.dp}")

    optimizer = optim.build_optimizer(cfg.optim, cfg.lr, cfg.wd, cfg.max_norm,
                                      cfg.momentum)
    opt_state = optimizer.init(params)
    # a constant schedule passes tf statically, so the decoders take their
    # hoisted form
    scheduled_tf = use_tf_schedule and cfg.schedule_sample
    train_step, eval_step = build_step_fns(model_name, spec, optimizer, cfg.lambda_brev,
                                           cfg.lambda_cont, remat=cfg.remat,
                                           grad_accum=cfg.grad_accum,
                                           static_tf=None if scheduled_tf else 1.0,
                                           device=device, mesh=mesh, specs=specs)
    beam_fn = _build_beam_fn(spec, model_name, vocab, cfg.beam_size)
    tf_probs = schedule.teacher_force_schedule(
        cfg.epochs, cfg.schedule_sample if use_tf_schedule else False)

    manager = ckpt.CheckpointManager(cfg.save_path)
    start_n_iter, best_val_meteor = 0, 0.0
    start_epoch = cfg.start_epoch
    skip_batches = 0  # mid-epoch resume: batches already done in start_epoch
    if cfg.resume:
        resumed = (manager.try_resume(params, opt_state) if mesh is None
                   else _resume_split(manager, params, opt_state, mesh, specs))
        if resumed is not None:
            print("====> Resuming training from previous checkpoint")
            params, opt_state, meta = resumed
            start_n_iter = meta["n_iter"]
            best_val_meteor = meta.get("best_val_meteor_score", 0.0)
            cfg = Config.from_dict(meta["config"])
            if meta.get("batch_in_epoch") is not None:
                start_epoch = meta["epoch"]
                skip_batches = meta["batch_in_epoch"]
                print(f"====> Mid-epoch resume: epoch {start_epoch}, "
                      f"skipping {skip_batches} batches")
            else:
                start_epoch = meta["epoch"] + 1

    logger = TrainLogger(start_epoch, cfg.log_iter, cfg.log_dir)
    logger.set(log_keys)
    logger.n_iter = start_n_iter

    # Preemption: SIGTERM/SIGINT set a flag, and the loop saves a mid-epoch
    # checkpoint at the next step boundary (or exits after the epoch's
    # checkpoint if the signal lands during validation), so `--resume true`
    # continues from the exact batch. A second signal restores the previous
    # handlers and re-raises.
    preempted = {"flag": False}
    prev_handlers = {}

    def _restore_handlers():
        while prev_handlers:
            sig, h = prev_handlers.popitem()
            signal.signal(sig, h)

    def _on_preempt(signum, frame):
        if preempted["flag"]:
            _restore_handlers()
            signal.raise_signal(signum)
            return
        preempted["flag"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_preempt)
        except ValueError:  # not the main thread: leave the handlers alone
            pass

    def _writable(params, opt_state):
        """(params, optimizer state) whole, as one process holds them, on
        the rank that writes checkpoints; None on the others. Under a mesh
        every rank calls it: the mp gathers are collective."""
        if mesh is None:
            return params, opt_state
        whole = (pmesh.unshard_params(params, mesh, specs),
                 _unshard_opt_state(opt_state, mesh, specs))
        return whole if mesh.rank == 0 else None

    def _save_latest(epoch, batch_in_epoch, n_iter, params, opt_state, best):
        whole = _writable(params, opt_state)
        if whole is not None:
            ckpt.save_checkpoint(
                ckpt.latest_path(cfg.save_path), *whole,
                {"epoch": epoch, "n_iter": n_iter, "config": cfg.to_dict(),
                 "best_val_meteor_score": best, "batch_in_epoch": batch_in_epoch})

    try:
        return _train_epochs(cfg, start_epoch, tf_probs, train_it, val_it, vocab,
                             log_keys, logger, params, opt_state, train_step,
                             eval_step, device, beam_fn, manager, best_val_meteor,
                             skip_batches, preempted, _save_latest, _writable, mesh,
                             specs)
    finally:
        _restore_handlers()


def _make_mesh(cfg: Config, device) -> Optional[pmesh.Mesh]:
    """The (mesh_dp, mesh_mp) layout of this process's group, or None for a
    one-process run. A group of several processes without a mesh raises:
    nothing would synchronise their gradients."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if cfg.mesh_dp * cfg.mesh_mp > 1:
        return pmesh.make_mesh(cfg.mesh_dp, cfg.mesh_mp, device)
    if world > 1:
        raise RuntimeError(
            f"a launch of {world} processes needs a mesh spanning them: set --mesh_dp "
            f"(x --mesh_mp) to {world}, or each process would train a model of its own")
    return None


def _opt_split(opt_state, specs):
    return [pmesh.spec_at(specs, path) for path in opt_state.paths]


def _unshard_opt_state(opt_state, mesh, specs) -> dict:
    """The optimizer's state_dict with the moments of mp-split leaves
    gathered whole (collective over mp)."""
    sd = opt_state.optimizer.state_dict()
    for i, spec in enumerate(_opt_split(opt_state, specs)):
        if spec is None or i not in sd["state"]:
            continue
        sd["state"][i] = {k: (pmesh.gather_leaf(v, spec, mesh)
                              if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
                          for k, v in sd["state"][i].items()}
    return sd


def _resume_split(manager, params, opt_state, mesh, specs):
    """``manager.try_resume`` for mp-split parameters: the whole checkpoint
    is read on every rank and each keeps its blocks."""
    path = ckpt.latest_path(manager.save_path)
    if not ckpt.checkpoint_exists(path):
        return None
    saved, opt_saved, meta = ckpt.load_checkpoint(path, "cpu")
    ckpt.restore_into(params, pmesh.shard_params(saved, mesh, specs))
    for i, spec in enumerate(_opt_split(opt_state, specs)):
        if spec is not None and i in opt_saved["state"]:
            opt_saved["state"][i] = {
                k: (pmesh.shard_leaf(v, spec, mesh)
                    if isinstance(v, torch.Tensor) and v.dim() > 0 else v)
                for k, v in opt_saved["state"][i].items()}
    opt_state.optimizer.load_state_dict(opt_saved)
    return params, opt_state, meta


def _train_epochs(cfg, start_epoch, tf_probs, train_it, val_it, vocab, log_keys,
                  logger, params, opt_state, train_step, eval_step, device, beam_fn,
                  manager, best_val_meteor, skip_batches, preempted, save_latest,
                  writable, mesh, specs):
    """The epoch loop of train(), inside its signal handlers. Under a mesh
    the ranks agree on a preemption at every step boundary (an all-reduce of
    the flags), so a signal to one process stops all of them at one step."""
    final_metrics: Dict[str, float] = {}
    timer = StepTimer()
    with trace():  # a torch.profiler trace when VCR_TRACE_DIR is set
        for epoch in range(start_epoch, cfg.epochs):
            logger.step()
            tf_prob = float(tf_probs[epoch])
            sampler = StreamSampler(cfg.n_sample_sent, seed=cfg.seed + epoch)
            rnd = np.random.default_rng(cfg.seed + epoch)

            # the shuffle of an absolute epoch, so a mid-epoch resume lands on
            # the same batch order; skipped batches are dropped before IO
            train_it.epoch = epoch
            train_it.skip_next = skip_batches
            batch_in_epoch = skip_batches
            timer.reset()
            for batch in prefetch(_staged(train_it, device)):
                timer.tick()
                params, opt_state, m, pred = train_step(
                    params, opt_state, batch["_device"],
                    fold_seed(cfg.seed, logger.n_iter + 1), tf_prob)
                batch_in_epoch += 1
                if pmesh.global_any(preempted["flag"], mesh):
                    logger.n_iter += 1  # this step counts
                    save_latest(epoch, batch_in_epoch, logger.n_iter, params, opt_state,
                                best_val_meteor)
                    print("====> Preemption signal: saved mid-epoch "
                          f"checkpoint (epoch {epoch}, batch {batch_in_epoch})"
                          " -- exiting; resume with --resume true")
                    return final_metrics
                if cfg.ckpt_iter and (logger.n_iter + 1) % cfg.ckpt_iter == 0:
                    save_latest(epoch, batch_in_epoch, logger.n_iter + 1, params,
                                opt_state, best_val_meteor)
                # lazy reservoir: the tokens come to the host only for a
                # batch with a row the sample keeps
                pred_host = None
                for j, (refs, vk) in enumerate(zip(batch["refs"], batch["vid_key"])):
                    key = sampler.draw_key()
                    if sampler.would_accept(key):
                        if pred_host is None:
                            pred_host = pred.cpu().numpy()
                        hyp = vocab.get_sent_from_index(pred_host[j])
                        sampler.add_with_key(key, (hyp, refs[rnd.integers(len(refs))], vk))
                logger.update(m)
            skip_batches = 0  # only the first resumed epoch skips
            step_times = timer.summary()
            for k, v in step_times.items():
                logger.log_scalar(f"perf/{k}", v)

            with span("evaluate"):
                val_metrics, val_samples, time_taken = evaluate(
                    eval_step, params, val_it, vocab, log_keys, cfg.n_sample_sent,
                    cfg.seed, device, beam_fn, mesh, specs)

            print("\n" + "*" * 34 + " TRAIN " + "*" * 34)
            print_sample_sents(sampler.get())
            print("*" * 75 + "\n")
            print("*" * 35 + " VAL " + "*" * 35)
            logger.log_valid(time_taken, val_metrics)
            for k in ("METEOR", "BLEU4", "CIDEr"):
                logger.log_scalar(f"val/{k}", val_metrics[k])
            print(f"Validation METEOR score: {val_metrics['METEOR']:.5f} "
                  f"(BLEU-4 {val_metrics['BLEU4']:.5f}, "
                  f"CIDEr {val_metrics['CIDEr']:.5f})")
            print_sample_sents(val_samples)
            print("")

            is_best = val_metrics["METEOR"] >= best_val_meteor
            if is_best:
                best_val_meteor = val_metrics["METEOR"]
            with span("checkpoint"):
                whole = writable(params, opt_state)
                if whole is not None:
                    manager.save_epoch(*whole, epoch, logger.n_iter, cfg.to_dict(),
                                       val_metrics["METEOR"], best_val_meteor, is_best)
            final_metrics = dict(val_metrics,
                                 **{f"perf/{k}": v for k, v in step_times.items()})

            # a signal during validation or checkpointing: the epoch's
            # checkpoint is already written, so exit here
            if pmesh.global_any(preempted["flag"], mesh):
                print(f"====> Preemption signal: epoch {epoch} checkpoint "
                      "saved -- exiting; resume with --resume true")
                return final_metrics
    return final_metrics
