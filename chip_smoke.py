"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a non-zero
exit code and no result line:

1. device  -- the card's name, and its name and power limit from nvidia-smi.
2. build   -- compile every CUDA source under vcr_tpu_torch/ops/csrc/, one
   nvcc each, all started together; then the geometry of the tensor-core
   bodies of B1/B3, of B2 and of B4: cluster size, the clusters the card
   holds at once (cudaOccupancyMaxActiveClusters), shared memory per CTA
   and the rows per cluster at each checked batch (for B4 also its warps
   per CTA and the x_gates slots in each warp's copy ring).
3. kernels -- each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at ragged batch sizes, in bf16 and float32
   (and both directions for the LSTM), B1, B3, B4 and B2 also at the
   serving batches (1024 and 2048 for the GRUs, at T=30 and T=1; 1024 for
   B2); the body each B1, B4 and B2 case ran (tensor-core in bf16, scalar
   in float32); B3 and bf16 B4 equal to B1 bit for bit (one body, one
   order of sums), float32 B4 against B1 reported; B4 and every bf16 B2
   case twice with identical outputs, since a missing copy wait, fence or
   cluster barrier shows only on some runs.
4. main paths -- each greedy captioner (features -> tokens, full width,
   random weights from a seed) through serving.build_captioner, with the
   kernel launch counts set to 0 just before and read just after its run:
   the flagship S2VT (B1 twice, both on the tensor-core body), then
   RationaleNet over that S2VT (B2 once per direction, then B1 twice, all
   on the tensor-core bodies);
   float32 tokens on the card against the CPU, with shared Gumbel noise for
   RationaleNet. Then the GRU drop-ins on the flagship encoder's weights and
   features: gru_sequence_fused_bt (B3 once) and gru_sequence_fused_dma (B4
   once, on its tensor-core body) against s2vt.encode.
5. timing  -- CUDA events, best of 3 after warm-up: captions/s of each
   captioner, a stage breakdown, each kernel's time beside its bound, its
   plain version and a library yardstick (B1 and B4 at both serving
   batches, and the input projection alone, which the yardsticks include, for B1 and
   for B2), and the flagship encoder with and without its feature
   transpose (B1 against B3).

6. train    -- the train step of each served captioner through
   train.step.build_step_fns at full width (random weights from a seed),
   Adam with the clip, static teacher forcing: the flagship S2VT at B=1024
   (bf16, dropout 0.2) and RationaleNet at B=512 (bench_train.py:27-33).
   Three steps each, with the counts set to 0 just before each step and read
   just after (S2VT: B1 twice, on the tensor-core body; RationaleNet: B2 and
   B1 twice each; B3 and B4 never), finite losses, parameters that moved;
   one S2VT step with remat=True (B1 four times: its forward runs again in
   the backward). Float32 at B=4, TF32 off: the loss and every gradient
   leaf on the card against the CPU (RationaleNet under one injected Gumbel
   noise), and the bf16 vdot's gradient on the card equal to the CPU's.
   Then step times (CUDA events, best of 3 after warm-up), samples/s, peak
   memory, the split into forward, backward and optimizer, and B1's and
   B2's forward launches against their backward recompute.
7. cli_path -- the command line, vcr_tpu_torch.cli.main in this process, on
   a corpus written to a temporary directory: a GloVe file of 8,996 random
   300-d words (a vocab of 9,000, padded to 9,088), two captions of 5-19 of
   those words per video, (30, 4096) float32 features for 512 train and 256
   val videos. S2VT at full width (H=512, bf16, --bsize 256) trains 2
   epochs with beam-5 validation, then --mode eval (beam 5), --mode decode
   with beam 5 and greedy, then RationaleNet trains 1 epoch (--bsize 128)
   from S2VT's model_best; then --resume true, and the resumed Adam state
   read back onto the card. The counts are set to 0 just before each mode
   and read just after: B1 twice per train step, per greedy eval step and
   per beam or greedy decode call, B2 twice per RationaleNet step and eval
   step, B3 and B4 never. Finite losses, both checkpoints, one caption per
   val video. Then the train step's ms (the loop's StepTimer: one interval
   at this shape), the eval pass's seconds split into device decode and
   host metrics, and decode_corpus's captions/s at beam 1 and beam 5.
   Last, float32 on the card against the CPU on a tiny corpus (6 train and
   3 val videos, H=16, dropout 0, 2 epochs, beam 3, TF32 off): the same
   validation METEOR, BLEU-4 and CIDEr each epoch, the same captions, and
   parameters within 1e-4 * max(1, max|p|).

Then come a JSON object listing every kernel, nvidia-smi's name and power
limit line, and, last, {"ok": true, "device": {...}}. Needs one CUDA card;
imports only the port.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# The card the bounds are computed for, and its published dense peaks (NVIDIA
# H100 SXM data sheet): bf16 tensor-core FLOP/s, float32 FLOP/s outside the
# tensor cores, device-memory bytes/s. Another card ends the run.
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = (989e12, 67e12, 3.35e12)

SMOKE_BATCH = 256      # main-path batch of the correctness phases
TIMING_BATCH = 2048    # flagship serving batch of the timing phase
RATIONALE_BATCH = 1024  # RationaleNet serving batch of the timing phase
BF16_TOL = 2e-3        # f32 dots summed in other orders over 30 dependent steps;
                       # readings: B1 and B3 (tensor-core body) 8.2e-4 (B=256),
                       # 1.15e-3 (B=1024); B4 9.8e-4 (B=2048)
F32_TOL = 1e-4         # the same, in float32 with TF32 off
LSTM_BF16_TOL = 1e-3   # B2 (outs and c_last), the same reason: twice the worst
                       # reading (4.5e-4 at B=256), 2.6x below the control's
                       # 2.6e-3 (float32 plain on bf16 inputs)
LSTM_F32_TOL = 1e-4    # readings <= 1.9e-6
LOGIT_TOL = 1e-3       # float32 logits card vs CPU: dot orders through the
                       # recurrences and 20 decode steps; readings ~2.5e-7
TRAIN_BATCH = 1024           # the S2VT train step's batch (bench_train.py:29)
RATIONALE_TRAIN_BATCH = 512  # RationaleNet's (bench_train.py:32)
TRAIN_SENT_LEN = 12          # every sentence's length (bench_train.py:84)
TRAIN_LOSS_TOL = 1e-5        # float32 loss card vs CPU at B=4, TF32 off
TRAIN_GRAD_TOL = 1e-4        # float32 gradient leaf card vs CPU, times
                             # max(1, max|g|) of the leaf
CLI_WORDS = 8996             # GloVe words: with 4 special tokens a vocab of 9,000
CLI_TRAIN_VIDEOS = 512
CLI_VAL_VIDEOS = 256
CLI_BATCH = 256              # S2VT's --bsize in phase 7
CLI_RATIONALE_BATCH = 128    # RationaleNet's
CLI_BEAM = 5
CLI_PARAM_TOL = 1e-4         # float32 parameters after 2 epochs card vs CPU,
                             # times max(1, max|p|) of the leaf, TF32 off


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int = 1, reps: int = 3) -> float:
    """Best of ``reps`` of ``iters`` calls, by CUDA events, after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def gru_inputs(t, b, hidden, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_gates = torch.randn((t, b, 3 * hidden), generator=g, device="cuda").to(dtype)
    w_hh = (torch.randn((hidden, 3 * hidden), generator=g, device="cuda")
            * (2.0 / (4 * hidden)) ** 0.5).to(dtype)
    b_hh = torch.randn((3 * hidden,), generator=g, device="cuda")
    h0 = torch.randn((b, hidden), generator=g, device="cuda")
    return x_gates, w_hh, b_hh, h0


def lstm_inputs(t, b, hidden, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x_gates = torch.randn((t, b, 4 * hidden), generator=g, device="cuda").to(dtype)
    w_hh = (torch.randn((hidden, 4 * hidden), generator=g, device="cuda")
            * (2.0 / (5 * hidden)) ** 0.5).to(dtype)
    b_hh = torch.randn((4 * hidden,), generator=g, device="cuda")
    h0 = torch.randn((b, hidden), generator=g, device="cuda")
    c0 = torch.randn((b, hidden), generator=g, device="cuda")
    return x_gates, w_hh, b_hh, h0, c0


def launch_counts(cuda_gru, cuda_lstm) -> dict:
    """Kernel launches by counter; gru_seq_tc counts the B1 and B3 launches
    that ran the tensor-core body, gru_seq_dma_tc the B4 launches and
    lstm_seq_tc the B2 launches that ran theirs."""
    return {"gru_seq": cuda_gru.launches, "gru_seq_bt": cuda_gru.launches_bt,
            "gru_seq_dma": cuda_gru.launches_dma, "gru_seq_tc": cuda_gru.launches_tc,
            "gru_seq_dma_tc": cuda_gru.launches_dma_tc,
            "lstm_seq": cuda_lstm.launches, "lstm_seq_tc": cuda_lstm.launches_tc}


def reset_counts(cuda_gru, cuda_lstm) -> None:
    cuda_gru.launches = cuda_gru.launches_bt = cuda_gru.launches_dma = 0
    cuda_gru.launches_tc = cuda_gru.launches_dma_tc = 0
    cuda_lstm.launches = cuda_lstm.launches_tc = 0


def max_err(got, want) -> float:
    """Largest absolute difference over a tensor or a tuple of tensors."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max((x - y).abs().max().item() for x, y in zip(got, want))


def all_finite(got) -> bool:
    if isinstance(got, torch.Tensor):
        got = (got,)
    return all(bool(torch.isfinite(x).all()) for x in got)


def gru_bound_ms(t, b, hidden, peaks):
    """Least time of one B1 call in bf16: bytes of each input read once and
    the output written once, or the recurrent product at the bf16 tensor-core
    rate plus the gate math (counted as 14 float32 operations per hidden
    element) at the float32 rate, whichever is larger."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 3 * hidden * 2 + hidden * 3 * hidden * 2 + 3 * hidden * 4
              + b * hidden * 4 + t * b * hidden * 4)
    ops_s = 2 * t * b * hidden * 3 * hidden / bf16_rate + 14 * t * b * hidden / f32_rate
    bytes_s = nbytes / mem_rate
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def lstm_bound_ms(t, b, hidden, peaks):
    """Least time of one B2 call (one direction) in bf16: bytes of each input
    read once and each output written once, or the recurrent product at the
    bf16 tensor-core rate plus the gate math (counted as 23 float32
    operations per hidden element: 8 adds, 3 sigmoids at 3, 2 tanh at 1, 4
    for the c and h updates) at the float32 rate, whichever is larger."""
    bf16_rate, f32_rate, mem_rate = peaks
    nbytes = (t * b * 4 * hidden * 2 + hidden * 4 * hidden * 2 + 4 * hidden * 4
              + 2 * b * hidden * 4 + t * b * hidden * 4 + b * hidden * 4)
    ops_s = 2 * t * b * hidden * 4 * hidden / bf16_rate + 23 * t * b * hidden / f32_rate
    bytes_s = nbytes / mem_rate
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s else "bytes")


def train_batch(gen, b, spec, feats_dtype):
    """bench_train.py's batch, drawn on ``gen``'s device: normal features,
    uniform tokens, every sentence 12 tokens long, every row valid."""
    device = gen.device
    return {"vid_feats": torch.randn((b, spec.num_frames, spec.vid_feat_size),
                                     generator=gen, device=device).to(feats_dtype),
            "sent": torch.randint(0, spec.vocab_size, (b, spec.max_len), generator=gen,
                                  device=device, dtype=torch.int32),
            "sent_len": torch.full((b,), TRAIN_SENT_LEN, dtype=torch.int32,
                                   device=device),
            "valid": torch.ones((b,), device=device)}


def copy_params(params, device):
    return {k: copy_params(v, device) if isinstance(v, dict)
            else v.detach().to(device, copy=True) for k, v in params.items()}


def f32_card_vs_cpu(loss_fn, params, batch, device):
    """Float32 loss and gradients of ``loss_fn(params, batch) -> (loss, ...)``
    on ``device`` and on the CPU, from one copy of the weights: (loss error,
    worst gradient leaf error relative to max(1, max|g|), its path)."""
    from vcr_tpu_torch.train import optim

    out = []
    for dev in (device, "cpu"):
        p = copy_params(params, dev)
        leaves = optim.trainable_leaves(p)[1]
        for x in leaves:
            x.requires_grad_(True)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.enable_grad():
            loss = loss_fn(p, b)[0]
            grads = torch.autograd.grad(loss, leaves)
        out.append((loss.item(), [g.cpu() for g in grads]))
    (loss_card, g_card), (loss_cpu, g_cpu) = out
    paths = optim.trainable_leaves(params)[0]
    errs = {"/".join(path): (x - y).abs().max().item() / max(1.0, y.abs().max().item())
            for path, x, y in zip(paths, g_card, g_cpu)}
    worst = max(errs, key=errs.get)
    return abs(loss_card - loss_cpu), errs[worst], worst


def step_timing(train, params, state, batch, opt):
    """One family's step: ms (best of 3 after warm-up, CUDA events) of the
    whole step, of the forward alone (``StepFns.loss``), of the forward and
    backward (``StepFns.grads``) and of the optimizer; peak memory of a step."""
    fns = train.__self__
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train(params, state, batch, 10, 1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = time_ms(lambda: train(params, state, batch, 11, 1.0))
    forward_ms = time_ms(lambda: fns.loss(params, batch, 12, 1.0))
    fwd_bwd_ms = time_ms(lambda: fns.grads(params, state.leaves, batch, 13, 1.0))
    grads = fns.grads(params, state.leaves, batch, 14, 1.0)[0]
    optimizer_ms = time_ms(lambda: opt.step(state, grads))
    b = batch["vid_feats"].shape[0]
    return {"batch": b, "step_ms": step_ms, "samples_per_s": b / (step_ms / 1e3),
            "forward_ms": forward_ms, "backward_ms": fwd_bwd_ms - forward_ms,
            "optimizer_ms": optimizer_ms, "peak_memory_bytes": peak}


def sequence_fwd_bwd_ms(fused, kernel_args, kernel, leaves, cot):
    """A differentiable sequence (``fused()`` -> outputs under autograd):
    ms of the kernel launch alone, of the whole forward (projection,
    rounding, launch) and of its backward, the plain recurrence recomputed
    and differentiated (``autograd.grad`` with the graph kept)."""
    with torch.enable_grad():
        outs = fused()
        return {"kernel_ms": time_ms(lambda: kernel(*kernel_args), iters=5),
                "forward_ms": time_ms(fused),
                "backward_ms": time_ms(lambda: torch.autograd.grad(
                    outs, leaves, cot, retain_graph=True))}


def train_phase(family, cuda_gru, cuda_lstm, smi, device="cuda"):
    """Phase 6 for ``family`` ("s2vt" or "rationale") on ``device``; returns
    what the kernels line reports of it."""
    from vcr_tpu_torch import entry
    from vcr_tpu_torch.models import rationale
    from vcr_tpu_torch.nn.layers import vdot
    from vcr_tpu_torch.train import losses, optim, step

    s2vt_family = family == "s2vt"
    spec, params = entry.make_spec_and_params(
        **(entry.FLAGSHIP if s2vt_family else entry.RATIONALE), device=device)
    b = TRAIN_BATCH if s2vt_family else RATIONALE_TRAIN_BATCH
    cd, frames, hidden = spec.cdtype, spec.num_frames, spec.hidden_size
    opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns(family, spec, opt, static_tf=1.0, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    batch = train_batch(gen, b, spec, cd)
    expected = {"gru_seq": 2, "gru_seq_bt": 0, "gru_seq_dma": 0, "gru_seq_tc": 2,
                "gru_seq_dma_tc": 0, "lstm_seq": 0 if s2vt_family else 2,
                "lstm_seq_tc": 0 if s2vt_family else 2}
    caption_net = params if s2vt_family else params["caption_net"]
    before = caption_net["linear"]["w"].detach().clone()
    step_losses, step_launches = [], []
    for i in range(3):
        reset_counts(cuda_gru, cuda_lstm)
        _, _, metrics, pred = train(params, state, batch, i, 1.0)
        torch.cuda.synchronize()
        step_launches.append(launch_counts(cuda_gru, cuda_lstm))
        step_losses.append(metrics["loss"].item())
    check(all(c == expected for c in step_launches),
          f"{family} train steps launched {step_launches}, not {expected}")
    check(all(math.isfinite(x) for x in step_losses), f"{family} losses {step_losses}")
    check(not torch.equal(before, caption_net["linear"]["w"]),
          f"{family}: three steps left linear.w unchanged")
    check(tuple(pred.shape) == (b, spec.max_len) and pred.dtype == torch.int32,
          f"{family} pred {tuple(pred.shape)} {pred.dtype}")
    result = {"batch": b, "losses": step_losses, "launches_per_step": step_launches[-1],
              "metrics": {k: v.item() for k, v in metrics.items()}}
    if s2vt_family:
        # remat: the backward runs the forward again, B1 included
        remat_train, _ = step.build_step_fns(family, spec, opt, static_tf=1.0, remat=True,
                                             device=device)
        reset_counts(cuda_gru, cuda_lstm)
        remat_train(params, state, batch, 3, 1.0)
        torch.cuda.synchronize()
        remat_launches = launch_counts(cuda_gru, cuda_lstm)
        want = dict(expected, gru_seq=4, gru_seq_tc=4)
        check(remat_launches == want,
              f"a remat=True step launched {remat_launches}, not {want}")
        result["remat_launches_per_step"] = remat_launches

    # float32 at B=4, full width, TF32 off: card against CPU
    spec32 = spec.with_(compute_dtype="float32", dropout_p=0.0)
    small = train_batch(gen, 4, spec32, torch.float32)
    if s2vt_family:
        fns32 = step.build_step_fns(family, spec32, opt, static_tf=1.0,
                                    device=device)[0].__self__

        def loss_fn(p, bt):
            return fns32.loss(p, bt, 0, 1.0)
    else:
        noise = torch.from_numpy(np.random.default_rng(5).gumbel(
            size=(4, frames, 2)).astype(np.float32))

        def loss_fn(p, bt):
            logits, probs = rationale.apply(p, spec32, bt["vid_feats"], bt["sent"],
                                            train=True, gumbel_noise=noise.to(
                                                bt["vid_feats"].device))
            return (losses.masked_cross_entropy(logits, bt["sent"], bt["sent_len"],
                                                bt["valid"])
                    + losses.brevity_loss(probs, bt["valid"])
                    + losses.continuity_loss(probs, bt["valid"]),)
    loss_err, grad_err, grad_worst = f32_card_vs_cpu(loss_fn, params, small, device)
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
          f"{family} float32 card vs CPU: loss err {loss_err}, gradient err {grad_err} "
          f"({grad_worst})")
    result.update(f32_loss_err=loss_err, f32_loss_tolerance=TRAIN_LOSS_TOL,
                  f32_grad_rel_err=grad_err, f32_grad_worst_leaf=grad_worst,
                  f32_grad_tolerance=TRAIN_GRAD_TOL)
    if s2vt_family:
        # the bf16 product's gradient on the card (cuBLAS forward, its own
        # backward) against the CPU branch's autograd, on values whose float32
        # products and sums are exact, at the vocab projection's shape
        g = torch.Generator().manual_seed(4)
        x = torch.randint(-8, 9, (256, hidden), generator=g) / 4
        w = torch.randint(-8, 9, (hidden, spec.padded_vocab_size), generator=g) / 4
        cot = torch.randint(-16, 17, (256, spec.padded_vocab_size), generator=g) / 8
        outs = []
        for dev in (device, "cpu"):
            xa, wa = x.to(dev).requires_grad_(True), w.to(dev).requires_grad_(True)
            with torch.enable_grad():
                y = vdot(xa, wa, torch.bfloat16)
                outs.append([t.cpu() for t in (y,) + torch.autograd.grad(
                    y, (xa, wa), cot.to(dev))])
        check(all(torch.equal(a, c) for a, c in zip(*outs)),
              "bf16 vdot or its gradient differs, card vs CPU")
        result["bf16_vdot_grad_card_eq_cpu"] = True

    # times: the whole step and its parts, then each kernel's forward against
    # its backward recompute, at this family's batch
    result["timing"] = step_timing(train, params, state, batch, opt)
    xs = batch["vid_feats"].transpose(0, 1)
    cots = torch.randn((frames, b, hidden), generator=gen, device=device)
    zeros = torch.zeros((b, hidden), device=device)
    if s2vt_family:
        rnn = params["rnn1"]
        x_gates = (vdot(xs.reshape(-1, xs.shape[-1]), rnn["w_ih"], cd)
                   + rnn["b_ih"]).reshape(frames, b, 3 * hidden).to(cd).detach()
        kernel_args = (x_gates, rnn["w_hh"].detach().to(cd), rnn["b_hh"].detach(), zeros, cd)
        seq = sequence_fwd_bwd_ms(
            lambda: cuda_gru.gru_sequence_fused(rnn, xs, compute_dtype=cd)[0],
            kernel_args, cuda_gru.gru_recurrence_cuda, list(rnn.values()), cots)
        result["gru_seq_encoder"] = seq
    else:
        rnn = params["gen"]["rnn"]["fwd"]
        x_gates = (vdot(xs.reshape(-1, xs.shape[-1]), rnn["w_ih"], cd)
                   + rnn["b_ih"]).reshape(frames, b, 4 * hidden).to(cd).detach()
        kernel_args = (x_gates, rnn["w_hh"].detach().to(cd), rnn["b_hh"].detach(), zeros,
                       zeros, cd, False)
        seq = sequence_fwd_bwd_ms(
            lambda: cuda_lstm.lstm_sequence_fused(rnn, xs, compute_dtype=cd)[0],
            kernel_args, cuda_lstm.lstm_recurrence_cuda, list(rnn.values()), cots)
        result["lstm_seq_forward_direction"] = seq
    emit(f"train_{family}", **result, nvidia_smi=smi)
    return result


def write_corpus(root, n_words, glove_dim, n_train, n_val, frames, feat_dim, seed):
    """A corpus in the layout the pipeline reads (msvd_vgg under ``root``):
    a GloVe file (glove.txt) of ``n_words`` random words, two captions of
    5-19 of those words per video, and (frames, feat_dim) float32 features
    per video, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    cdir = os.path.join(root, "msvd_vgg")
    os.makedirs(os.path.join(cdir, "glove"))
    os.makedirs(os.path.join(cdir, "feats"))
    words = [f"w{i}" for i in range(n_words)]
    vecs = rng.standard_normal((n_words, glove_dim)).astype(np.float32)
    with open(os.path.join(cdir, "glove", "glove.txt"), "w") as f:
        f.writelines(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n"
                     for w, v in zip(words, vecs))
    for split, n in (("train", n_train), ("val", n_val)):
        samples = []
        for i in range(n):
            key = f"{split}{i}"
            caps = [{"desc": " ".join(rng.choice(words, size=rng.integers(5, 20)))}
                    for _ in range(2)]
            samples.append({"video_key": key, "captions": caps})
            np.save(os.path.join(cdir, "feats", key + ".npy"),
                    rng.standard_normal((frames, feat_dim), dtype=np.float32))
        with open(os.path.join(cdir, f"{split}_captions.json"), "w") as f:
            json.dump(samples, f)
    return ["--data_dir", root, "--corpus", "msvd_vgg", "--glove_emb_file", "glove.txt"]


def cli_phase(cuda_gru, cuda_lstm, smi):
    """Phase 7: the command line at full width, resume, its times, and
    float32 card against CPU on a tiny corpus."""
    from vcr_tpu_torch import cli, tools
    from vcr_tpu_torch.config import Config
    from vcr_tpu_torch.train import checkpoint, loop, optim

    def run(argv):
        """cli.main(argv), the counts set to 0 just before and read just
        after -> (result, counts, its standard output)."""
        out = io.StringIO()
        reset_counts(cuda_gru, cuda_lstm)
        try:
            with contextlib.redirect_stdout(out):
                result = cli.main(argv)
        except BaseException:
            print(out.getvalue()[-4000:], file=sys.stderr)
            raise
        torch.cuda.synchronize()
        return result, launch_counts(cuda_gru, cuda_lstm), out.getvalue()

    def expect(b1, b2=0):
        return {"gru_seq": b1, "gru_seq_bt": 0, "gru_seq_dma": 0, "gru_seq_tc": b1,
                "gru_seq_dma_tc": 0, "lstm_seq": b2, "lstm_seq_tc": b2}

    def batches(n, b):
        return -(-n // b)

    def check_captions(path, n):
        with open(os.path.join(path, "captions.json")) as f:
            caps = json.load(f)
        check(len(caps) == n and {c["vid_key"] for c in caps} == {f"val{i}" for i in
                                                                  range(n)}
              and all(len(c["tokens"]) == 20 for c in caps),
              f"{path}/captions.json: {len(caps)} captions for {n} val videos")
        return caps

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data = write_corpus(os.path.join(tmp, "full"), CLI_WORDS, 300, CLI_TRAIN_VIDEOS,
                            CLI_VAL_VIDEOS, 30, 4096, seed=7)
        corpus_s = time.perf_counter() - t0
        model = ["--num_frames", "30", "--vid_feat_size", "4096", "--max_len", "20",
                 "--hidden_size", "512", "--compute_dtype", "bfloat16",
                 "--vocab_pad_to", "128", "--log_dir", ""]
        s2vt_dir, rat_dir = os.path.join(tmp, "s2vt"), os.path.join(tmp, "rationale")
        steps, val_batches = (batches(CLI_TRAIN_VIDEOS, CLI_BATCH),
                              batches(CLI_VAL_VIDEOS, CLI_BATCH))
        bsize = ["--bsize", str(CLI_BATCH)]

        t0 = time.perf_counter()
        train, launches["train"], _ = run(
            data + model + bsize + ["--mode", "train", "--save_path", s2vt_dir,
                                    "--epochs", "2", "--beam_size", str(CLI_BEAM)])
        train_s = time.perf_counter() - t0
        # per epoch: each step, then each val batch's greedy eval step and beam
        want = expect(2 * (2 * steps + (2 + 2) * val_batches))
        check(launches["train"] == want,
              f"--mode train launched {launches['train']}, not {want}")
        check(math.isfinite(train["loss"]) and all(
            checkpoint.checkpoint_exists(os.path.join(s2vt_dir, name))
            for name in ("model_latest", "model_best")),
              f"--mode train: loss {train['loss']}, or a checkpoint missing")

        evaluation, launches["eval"], _ = run(
            data + bsize + ["--mode", "eval", "--save_path", s2vt_dir,
                            "--beam_size", str(CLI_BEAM)])
        want = expect((2 + 2) * val_batches)
        check(launches["eval"] == want, f"--mode eval launched {launches['eval']}, "
                                        f"not {want}")
        check(math.isfinite(evaluation["loss"]), f"eval loss {evaluation['loss']}")
        for beam in (CLI_BEAM, 1):
            _, launches[f"decode_beam{beam}"], _ = run(
                data + bsize + ["--mode", "decode", "--save_path", s2vt_dir,
                                "--beam_size", str(beam)])
            want = expect(2 * val_batches)
            check(launches[f"decode_beam{beam}"] == want,
                  f"--mode decode --beam_size {beam} launched "
                  f"{launches[f'decode_beam{beam}']}, not {want}")
            check_captions(s2vt_dir, CLI_VAL_VIDEOS)

        rsteps, rval = (batches(CLI_TRAIN_VIDEOS, CLI_RATIONALE_BATCH),
                        batches(CLI_VAL_VIDEOS, CLI_RATIONALE_BATCH))
        # the warm start: restore_into recurses through the module's name, so
        # its outermost call, the caption net's, is recorded last
        restore, restored = checkpoint.restore_into, []

        def recording(params, saved):
            restore(params, saved)
            if isinstance(params, dict):
                restored.append(copy_params(params, "cpu"))

        checkpoint.restore_into = recording
        try:
            rationale_train, launches["train_rationale"], out = run(
                data + model + ["--mode", "train_rationale", "--save_path", rat_dir,
                                "--bsize", str(CLI_RATIONALE_BATCH), "--epochs", "1",
                                "--pretrained_base", os.path.join(s2vt_dir, "model_best")])
        finally:
            checkpoint.restore_into = restore
        want = expect(2 * (rsteps + rval), 2 * (rsteps + rval))
        check(launches["train_rationale"] == want,
              f"--mode train_rationale launched {launches['train_rationale']}, not {want}")
        base = checkpoint.load_checkpoint(checkpoint.best_path(s2vt_dir), "cpu")[0]
        check(bool(restored) and optim.trainable_leaves(restored[-1])[0]
              == optim.trainable_leaves(base)[0]
              and all(torch.equal(x, y) for x, y in zip(
                  optim.trainable_leaves(restored[-1])[1], optim.trainable_leaves(base)[1])),
              "train_rationale: the caption net did not start as S2VT's model_best")
        check("Loaded pretrained base" in out and math.isfinite(rationale_train["loss"])
              and checkpoint.checkpoint_exists(os.path.join(rat_dir, "model_latest")),
              "train_rationale: no warm start, a non-finite loss or no checkpoint")

        # resume adopts the saved config (epochs 2, both done): it loads and
        # trains nothing more
        resumed, launches["resume"], out = run(
            data + ["--mode", "train", "--save_path", s2vt_dir, "--resume", "true"])
        check("Resuming training from previous checkpoint" in out and resumed == {}
              and launches["resume"] == expect(0),
              f"--resume true: {launches['resume']}, result {resumed}")
        saved, saved_opt, _ = checkpoint.load_checkpoint(
            checkpoint.latest_path(s2vt_dir), "cpu")
        params = copy_params(saved, "cuda")
        for leaf in optim.trainable_leaves(params)[1]:
            leaf.detach().zero_()
        opt_state = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0).init(params)
        checkpoint.CheckpointManager(s2vt_dir).try_resume(params, opt_state)
        moments = [v for st in opt_state.optimizer.state_dict()["state"].values()
                   for k, v in st.items() if k != "step"]
        want_moments = [v for st in saved_opt["state"].values()
                        for k, v in st.items() if k != "step"]
        check(len(moments) == len(want_moments) > 0
              and all(m.is_cuda and torch.equal(m.cpu(), w)
                      for m, w in zip(moments, want_moments))
              and all(torch.equal(x.cpu(), y) for x, y in zip(
                  optim.trainable_leaves(params)[1], optim.trainable_leaves(saved)[1])),
              "resume: the Adam state or the parameters did not come back onto the card")

        # what the loop's step interval holds at this shape: the input
        # pipeline alone (one epoch of the train split on the host, the page
        # cache warm), one batch's copy to the card, and the train step
        # alone on that batch (CUDA events), with the flagship's random weights
        from vcr_tpu_torch import entry
        from vcr_tpu_torch.train import step as train_step_mod

        pipe_cfg = Config(data_dir=data[1], glove_emb_file="glove.txt", bsize=CLI_BATCH)
        train_it, _ = loop.make_datasets(pipe_cfg, loop.load_vocab(pipe_cfg))
        t0 = time.perf_counter()
        host_batches = list(train_it)
        pipeline_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        copy_ms = time_ms(lambda: train_step_mod.device_batch(host_batches[0], "cuda"))
        fspec, fparams = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
        fopt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
        fstate = fopt.init(fparams)
        ftrain, _ = train_step_mod.build_step_fns("s2vt", fspec, fopt, static_tf=1.0,
                                                   device="cuda")
        staged = train_step_mod.device_batch(host_batches[0], "cuda")
        step_ms = time_ms(lambda: ftrain(fparams, fstate, staged, 0, 1.0))

        # times: decode_corpus's decode at beam 1 and beam 5, best of 3
        cfg, params, spec, vocab = tools.load_inference_state(
            Config(data_dir=data[1], glove_emb_file="glove.txt", save_path=s2vt_dir),
            "", "cuda")
        feats, _ = tools.load_split_features(cfg, vocab)
        decode_rate = {}
        for beam in (1, CLI_BEAM):
            tools.decode_features(params, spec, vocab.eos_id, feats, CLI_BATCH, beam,
                                  device="cuda")
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                tools.decode_features(params, spec, vocab.eos_id, feats, CLI_BATCH, beam,
                                      device="cuda")
                best = min(best, time.perf_counter() - t0)
            decode_rate[beam] = len(feats) / best

        # float32 on the card against the CPU, on a tiny corpus
        tiny = write_corpus(os.path.join(tmp, "tiny"), 20, 16, 6, 3, 4, 12, seed=3)
        per_device, record = {}, []
        evaluate = loop.evaluate

        def recording(*args, **kw):
            result = evaluate(*args, **kw)
            record.append(result[0])
            return result

        loop.evaluate = recording
        try:
            for device in ("cuda", "cpu"):
                record.clear()
                save = os.path.join(tmp, f"tiny_{device}")
                run(tiny + ["--mode", "train", "--save_path", save, "--num_frames", "4",
                            "--vid_feat_size", "12", "--max_len", "6", "--hidden_size",
                            "16", "--bsize", "4", "--epochs", "2", "--beam_size", "3",
                            "--compute_dtype", "float32", "--dropout_p", "0",
                            "--log_dir", "", "--lr", "1e-2", "--device", device])
                epochs = [{k: m[k] for k in ("METEOR", "BLEU4", "CIDEr")} for m in record]
                caps, _, _ = run(tiny + ["--mode", "decode", "--save_path", save,
                                         "--beam_size", "3", "--device", device])
                tree = checkpoint.load_checkpoint(checkpoint.latest_path(save), "cpu")[0]
                per_device[device] = (epochs, caps, tree)
        finally:
            loop.evaluate = evaluate
        (card_epochs, card_caps, card_tree), (cpu_epochs, cpu_caps, cpu_tree) = (
            per_device["cuda"], per_device["cpu"])
        paths, card_leaves = optim.trainable_leaves(card_tree)
        param_err = max((x - y).abs().max().item() / max(1.0, y.abs().max().item())
                        for x, y in zip(card_leaves, optim.trainable_leaves(cpu_tree)[1]))
        check(len(card_epochs) == 2 and card_epochs == cpu_epochs,
              f"float32 validation metrics card {card_epochs} vs CPU {cpu_epochs}")
        check([c["tokens"] for c in card_caps] == [c["tokens"] for c in cpu_caps],
              "float32 captions differ, card vs CPU")
        check(param_err <= CLI_PARAM_TOL,
              f"float32 parameters card vs CPU: relative err {param_err}")

    emit("cli_path", corpus_seconds=corpus_s, train_seconds=train_s,
         videos={"train": CLI_TRAIN_VIDEOS, "val": CLI_VAL_VIDEOS},
         vocab=spec.vocab_size, padded_vocab=spec.padded_vocab_size,
         launches=launches, train_loss=train["loss"], eval_metrics={
             k: evaluation[k] for k in ("loss", "acc", "METEOR", "BLEU4", "CIDEr")},
         rationale_loss=rationale_train["loss"], resume_adam_on_card=True,
         f32_val_metrics_card_eq_cpu=card_epochs, f32_captions_card_eq_cpu=True,
         f32_param_rel_err=param_err, f32_param_tolerance=CLI_PARAM_TOL)
    # 2 batches an epoch and the timer reset each epoch: the loop's StepTimer
    # holds one interval, so this is one reading, not a median
    emit("cli_train_step", batch=CLI_BATCH, step_ms_one_interval=train["perf/step_ms_p50"],
         steps_timed=train["perf/steps"], input_pipeline_ms_per_batch=pipeline_ms,
         copy_to_card_ms=copy_ms, train_step_alone_ms=step_ms,
         nworkers=pipe_cfg.nworkers, nvidia_smi=smi)
    emit("cli_eval", batch=CLI_BATCH, beam=CLI_BEAM, videos=CLI_VAL_VIDEOS,
         decode_seconds=evaluation["eval_decode_s"],
         host_metrics_seconds=evaluation["eval_host_metrics_s"], nvidia_smi=smi)
    for beam, rate in decode_rate.items():
        emit("cli_decode", beam=beam, batch=CLI_BATCH, videos=len(feats),
             captions_per_s=rate, nvidia_smi=smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2

    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import rationale, s2vt
    from vcr_tpu_torch.nn.layers import vdot
    from vcr_tpu_torch.ops import cuda_gru, cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    check(kind == CARD, f"peaks are recorded for {CARD!r} only, not {kind!r}")
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for built in [pool.submit(lib) for lib in
                      (cuda_gru._lib, cuda_gru._dma_lib, cuda_lstm._lib)]:
            built.result()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         kernels=["gru_seq", "gru_seq_dma", "lstm_seq"])

    # 3. kernels against their plain versions on the card
    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
    hidden, frames = spec.hidden_size, spec.num_frames

    g = torch.Generator(device="cuda").manual_seed(1)
    xa = torch.randn((SMOKE_BATCH, spec.vid_feat_size), generator=g, device="cuda")
    wa = params["rnn1"]["w_ih"]
    vdot_err = (vdot(xa, wa) - xa.bfloat16().float() @ wa.bfloat16().float()
                ).abs().max().item()
    check(vdot_err <= 1e-3, f"bf16 vdot with a float32 result: err {vdot_err}")

    # the tensor-core body's geometry (bf16 B1 and B3 at this hidden size)
    max_clusters = {layout: cuda_gru.tc_max_clusters(hidden, time_major)
                    for layout, time_major in (("time_major", True),
                                               ("batch_major", False))}
    check(min(max_clusters.values()) >= 1,
          f"the card holds no cluster of the tensor-core GRU body: {max_clusters}")
    emit("tc_geometry", hidden=hidden, cluster=cuda_gru.TC_CLUSTER,
         max_active_clusters=max_clusters,
         smem_bytes_per_cta=cuda_gru.tc_smem_bytes(hidden),
         plans={b: dict(zip(("cluster", "clusters", "rows_per_cluster", "chunk"),
                            cuda_gru.tc_plan(b, hidden, torch.bfloat16,
                                             max_clusters["time_major"])))
                for b in (1, 3, 17, SMOKE_BATCH, RATIONALE_BATCH, TIMING_BATCH)})
    # the tensor-core LSTM body's geometry (bf16 B2 at this hidden size)
    lstm_max_clusters = cuda_lstm.tc_max_clusters(hidden)
    check(lstm_max_clusters >= 1,
          f"the card holds no cluster of the tensor-core LSTM body: {lstm_max_clusters}")
    emit("lstm_tc_geometry", hidden=hidden, cluster=cuda_lstm.TC_CLUSTER,
         max_active_clusters=lstm_max_clusters,
         smem_bytes_per_cta=cuda_lstm.tc_smem_bytes(hidden),
         plans={b: dict(zip(("cluster", "clusters", "rows_per_cluster", "chunk"),
                            cuda_lstm.tc_plan(b, hidden, torch.bfloat16,
                                              lstm_max_clusters)))
                for b in (1, 3, 17, SMOKE_BATCH, RATIONALE_BATCH)})
    # B4's tensor-core body: one CTA per SM, a copy ring per warp
    dma_max_clusters = cuda_gru.dma_tc_max_clusters(hidden)
    check(dma_max_clusters >= 1,
          f"the card holds no cluster of B4's tensor-core body: {dma_max_clusters}")
    dma_plans = {b: cuda_gru.dma_tc_plan(b, hidden, torch.bfloat16, dma_max_clusters)
                 for b in (1, 3, 17, SMOKE_BATCH, RATIONALE_BATCH, TIMING_BATCH)}
    check(all(dma_plans.values()), f"B4's tensor-core plan refuses a checked batch: "
                                   f"{dma_plans}")
    dma_geometry = {
        "hidden": hidden, "cluster": cuda_gru.TC_CLUSTER,
        "max_active_clusters": dma_max_clusters, "warps": cuda_gru.DMA_TC_WARPS,
        "slots": cuda_gru.DMA_TC_SLOTS,
        "plans": {b: dict(zip(("cluster", "clusters", "rows_per_cluster", "chunk",
                               "warps", "slots"), plan))
                  | {"smem_bytes_per_cta": cuda_gru.dma_tc_smem_bytes(
                         hidden, plan[2] // cuda_gru.TC_CHUNK)}
                  for b, plan in dma_plans.items()}}
    emit("dma_tc_geometry", **dma_geometry)

    # every case is run and printed before any is checked, so a failing
    # run still shows all the errors. B1, B3 and B4 on the same inputs: B3 is
    # B1's body in the batch-major layout, and bf16 B4 runs B1's product and
    # gate math in B1's order, so both must equal B1 exactly; float32 B4
    # keeps its own scalar arithmetic and is held to the plain version.
    # T=1 has no copy ahead and one drain.
    cases, variant_cases, failures = [], [], []
    bt_equal = dma_twice_equal = dma_bf16_eq_b1 = True
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        shapes = [(frames, b) for b in (SMOKE_BATCH, 1, 3, 17)] + [(1, 17)]
        if dtype == torch.bfloat16:
            shapes += [(steps, b) for b in (RATIONALE_BATCH, TIMING_BATCH)
                       for steps in (frames, 1)]
        name = str(dtype).split(".")[-1]
        for steps, b in shapes:
            args = gru_inputs(steps, b, hidden, dtype, seed=b)
            want = cuda_gru.gru_recurrence_plain(*args, dtype)
            tc_before = cuda_gru.launches_tc
            b1 = cuda_gru.gru_recurrence_cuda(*args, dtype)
            tc_launched = cuda_gru.launches_tc - tc_before
            x_bt = args[0].transpose(0, 1).contiguous()
            dma_tc_before = cuda_gru.launches_dma_tc
            got = {"gru_seq_bt": cuda_gru.gru_recurrence_bt_cuda(
                       x_bt, *args[1:], dtype).transpose(0, 1),
                   "gru_seq_dma": cuda_gru.gru_recurrence_dma_cuda(*args, dtype)}
            dma_tc_launched = cuda_gru.launches_dma_tc - dma_tc_before
            again = cuda_gru.gru_recurrence_dma_cuda(*args, dtype)
            torch.cuda.synchronize()
            err = max_err(b1, want)
            cases.append({"dtype": name, "steps": steps, "batch": b,
                          "body": "tensor-core" if tc_launched else "scalar",
                          "max_abs_err": err, "tolerance": tol})
            if not (all_finite(b1) and err <= tol):
                failures.append(f"gru_seq kernel vs plain, {dtype} T={steps} B={b}: "
                                f"err {err} > {tol}")
            if tc_launched != int(dtype == torch.bfloat16):
                failures.append(f"gru_seq {dtype} at H={hidden} ran the "
                                f"{'tensor-core' if tc_launched else 'scalar'} body")
            for kernel, out in got.items():
                err = max_err(out, want)
                variant_cases.append({"kernel": kernel, "dtype": name, "steps": steps,
                                      "batch": b, "max_abs_err": err,
                                      "vs_b1_max_abs_err": max_err(out, b1),
                                      "tolerance": tol})
                if kernel == "gru_seq_dma":
                    variant_cases[-1]["body"] = ("tensor-core" if dma_tc_launched
                                                 else "scalar")
                if not (all_finite(out) and err <= tol):
                    failures.append(f"{kernel} kernel vs plain, {dtype} T={steps} B={b}: "
                                    f"err {err} > {tol}")
            if not torch.equal(got["gru_seq_bt"], b1):
                bt_equal = False
                failures.append(f"gru_seq_bt differs from gru_seq, {dtype} T={steps} B={b}")
            if not torch.equal(again, got["gru_seq_dma"]):
                dma_twice_equal = False
                failures.append(f"gru_seq_dma gave two outputs on one input, {dtype} "
                                f"T={steps} B={b}")
            if dma_tc_launched != int(dtype == torch.bfloat16):
                failures.append(f"gru_seq_dma {dtype} at H={hidden} B={b} ran the "
                                f"{'tensor-core' if dma_tc_launched else 'scalar'} body")
            if dtype == torch.bfloat16 and not torch.equal(got["gru_seq_dma"], b1):
                dma_bf16_eq_b1 = False
                failures.append(f"bf16 gru_seq_dma differs from gru_seq, T={steps} B={b}")
    # B2: bf16 runs the tensor-core body, twice per case, since a missing
    # cluster barrier shows only on some runs; float32 the scalar body
    lstm_cases = []
    lstm_twice_equal = True
    for dtype, tol in ((torch.bfloat16, LSTM_BF16_TOL), (torch.float32, LSTM_F32_TOL)):
        bf16 = dtype == torch.bfloat16
        for reverse in (False, True):
            for steps, b in [(frames, b) for b in (SMOKE_BATCH, 1, 3, 17, RATIONALE_BATCH)
                             ] + [(1, 17)]:
                args = lstm_inputs(steps, b, hidden, dtype, seed=b)
                tc_before = cuda_lstm.launches_tc
                got = cuda_lstm.lstm_recurrence_cuda(*args, dtype, reverse)
                tc_launched = cuda_lstm.launches_tc - tc_before
                again = cuda_lstm.lstm_recurrence_cuda(*args, dtype, reverse) if bf16 else got
                want = cuda_lstm.lstm_recurrence_plain(*args, dtype, reverse)
                torch.cuda.synchronize()
                err = max_err(got, want)  # outs and c_last
                twice = all(torch.equal(x, y) for x, y in zip(got, again))
                lstm_cases.append({"dtype": str(dtype).split(".")[-1], "steps": steps,
                                   "batch": b, "reverse": reverse,
                                   "body": "tensor-core" if tc_launched else "scalar",
                                   "max_abs_err": err, "tolerance": tol,
                                   "twice_equal": twice})
                if not (all_finite(got) and err <= tol):
                    failures.append(f"lstm_seq kernel vs plain, {dtype} T={steps} B={b} "
                                    f"reverse={reverse}: err {err} > {tol}")
                if tc_launched != int(bf16):
                    failures.append(f"lstm_seq {dtype} at H={hidden} ran the "
                                    f"{'tensor-core' if tc_launched else 'scalar'} body")
                if not twice:
                    lstm_twice_equal = False
                    failures.append(f"lstm_seq gave two outputs on one input, {dtype} "
                                    f"T={steps} B={b} reverse={reverse}")
    dma_tiles = {str(dtype).split(".")[-1]: cuda_gru.dma_batch_tile(hidden, dtype)
                 for dtype in (torch.bfloat16, torch.float32)}
    # controls: the float32 plain version (h never rounded to bf16) on the
    # bf16 inputs must miss the bf16 limit, or the limit could not see that
    # fault
    args = gru_inputs(frames, SMOKE_BATCH, hidden, torch.bfloat16, seed=SMOKE_BATCH)
    control_err = max_err(cuda_gru.gru_recurrence_plain(*args, torch.float32),
                          cuda_gru.gru_recurrence_plain(*args, torch.bfloat16))
    if control_err <= BF16_TOL:
        failures.append(f"bf16 limit {BF16_TOL} does not catch an unrounded h "
                        f"in B1: err {control_err}")
    args = lstm_inputs(frames, SMOKE_BATCH, hidden, torch.bfloat16, seed=SMOKE_BATCH)
    lstm_control_err = max_err(cuda_lstm.lstm_recurrence_plain(*args, torch.float32),
                               cuda_lstm.lstm_recurrence_plain(*args, torch.bfloat16))
    if lstm_control_err <= LSTM_BF16_TOL:
        failures.append(f"bf16 limit {LSTM_BF16_TOL} does not catch an unrounded h "
                        f"in B2: err {lstm_control_err}")
    emit("kernels_vs_plain", vdot_bf16_err=vdot_err, gru_seq=cases,
         bf16_control_err=control_err, lstm_seq=lstm_cases,
         lstm_bf16_control_err=lstm_control_err, lstm_seq_twice_equal=lstm_twice_equal,
         gru_variants=variant_cases,
         gru_seq_bt_eq_gru_seq=bt_equal, gru_seq_dma_bf16_eq_gru_seq=dma_bf16_eq_b1,
         gru_seq_dma_twice_equal=dma_twice_equal, gru_seq_dma_batch_tile=dma_tiles,
         gru_seq_dma_blocks={k: -(-TIMING_BATCH // v) for k, v in dma_tiles.items()},
         gru_seq_dma_blocks_batch=TIMING_BATCH)
    check(not failures, "; ".join(failures))

    # 4. the main path: counts set to 0 just before, read just after
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal(
        (SMOKE_BATCH, frames, spec.vid_feat_size)).astype(np.float32)).cuda()
    caption = serving.build_captioner(params, spec, featurizer="none")
    reset_counts(cuda_gru, cuda_lstm)
    tokens = caption(feats)
    torch.cuda.synchronize()
    main_launches = launch_counts(cuda_gru, cuda_lstm)
    check(tuple(tokens.shape) == (SMOKE_BATCH, spec.max_len)
          and tokens.dtype == torch.int32,
          f"tokens {tuple(tokens.shape)} {tokens.dtype}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < spec.vocab_size,
          "token outside the vocabulary")
    check(main_launches == {"gru_seq": 2, "gru_seq_bt": 0, "gru_seq_dma": 0,
                            "gru_seq_tc": 2, "gru_seq_dma_tc": 0, "lstm_seq": 0,
                            "lstm_seq_tc": 0},
          f"the S2VT captioner launched {main_launches}, not B1 twice on the "
          "tensor-core body and nothing else")

    spec32 = spec.with_(compute_dtype="float32")
    few = feats[:4]
    on_card = serving.build_captioner(params, spec32)(few).cpu()
    on_cpu = serving.build_captioner(params, spec32, device="cpu")(few.cpu())
    with torch.inference_mode():
        logits_card = s2vt.apply(params, spec32, few, emit="logits").cpu()
        logits_cpu = s2vt.apply(params_to(params, "cpu"), spec32,
                                few.cpu(), emit="logits")
    logit_err = (logits_card - logits_cpu).abs().max().item()
    check(torch.equal(on_card, on_cpu), "float32 tokens differ, card vs CPU")
    check(bool(torch.isfinite(logits_card).all()) and logit_err <= LOGIT_TOL,
          f"float32 logits card vs CPU: err {logit_err}")
    emit("main_path", batch=SMOKE_BATCH, tokens_shape=list(tokens.shape),
         tokens_dtype="int32", launches=main_launches,
         f32_tokens_card_eq_cpu=True, f32_logits_max_abs_err=logit_err)

    # 4b. the RationaleNet path: counts set to 0 just before, read just after
    rspec, rparams = entry.make_spec_and_params(**entry.RATIONALE, device="cuda")
    rcaption = serving.build_captioner(rparams, rspec, featurizer="none")
    reset_counts(cuda_gru, cuda_lstm)
    rtokens = rcaption(feats)
    torch.cuda.synchronize()
    rationale_launches = launch_counts(cuda_gru, cuda_lstm)
    check(tuple(rtokens.shape) == (SMOKE_BATCH, rspec.max_len)
          and rtokens.dtype == torch.int32,
          f"rationale tokens {tuple(rtokens.shape)} {rtokens.dtype}")
    check(int(rtokens.min()) >= 0 and int(rtokens.max()) < rspec.vocab_size,
          "rationale token outside the vocabulary")
    check(rationale_launches == {"gru_seq": 2, "gru_seq_bt": 0, "gru_seq_dma": 0,
                                 "gru_seq_tc": 2, "gru_seq_dma_tc": 0, "lstm_seq": 2,
                                 "lstm_seq_tc": 2},
          f"the rationale captioner launched {rationale_launches}, not B2 and B1 "
          "twice each (both on their tensor-core bodies) and nothing else")
    with torch.inference_mode():
        # the captioner's own selection: the same default rng
        again, probs = rationale.apply(rparams, rspec, feats, emit="tokens")
    share = probs[..., 1].mean().item()
    check(torch.equal(again, rtokens), "rationale.apply and its captioner disagree")
    check(0.0 < share < 1.0, f"share of frames selected {share}, not in (0, 1)")

    rspec32 = rspec.with_(compute_dtype="float32")
    noise = torch.from_numpy(np.random.default_rng(2).gumbel(
        size=(4, frames, 2)).astype(np.float32))
    rparams_cpu = params_to(rparams, "cpu")
    with torch.inference_mode():
        rlogits_card, rprobs_card = rationale.apply(rparams, rspec32, few,
                                                    gumbel_noise=noise.cuda())
        rlogits_cpu, rprobs_cpu = rationale.apply(rparams_cpu, rspec32, few.cpu(),
                                                  gumbel_noise=noise)
        rtok_card, _ = rationale.apply(rparams, rspec32, few, emit="tokens",
                                       gumbel_noise=noise.cuda())
        rtok_cpu, _ = rationale.apply(rparams_cpu, rspec32, few.cpu(), emit="tokens",
                                      gumbel_noise=noise)
    rlogit_err = (rlogits_card.cpu() - rlogits_cpu).abs().max().item()
    check(torch.equal(rprobs_card.cpu(), rprobs_cpu),
          "float32 frame selection differs, card vs CPU")
    check(torch.equal(rtok_card.cpu(), rtok_cpu),
          "float32 rationale tokens differ, card vs CPU")
    check(bool(torch.isfinite(rlogits_card).all()) and rlogit_err <= LOGIT_TOL,
          f"float32 rationale logits card vs CPU: err {rlogit_err}")
    emit("rationale_path", batch=SMOKE_BATCH, tokens_shape=list(rtokens.shape),
         tokens_dtype="int32", launches=rationale_launches,
         frames_selected_share=share, f32_probs_card_eq_cpu=True,
         f32_tokens_card_eq_cpu=True, f32_logits_max_abs_err=rlogit_err,
         f32_frames_selected_share=rprobs_cpu[..., 1].mean().item())

    # 4c. the GRU drop-ins on the flagship encoder's own weights and features:
    # counts set to 0 just before each call, read just after
    cd = spec.cdtype
    rnn1 = params["rnn1"]
    with torch.inference_mode():
        vf = feats.to(cd)
        enc_outs, enc_last = s2vt.encode(params, spec, vf)  # B1, (N, B, H)
        reset_counts(cuda_gru, cuda_lstm)
        bt_outs, bt_last = cuda_gru.gru_sequence_fused_bt(rnn1, vf, compute_dtype=cd)
        torch.cuda.synchronize()
        bt_launches = launch_counts(cuda_gru, cuda_lstm)
        reset_counts(cuda_gru, cuda_lstm)
        dma_outs, dma_last = cuda_gru.gru_sequence_fused_dma(
            rnn1, vf.transpose(0, 1), compute_dtype=cd)
        torch.cuda.synchronize()
        dma_launches = launch_counts(cuda_gru, cuda_lstm)
    check(bt_launches == {"gru_seq": 0, "gru_seq_bt": 1, "gru_seq_dma": 0, "gru_seq_tc": 1,
                          "gru_seq_dma_tc": 0, "lstm_seq": 0, "lstm_seq_tc": 0},
          f"gru_sequence_fused_bt launched {bt_launches}, not B3 once on the "
          "tensor-core body and nothing else")
    check(dma_launches == {"gru_seq": 0, "gru_seq_bt": 0, "gru_seq_dma": 1, "gru_seq_tc": 0,
                           "gru_seq_dma_tc": 1, "lstm_seq": 0, "lstm_seq_tc": 0},
          f"gru_sequence_fused_dma launched {dma_launches}, not B4 once on its "
          "tensor-core body and nothing else")
    check(tuple(bt_outs.shape) == (SMOKE_BATCH, frames, hidden)
          and tuple(dma_outs.shape) == (frames, SMOKE_BATCH, hidden),
          f"drop-in outputs {tuple(bt_outs.shape)} and {tuple(dma_outs.shape)}")
    bt_enc_err = max_err((bt_outs.transpose(0, 1), bt_last), (enc_outs, enc_last))
    dma_enc_err = max_err((dma_outs, dma_last), (enc_outs, enc_last))
    check(all_finite((bt_outs, dma_outs)) and bt_enc_err <= BF16_TOL
          and dma_enc_err <= BF16_TOL,
          f"drop-ins against s2vt.encode: B3 err {bt_enc_err}, B4 err {dma_enc_err}")
    emit("gru_variants_path", batch=SMOKE_BATCH, frames=frames, hidden=hidden,
         input_size=spec.vid_feat_size, launches_bt=bt_launches,
         launches_dma=dma_launches, bt_vs_encode_max_abs_err=bt_enc_err,
         dma_vs_encode_max_abs_err=dma_enc_err, tolerance=BF16_TOL)

    # 5. timing at the flagship serving batch
    feats = torch.from_numpy(rng.standard_normal(
        (TIMING_BATCH, frames, spec.vid_feat_size)).astype(np.float32)).cuda()
    caption_ms = time_ms(lambda: caption(feats))
    # yardsticks only, never called by the port: cuDNN's GRU on the same xs,
    # time-major and batch-major, which also does the input projection
    grus = {}
    for batch_first in (False, True):
        gru = torch.nn.GRU(spec.vid_feat_size, hidden,
                           batch_first=batch_first).to("cuda", cd)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(rnn1["w_ih"].t())
            gru.weight_hh_l0.copy_(rnn1["w_hh"].t())
            gru.bias_ih_l0.copy_(rnn1["b_ih"])
            gru.bias_hh_l0.copy_(rnn1["b_hh"])
        gru.flatten_parameters()
        grus[batch_first] = gru
    gru = grus[False]
    with torch.inference_mode():
        vf = feats.to(cd)
        enc_outs, state1 = s2vt.encode(params, spec, vf)
        state2 = s2vt._prime_state2(params, spec, enc_outs)
        stages = {
            "encode_ms": time_ms(lambda: s2vt.encode(params, spec, vf)),
            "prime_ms": time_ms(lambda: s2vt._prime_state2(params, spec, enc_outs)),
            "decode_ms": time_ms(lambda: s2vt.decode_from_states(
                params, spec, state1, state2, emit="tokens")),
        }
        xs = vf.transpose(0, 1).contiguous()
        x_gates = (vdot(xs.reshape(-1, xs.shape[-1]), rnn1["w_ih"], cd)
                   + rnn1["b_ih"]).reshape(frames, TIMING_BATCH, 3 * hidden).to(cd)
        gru_args = (x_gates, rnn1["w_hh"].to(cd).contiguous(), rnn1["b_hh"],
                    torch.zeros((TIMING_BATCH, hidden), device="cuda"), cd)
        # B1, then B3 on the same gates in batch-major layout and B4 on B1's
        # inputs, timed in turns (forward order, then backward) on one card
        bt_args = (x_gates.transpose(0, 1).contiguous(),) + gru_args[1:]
        dma_counts = (cuda_gru.launches_dma, cuda_gru.launches_dma_tc)
        gru_runs = {
            "gru_seq": lambda: cuda_gru.gru_recurrence_cuda(*gru_args),
            "gru_seq_bt": lambda: cuda_gru.gru_recurrence_bt_cuda(*bt_args),
            "gru_seq_dma": lambda: cuda_gru.gru_recurrence_dma_cuda(*gru_args)}
        gru_ms = dict.fromkeys(gru_runs, float("inf"))
        for order in (list(gru_runs), list(gru_runs)[::-1]):
            for name in order:
                gru_ms[name] = min(gru_ms[name], time_ms(gru_runs[name], iters=5))
        kernel_ms, bt_ms, dma_ms = gru_ms.values()
        # B4's plain version is B1's
        plain_ms = time_ms(lambda: cuda_gru.gru_recurrence_plain(*gru_args))
        bt_plain_ms = time_ms(lambda: cuda_gru.gru_recurrence_bt_plain(*bt_args))
        want = cuda_gru.gru_recurrence_plain(*gru_args)
        b1_out = gru_runs["gru_seq"]()
        bt_out = gru_runs["gru_seq_bt"]().transpose(0, 1)
        dma_out = gru_runs["gru_seq_dma"]()
        timed_err, bt_err, dma_err = (max_err(out, want) for out in (b1_out, bt_out, dma_out))
        check(max(timed_err, bt_err, dma_err) <= BF16_TOL,
              f"B1, B3 and B4 at B={TIMING_BATCH}: errs {timed_err}, {bt_err}, {dma_err}")
        library_ms = time_ms(lambda: gru(xs))
        bt_library_ms = time_ms(lambda: grus[True](vf))
        # the input projection alone, which the yardsticks include and the
        # kernels do not
        projection_ms = time_ms(lambda: vdot(xs.reshape(-1, xs.shape[-1]), rnn1["w_ih"], cd))
        # B1 and B4 at RationaleNet's serving batch, on the first rows of the
        # same gates, beside cuDNN and the projection at that batch
        half = RATIONALE_BATCH
        args_half = (x_gates[:, :half].contiguous(),) + gru_args[1:3] + (
            torch.zeros((half, hidden), device="cuda"), cd)
        xs_half = xs[:, :half].contiguous()
        want_half = cuda_gru.gru_recurrence_plain(*args_half)
        half_err = max_err(cuda_gru.gru_recurrence_cuda(*args_half), want_half)
        dma_half_err = max_err(cuda_gru.gru_recurrence_dma_cuda(*args_half), want_half)
        check(max(half_err, dma_half_err) <= BF16_TOL,
              f"B1 and B4 at B={half}: errs {half_err}, {dma_half_err}")
        # B1 and B4 at this batch, in turns
        half_runs = {"gru_seq": lambda: cuda_gru.gru_recurrence_cuda(*args_half),
                     "gru_seq_dma": lambda: cuda_gru.gru_recurrence_dma_cuda(*args_half)}
        half_ms = dict.fromkeys(half_runs, float("inf"))
        for order in (list(half_runs), list(half_runs)[::-1]):
            for name in order:
                half_ms[name] = min(half_ms[name], time_ms(half_runs[name], iters=5))
        b1_half = {"batch": half, "ms": half_ms["gru_seq"],
                   "plain_ms": time_ms(lambda: cuda_gru.gru_recurrence_plain(*args_half)),
                   "library_ms": time_ms(lambda: gru(xs_half)),
                   "projection_ms": time_ms(lambda: vdot(
                       xs_half.reshape(-1, xs_half.shape[-1]), rnn1["w_ih"], cd)),
                   "max_abs_err": half_err}
        dma_half = {**b1_half, "ms": half_ms["gru_seq_dma"], "max_abs_err": dma_half_err}
        # the whole encoder both ways, in turns: feature transpose + projection
        # + B1, against projection + B3 on the features as they come
        encoder = {"transpose_b1_ms": float("inf"), "b3_ms": float("inf")}
        for _ in range(2):
            encoder["transpose_b1_ms"] = min(encoder["transpose_b1_ms"], time_ms(
                lambda: s2vt.encode(params, spec, vf)))
            encoder["b3_ms"] = min(encoder["b3_ms"], time_ms(
                lambda: cuda_gru.gru_sequence_fused_bt(rnn1, vf, compute_dtype=cd)))
    # every B4 launch of this phase ran the tensor-core body
    dma_timed = cuda_gru.launches_dma - dma_counts[0]
    check(cuda_gru.launches_dma_tc - dma_counts[1] == dma_timed > 0,
          f"of {dma_timed} timed B4 launches, "
          f"{cuda_gru.launches_dma_tc - dma_counts[1]} ran the tensor-core body")
    bound_ms, bound_by = gru_bound_ms(frames, TIMING_BATCH, hidden, PEAKS)
    b1_half["bound_ms"], b1_half["bound_by"] = gru_bound_ms(frames, RATIONALE_BATCH,
                                                            hidden, PEAKS)
    dma_half["bound_ms"], dma_half["bound_by"] = b1_half["bound_ms"], b1_half["bound_by"]
    dma_body = {"body": "tensor-core", "plan": dma_geometry["plans"][TIMING_BATCH]}
    emit("timing", batch=TIMING_BATCH, caption_ms=caption_ms,
         captions_per_s=TIMING_BATCH / (caption_ms / 1e3), stages=stages,
         gru_seq={"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "library": "torch.nn.GRU (cuDNN), input projection included",
                  "projection_ms": projection_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err": timed_err, "at_rationale_batch": b1_half},
         gru_seq_bt={"ms": bt_ms, "plain_ms": bt_plain_ms, "library_ms": bt_library_ms,
                     "library": "torch.nn.GRU(batch_first=True) (cuDNN), input "
                                "projection included",
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": bt_err,
                     "vs_b1_max_abs_err": max_err(bt_out, b1_out)},
         gru_seq_dma={"ms": dma_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "library": "torch.nn.GRU (cuDNN), input projection included",
                      "projection_ms": projection_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": dma_err,
                      "vs_b1_max_abs_err": max_err(dma_out, b1_out), **dma_body,
                      "at_rationale_batch": dma_half},
         encoder=encoder, nvidia_smi=smi)

    # 5b. RationaleNet timing at its serving batch
    rfeats = torch.from_numpy(rng.standard_normal(
        (RATIONALE_BATCH, frames, rspec.vid_feat_size)).astype(np.float32)).cuda()
    rationale_ms = time_ms(lambda: rcaption(rfeats))
    gen_params = rparams["gen"]
    # yardstick only, never called by the port: cuDNN's LSTM, one direction,
    # on the same xs, which also does the input projection
    fwd = gen_params["rnn"]["fwd"]
    lstm = torch.nn.LSTM(rspec.vid_feat_size, hidden).to("cuda", cd)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(fwd["w_ih"].t())
        lstm.weight_hh_l0.copy_(fwd["w_hh"].t())
        lstm.bias_ih_l0.copy_(fwd["b_ih"])
        lstm.bias_hh_l0.copy_(fwd["b_hh"])
    lstm.flatten_parameters()
    with torch.inference_mode():
        rvf = rfeats.to(cd)
        sel, _ = rationale.generator(
            gen_params, rspec, rvf, torch.Generator(device="cuda").manual_seed(0))
        rstages = {
            "generator_ms": time_ms(lambda: rationale.generator(
                gen_params, rspec, rvf, torch.Generator(device="cuda").manual_seed(0))),
            "caption_net_ms": time_ms(lambda: s2vt.apply(
                rparams["caption_net"], rspec, sel, emit="tokens")),
        }
        rxs = rvf.transpose(0, 1).contiguous()
        per_direction = {}
        for direction, reverse in (("forward", False), ("backward", True)):
            p = gen_params["rnn"]["bwd" if reverse else "fwd"]
            xg = (vdot(rxs.reshape(-1, rxs.shape[-1]), p["w_ih"], cd)
                  + p["b_ih"]).reshape(frames, RATIONALE_BATCH, 4 * hidden).to(cd)
            zeros = torch.zeros((RATIONALE_BATCH, hidden), device="cuda")
            lstm_args = (xg, p["w_hh"].to(cd).contiguous(), p["b_hh"], zeros, zeros,
                         cd, reverse)
            k_ms = time_ms(lambda: cuda_lstm.lstm_recurrence_cuda(*lstm_args), iters=5)
            p_ms = time_ms(lambda: cuda_lstm.lstm_recurrence_plain(*lstm_args))
            err = max_err(cuda_lstm.lstm_recurrence_cuda(*lstm_args),
                          cuda_lstm.lstm_recurrence_plain(*lstm_args))
            check(err <= LSTM_BF16_TOL,
                  f"lstm_seq {direction} at B={RATIONALE_BATCH}: err {err}")
            per_direction[direction] = {"ms": k_ms, "plain_ms": p_ms, "max_abs_err": err}
        lstm_library_ms = time_ms(lambda: lstm(rxs))
        # the generator's input projection alone (one direction), which the
        # yardstick includes and the kernel does not
        lstm_projection_ms = time_ms(lambda: vdot(rxs.reshape(-1, rxs.shape[-1]),
                                                  fwd["w_ih"], cd))
    lstm_bound, lstm_bound_by = lstm_bound_ms(frames, RATIONALE_BATCH, hidden, PEAKS)
    lstm_ms = sum(d["ms"] for d in per_direction.values()) / 2
    lstm_plain_ms = sum(d["plain_ms"] for d in per_direction.values()) / 2
    emit("timing_rationale", batch=RATIONALE_BATCH, caption_ms=rationale_ms,
         captions_per_s=RATIONALE_BATCH / (rationale_ms / 1e3), stages=rstages,
         lstm_seq={"by_direction": per_direction, "library_ms": lstm_library_ms,
                   "library": "torch.nn.LSTM (cuDNN), one direction, input "
                              "projection included",
                   "projection_ms": lstm_projection_ms,
                   "bound_ms": lstm_bound, "bound_by": lstm_bound_by},
         nvidia_smi=smi)

    # 6. training of both served captioners
    train_s2vt = train_phase("s2vt", cuda_gru, cuda_lstm, smi)
    train_rationale = train_phase("rationale", cuda_gru, cuda_lstm, smi)

    # 7. the command line
    cli_phase(cuda_gru, cuda_lstm, smi)
    backward_route = ("autograd recompute through vcr_tpu_torch/nn/rnn.{} "
                      "(JAX: vcr_tpu/ops/pallas_gru.py:{})")

    def worst(rows, dtype, kernel=None):
        return max(c["max_abs_err"] for c in rows
                   if c["dtype"] == dtype and c.get("kernel") == kernel)

    print(json.dumps({"kernels": [{
        "name": "gru_seq", "route": "cuda",
        "source": "vcr_tpu_torch/ops/csrc/gru_seq.cu",
        "replaces": "vcr_tpu/ops/pallas_gru.py:24",
        "launches": main_launches["gru_seq"],
        "launches_tc": main_launches["gru_seq_tc"],
        "launches_rationale": rationale_launches["gru_seq"],
        "max_abs_err": worst(cases, "bfloat16"), "tolerance": BF16_TOL,
        "f32_max_abs_err": worst(cases, "float32"), "f32_tolerance": F32_TOL,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "projection_ms": projection_ms, "at_rationale_batch": b1_half,
        "train_launches_per_step": {
            "s2vt": train_s2vt["launches_per_step"]["gru_seq"],
            "s2vt_remat": train_s2vt["remat_launches_per_step"]["gru_seq"],
            "rationale": train_rationale["launches_per_step"]["gru_seq"]},
        "backward": {"route": backward_route.format("gru_sequence", "157-164"),
                     "batch": TRAIN_BATCH, **train_s2vt["gru_seq_encoder"]}}, {
        "name": "gru_seq_bt", "route": "cuda",
        "source": "vcr_tpu_torch/ops/csrc/gru_seq.cu",
        "replaces": "vcr_tpu/ops/pallas_gru.py:24",
        "via": "vcr_tpu/ops/pallas_gru.py:297 (time_major=False)",
        "launches": bt_launches["gru_seq_bt"],
        "launches_tc": bt_launches["gru_seq_tc"],
        "max_abs_err": worst(variant_cases, "bfloat16", "gru_seq_bt"),
        "tolerance": BF16_TOL,
        "f32_max_abs_err": worst(variant_cases, "float32", "gru_seq_bt"),
        "f32_tolerance": F32_TOL,
        "ms": bt_ms, "plain_ms": bt_plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": bt_library_ms}, {
        "name": "gru_seq_dma", "route": "cuda",
        "source": "vcr_tpu_torch/ops/csrc/gru_seq_dma.cu",
        "replaces": "vcr_tpu/ops/pallas_gru.py:181",
        "launches": dma_launches["gru_seq_dma"],
        "launches_tc": dma_launches["gru_seq_dma_tc"], **dma_body,
        "max_abs_err": worst(variant_cases, "bfloat16", "gru_seq_dma"),
        "tolerance": BF16_TOL,
        "f32_max_abs_err": worst(variant_cases, "float32", "gru_seq_dma"),
        "f32_tolerance": F32_TOL,
        "ms": dma_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "projection_ms": projection_ms, "at_rationale_batch": dma_half,
        "scalar_batch_tile": dma_tiles}, {
        "name": "lstm_seq", "route": "cuda",
        "source": "vcr_tpu_torch/ops/csrc/lstm_seq.cu",
        "replaces": "vcr_tpu/ops/pallas_gru.py:320",
        "launches": rationale_launches["lstm_seq"],
        "launches_tc": rationale_launches["lstm_seq_tc"],
        "max_abs_err": worst(lstm_cases, "bfloat16"), "tolerance": LSTM_BF16_TOL,
        "f32_max_abs_err": worst(lstm_cases, "float32"),
        "f32_tolerance": LSTM_F32_TOL,
        "ms": lstm_ms, "plain_ms": lstm_plain_ms, "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by, "library_ms": lstm_library_ms,
        "projection_ms": lstm_projection_ms,
        "train_launches_per_step": {
            "rationale": train_rationale["launches_per_step"]["lstm_seq"]},
        "backward": {"route": backward_route.format("lstm_sequence", "414-423"),
                     "batch": RATIONALE_TRAIN_BATCH,
                     **train_rationale["lstm_seq_forward_direction"]}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
