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
   at this shape; the loop's input route, printed by the loop, must be the
   C++ loader's "native"), both input routes over one epoch of the train
   split (a first and a warm pass each; the page cache is warm on both,
   since this run wrote the files) with their batches equal bit for bit,
   the eval pass's seconds split into device decode and host metrics, and
   decode_corpus's captions/s at beam 1 and beam 5.
   Last, float32 on the card against the CPU on a tiny corpus (6 train and
   3 val videos, H=16, dropout 0, 2 epochs, beam 3, TF32 off): the same
   validation METEOR, BLEU-4 and CIDEr each epoch, the same captions, and
   parameters within 1e-4 * max(1, max|p|).
8. s2vt_att_path -- S2VT with Bahdanau attention at full width (MSVD ResNet
   512-d features, H=512, N=30, L=20, vocab 9,000 padded to 9,088, bf16;
   bench_all.py:151-152, bench_train.py:30), the counts set to 0 just
   before each call and read just after. Serving at B=1024 through
   serving.build_captioner: B1 once per call on the tensor-core body and
   nothing else, float32 tokens on the card equal to the CPU's at B=4 with
   logits within 1e-3, captions/s greedy (best and median of 3, CUDA
   events) and at beam 5, the stage split and one decode step's attention.
   RationaleNet over S2VT-att at B=256: B2 twice and B1 once per call;
   under one shared Gumbel noise, float32 selections and tokens on the card
   equal to the CPU's. The train step at B=1024 (Adam with the clip, static
   teacher forcing, dropout 0.2): B1 once per step, twice with remat=True;
   float32 loss and every gradient leaf on the card against the CPU at B=4;
   ms per step split into forward, backward and optimizer, peak memory, and
   AttentionScan's forward against its hand-scheduled backward. Then the
   command line on a synthetic 512-d corpus: --arch s2vt-att trains 1
   epoch, then --mode eval, --mode export_reference of its model_best, and
   --mode verify_parity of that .net on the card, whose captions equal
   --mode decode's greedy captions of the same checkpoint.
9. spatial_path -- SpatialNet over S2VT at full width (YOLOv3 grid features
   (30, 1024, 13, 13), H=512, L=20, vocab 9,000 padded to 9,088, bf16;
   bench_all.py:514-517, bench_train.py:33), the counts set to 0 just
   before each call and read just after. Serving at B=64 through
   serving.build_captioner: B1 once per call (S2VT's prime pass) on the
   tensor-core body and nothing else, greedy and at beam 5; SpatialNet
   over S2VT-att launches nothing. Float32 at B=2 (TF32 off for cuBLAS and
   cuDNN): tokens on the card equal the CPU's, logits within 1e-3, attention
   maps within 1e-4. Captions/s (best and median of 3, CUDA events), beam
   5 and over S2VT-att, peak memory, the stage split (conv trunk beside its
   bound, key projection, encoder, prime, decode). The train step at B=16
   (Adam with the clip, static teacher forcing, dropout 0.2): B1 once per
   step, twice with remat=True; the convs and BatchNorm's running stats
   move; float32 loss, every gradient leaf and the new running stats on
   the card against the CPU at B=2; ms per step split into forward,
   backward and optimizer, peak memory. Then the command line on a corpus
   of 64 train and 32 val videos of grid features (~2 GB; a quarter of it
   where the disk is short): --mode train_spatial 1 epoch at --bsize 16
   with beam-5 validation, --mode eval, --mode decode, --mode
   export_reference and --mode verify_parity of that .net, whose captions
   equal --mode decode's. Phase 3 holds B1 at this slice's shapes (T=30,
   B=16 and B=64) too.
10. transformer_path -- the Transformer at full width (MSR-VTT 4096-d
   features (30, 4096), the encoder at 4096, the decoder at 300, H=512, 6
   layers, 8 heads, L=20, vocab 9,000 padded to 9,088, bf16;
   bench_all.py:154-190, bench_train.py:31), the counts set to 0 just
   before each call and read just after: no kernel of the port launches in
   serving (KV-cached greedy at B=512, beam 5 with gathered caches at
   B=128, sampling), in the lineage beam, in the parity greedy (B=128) or
   in a train step (B=128, also with remat=True). Float32 at B=4, TF32
   off: the parity greedy's tokens and logits (within 1e-3), the fast
   greedy's and the lineage beam-5's tokens on the card equal to the
   CPU's, the train step's loss and every gradient leaf at B=2 with the
   dropouts at 0. bf16 at B=8, beam 5: the lineage bookkeeping equals a
   physical reorder of the caches bit for bit, and the lineage and gather
   steppers driven in lockstep stay within a 0.5 logit gap
   (tpu_checks.py:157-239); the token cells where the two beams differ are
   printed. Then best and median of 3 calls (CUDA events) with the peak
   memory above each call's start, and the train step split into forward,
   backward and optimizer.
11. continuous_serving -- the continuous-batching slot pool and its HTTP
   daemon at full width. B1 and B2 against their plain versions at the
   admission chunk's shapes (T=30, B=8 and 64, bf16 and float32, phase 3's
   bounds), with their times at both beside the bound, the plain version
   and cuDNN. Then a CaptionServer on port 0 over the flagship S2VT's pool
   (R=512, A=64, bf16) takes 1,024 POST /caption from 32 CaptionClient
   threads and one POST /caption_batch of 256, (30, 4096) features each,
   the clients in a process of their own: the counts set to 0 just before the load and read just after (B1 twice
   per admission chunk on the tensor-core body, nothing else), no null
   response and no scheduler error, captions/s, client latency p50/p99,
   the daemon's /healthz stats; every response's tokens against
   serving.build_captioner's greedy on the same features cut at its first
   eos (at least 98% of the tokens equal), and a float32 pool on the card
   equal to one on the CPU at R=4. The Transformer's pool (R=512 greedy,
   lineage beam 5 at R=128) launches no kernel; its tokens/s beside phase
   10's KV-cached greedy; float32 card = CPU at R=4. RationaleNet's pool
   (R=256, A=64): B2 and B1 twice per admission chunk.
12. quantized_serving -- the quantized serving modes at full width. The
   Transformer's KV-cached greedy at B=512 through serving.build_captioner
   in five (kv_cache, decode_weights) pairs: bf16/bf16, int8/bf16,
   int4/bf16, bf16/int8, int8/int8. For each: no kernel launch, best and
   median of 3 (CUDA events), captions/s, the cache's bytes read off the
   slot stepper's tensors (self and cross, codes and scales) and held to
   the arithmetic (codes a half or a quarter of bf16's, one float32 scale
   per vector), token agreement with the bf16 call. The lineage beam 5 at
   B=128 under an int8 cache. Float32, TF32 off: the quantizers on
   identical inputs (K/V codes and scales of both modes, ties and a zero
   vector included; the decoder's int8 weights) equal the CPU's bit for
   bit; then the stepper at B=4 in every mode: tokens on the card equal
   the CPU's, the last layer's cache codes equal but for a few (at most
   5%) one step apart where the float32 sums' last bits moved a value
   across a rounding boundary, logits within 1e-3 while no code differs,
   else within the JAX package's envelope of the mode (0.05 int8, 0.8
   int4). Then the flagship S2VT's pool (R=512, A=64) and
   RationaleNet's (R=256) in bf16 and int8 decode weights, all requests
   at once: B1 twice (and B2 twice for RationaleNet) per admission chunk
   in both, captions/s, tokens int8 against bf16.

13. deployable_artifacts -- the artifacts of export_serving and
   export_continuous, each exported on the CPU and run on the card. The
   flagship S2VT (bf16, symbolic batch): export seconds and each file's
   bytes; a child process that imports torch, numpy and the op library
   only (its sys.modules is checked) loads it by the recipe of
   export_serving's docstring and captions B=2048 features: B1 twice a call
   on the tensor-core body and nothing else, counted in the child; tokens
   equal to serving.build_captioner's on the same features bit for bit
   (else the agreement and the first differing cell); best and median of
   3 (CUDA events) of the artifact and the live call at B=2048 and B=1, the
   load and first-call seconds. RationaleNet at B=1024 (its selection noise
   drawn by the loader: B2 twice and B1 twice a call), S2VT beam 5 at
   B=256 and the Transformer's KV-cached greedy at B=512 (no launch; its
   export traces every step of every layer, 170-180 s on the host, so a
   child process started after the build exports it on the CPU beside
   phases 3-12, at a lower priority):
   tokens equal to the live call's, times beside it. The frozen flagship
   pool (R=512, A=64) against the live pool over 1,024 requests, each
   twice in turns: tokens equal, B1 twice per admission chunk, captions/s;
   then `python -m vcr_tpu_torch.cli --mode serve --pretrained_base <the
   artifact> --serve_port 0` answers 8 POST /caption with the live pool's
   tokens and exits 0 on SIGTERM. Last, float32 SpatialNet over S2VT at
   B=4, loaded on the card (cuDNN's TF32 left on by the caller, which the
   loader turns off around the call) and on the CPU: tokens equal.
   Phase 5 also times B1 through its custom op against its launcher, and
   the host time of one call of each.
14. featurizers -- raw frames to captions through serving.build_captioner
   with a fused backbone (random weights from a seed), the counts set to 0
   just before each call and read just after: VGG16 to fc7 into the
   flagship S2VT at B=8 (240 frames of 3x224x224 in bf16; B1 twice a
   call), ResNet-34 into S2VT-att at B=16 (480 frames; B1 once), and the
   Darknet-53 + YOLOv3 first-head cut into SpatialNet over S2VT at B=2 (60
   frames of 416x416; B1 once), its cfg written from the published plan
   (models.darknet.yolov3_first_head_cfg: 59 convs, 23 shortcuts, one
   yolo) and read by parse_cfg, the cut (60, 1024, 13, 13). For each:
   tokens and features of the right shape, finite; the backbone alone and
   the whole call, best and median of 3 (CUDA events), beside the
   backbone's bound (its products, counted by FlopCounterMode, at the bf16
   tensor-core peak, or its frames, float32 weights and features over the
   memory rate); captions/s and peak memory. One video (30 frames) on the
   card against the CPU: float32 (TF32 off) features within 1e-4 of the
   largest and tokens equal; bf16 features within FEAT_BF16_GAP, and the
   token agreement reported. Last, the fused VGG16 -> S2VT artifact,
   exported on the CPU and loaded on the card: tokens equal to the live
   call's at B=8, B1 twice a call, its ms beside the live call's.
15. harnesses -- benchutil.time_chained of the flagship at B=2048 (CUDA
   events, best and median of 3, one synchronise) with its FLOPs by
   FlopCounterMode (B1 through its custom op's formula) and the MFU against
   the bf16 peak, beside phase 5's ms; vcr_tpu_torch.checks on the card,
   every row printed, exit 0 required; tune_serving over two (R, A, S)
   geometries of the flagship's pool, a burst of 512 requests each, every
   request served and B1 twice per admission chunk; two processes on the
   one card joined over gloo, dp=2, training S2VT at full width (B=64 per
   rank, 2 steps, p=0), both ranks' losses equal and within the bf16 train
   bound of one process on the global batch, B1 twice per step and rank.
16. multidevice_serving -- two processes on the one card over gloo, full
   width, bf16. The flagship pool sharded dp=2 (R=512, 256 slots a rank,
   A=64, S=4) fed a seeded burst of 512 requests through caption_all on
   rank 0, rank 1 following: tokens against the one-process pool on the
   same burst (at least 98% equal), B1 twice per admission chunk on each
   rank on the tensor-core body, captions/s and the host's ms per
   admission, tick and poll beside the one-process pool's. RationaleNet's
   pool at dp=2 (R=256, A=32, a burst of 256): at least 98% equal to its
   one-process pool, B2 and B1 twice per chunk on each rank. SpatialNet
   over S2VT trained at dp=2 (B=16, 8 a rank, p=0, 3 steps): losses within
   the bf16 train bound of one process on the global batch, B1 once per
   step and rank. The daemon: python -m vcr_tpu_torch.parallel.launch
   --nproc 2 -- --mode serve --mesh_dp 2 over a saved flagship checkpoint,
   256 POST /caption from 32 threads, at least 98% equal to the batch
   greedy, captions/s beside one process's daemon under the same load
   (the launcher with --nproc 1), then SIGTERM and every rank exits 0.
   The dp=2 flagship artifact (exported on the CPU) at B=2048 on
   ["cuda:0", "cuda:0"]: at least 98% equal to the dp=1 artifact, B1
   twice per dp slice, ms of both (CUDA events, best of 3).

Then come a JSON object listing every kernel, nvidia-smi's name and power
limit line, and, last, {"ok": true, "device": {...}}. Needs one CUDA card;
imports only the port.
"""

from __future__ import annotations

import concurrent.futures
import atexit
import contextlib
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vcr_tpu_torch.utils import benchutil
from vcr_tpu_torch.utils.benchutil import (backbone_bound_ms, conv_bound_ms, gru_bound_ms,
                                           lstm_bound_ms, median_best_ms, time_ms)

# The card the bounds are computed for, and its published dense peaks (NVIDIA
# H100 SXM data sheet, benchutil.CARD_PEAKS): bf16 tensor-core FLOP/s, float32
# FLOP/s outside the tensor cores, device-memory bytes/s. Another card ends
# the run.
CARD = "NVIDIA H100 80GB HBM3"
PEAKS = benchutil.CARD_PEAKS[CARD]

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
ATT_BATCH = 1024             # S2VT-att's serving and train batch (bench_all.py:151-152,
                             # bench_train.py:30)
ATT_RATIONALE_BATCH = 256    # RationaleNet over S2VT-att, main-path batch
ATT_BEAM = 5
ATT_CLI_TRAIN_VIDEOS = 512
ATT_CLI_VAL_VIDEOS = 256
SPATIAL_BATCH = 64           # SpatialNet's serving batch (bench_all.py:514-517)
SPATIAL_TRAIN_BATCH = 16     # its train batch (bench_train.py:33)
SPATIAL_BEAM = 5
SPATIAL_ALPHA_TOL = 1e-4     # float32 attention maps card vs CPU, TF32 off
SPATIAL_BN_TOL = 1e-5        # float32 BatchNorm running stats card vs CPU
SPATIAL_CLI_TRAIN_VIDEOS = 64  # (30, 1024, 13, 13) float32 features: 20.8 MB a
SPATIAL_CLI_VAL_VIDEOS = 32    # video, ~2 GB in all
TF_FAST_BATCH = 512          # the Transformer's KV-cached greedy (bench_all.py:157)
TF_BEAM_BATCH = 128          # its beam 5, lineage and gather (bench_all.py:173-190)
TF_PARITY_BATCH = 128        # its parity greedy (bench_all.py:155)
TF_TRAIN_BATCH = 128         # its train step (bench_train.py:31)
TF_BEAM = 5
TF_CHECK_BATCH = 4           # float32 card vs CPU at full width
TF_LINEAGE_BATCH = 8         # the bf16 lineage checks (tpu_checks.py:185-239)
TF_EXPORT_WAIT_S = 600       # phase 13's wait for the Transformer artifact's export
CONT_SLOTS = 512             # the flagship daemon's slot pool (R)
CONT_ADMIT = 64              # its admission chunk (A; bench_all.py:430-431)
CONT_REQUESTS = 1024         # single POST /caption requests, from
CONT_THREADS = 32            # this many client threads,
CONT_BATCH = 256             # and one POST /caption_batch of this many rows
CONT_ADMIT_BATCHES = (8, 64)  # B1 and B2 at the default and the bench admission chunk
CONT_TOKEN_AGREEMENT = 0.98  # the port's bf16 bound: pool against batch greedy
CONT_CHECK_SLOTS = 4         # float32 pool, card vs CPU
TF_CONT_SLOTS = 512          # the Transformer's greedy pool
TF_CONT_BEAM_SLOTS = 128     # its lineage beam-5 pool
RATIONALE_CONT_SLOTS = 256   # RationaleNet's pool
QUANT_MODES = (("bf16", "bf16"), ("int8", "bf16"), ("int4", "bf16"), ("bf16", "int8"),
               ("int8", "int8"))   # phase 12's (kv_cache, decode_weights) pairs
ART_BEAM_BATCH = 256         # phase 13: the S2VT beam-5 artifact's batch
ART_F32_BATCH = 4            # and the float32 SpatialNet artifact's
QUANT_CHECK_BATCH = 4        # float32 card vs CPU in each quantized mode
QUANT_CODE_FLIPS = 0.05      # share of the last layer's cache codes that may sit
                             # one step apart, card vs CPU in float32 after 6
                             # layers and 20 steps: values ~1e-5 apart near a
                             # rounding boundary, and each flip moves later
                             # steps' values (read 0.47% int8, 0.01% int4, 1.2%
                             # int8 with int8 weights; the quantizers on
                             # identical inputs are equal bit for bit)
QUANT_ENVELOPE = {"bf16": LOGIT_TOL, "int8": 0.05, "int4": 0.8}  # logits once codes
                             # differ: the JAX package's bounds (tests/test_kv_quant.py:185)
TF_LINEAGE_GAP = 0.5         # lineage vs gather stepper, the lockstep logit gap
                             # bound of tpu_checks.py:230: products of other
                             # shapes round apart by a few bf16 quanta, a fault
                             # of the stepper by O(1)
VGG_BATCH = 8                # phase 14: videos of 30 frames, VGG16 fc7 -> S2VT
VGG_SIZE = 224
RESNET_BATCH = 16            # ResNet-34 -> S2VT-att
RESNET_SIZE = 224
DARKNET_BATCH = 2            # the Darknet-53 + first-head cut -> SpatialNet
DARKNET_SIZE = 416
CHECK_VIDEOS = 1             # the card against the CPU, one video of 30 frames
TUNE_GEOMETRIES = ((512, 64, 4), (256, 32, 4))  # phase 15: (R, A, S) of the flagship pool
TUNE_REQUESTS = 512          # a burst (rate 0) per geometry
DIST_BATCH = 64              # two processes on the card: rows per rank,
DIST_STEPS = 2               # steps,
DIST_LOSS_TOL = 2e-3         # and the bf16 train bound (test_bf16_step_matches_jax)
MESH_POOL = dict(slots=512, admit=64, step=4, requests=512)  # phase 16: the flagship
MESH_RATIONALE_POOL = dict(slots=256, admit=32, step=4, requests=256)  # pool, dp=2
MESH_SPATIAL = dict(batch=16, steps=3)  # SpatialNet over S2VT trained at dp=2
MESH_DAEMON_REQUESTS = 256   # POST /caption to the dp=2 daemon, from
MESH_DAEMON_THREADS = 32     # this many client threads
MESH_ART_BATCH = 2048        # the dp=2 flagship artifact's batch
FEAT_F32_TOL = 1e-4          # float32 features, card (TF32 off) against CPU,
                             # relative to the largest |feature|
FEAT_BF16_GAP = {"vgg16": 0.03, "resnet": 0.03, "yolo": 0.03}  # bf16 features,
                             # card against CPU, relative to the largest
                             # |feature| (ROADMAP §C): each layer's bf16
                             # activations round apart where a float32 sum
                             # differs in its last bit, and cuDNN also rounds
                             # each conv's output; read 6.9e-3 (VGG16 fc7),
                             # 1.14e-2 (ResNet-34), 1.09e-2 (the Darknet cut)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def train_batch(gen, b, spec, feats_dtype, grid=()):
    """bench_train.py's batch, drawn on ``gen``'s device: normal features
    (SpatialNet's with ``grid`` (K, K)), uniform tokens, every sentence 12
    tokens long, every row valid."""
    device = gen.device
    return {"vid_feats": torch.randn((b, spec.num_frames, spec.vid_feat_size, *grid),
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
    worst gradient leaf error relative to max(1, max|g|), its path, the
    largest error of the new BatchNorm stats where ``loss_fn`` is a step's
    ``loss`` that returns them, else None)."""
    from vcr_tpu_torch.train import optim

    out = []
    for dev in (device, "cpu"):
        p = copy_params(params, dev)
        leaves = optim.trainable_leaves(p)[1]
        for x in leaves:
            x.requires_grad_(True)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.enable_grad():
            result = loss_fn(p, b)
            grads = torch.autograd.grad(result[0], leaves)
        bn = result[3].get("bn_state", {}) if len(result) > 3 else {}
        out.append((result[0].item(), [g.cpu() for g in grads],
                    [st[k].detach().cpu() for st in bn.values() for k in ("mean", "var")]))
    (loss_card, g_card, bn_card), (loss_cpu, g_cpu, bn_cpu) = out
    paths = optim.trainable_leaves(params)[0]
    errs = {"/".join(path): (x - y).abs().max().item() / max(1.0, y.abs().max().item())
            for path, x, y in zip(paths, g_card, g_cpu)}
    worst = max(errs, key=errs.get)
    bn_err = max((max_err(x, y) for x, y in zip(bn_card, bn_cpu)), default=None)
    return abs(loss_card - loss_cpu), errs[worst], worst, bn_err


def peak_memory(fn) -> dict:
    """fn() -> the device memory held when it starts (every tensor the script
    still holds, earlier phases' included), the peak while it runs, and
    the peak above the start: what the call itself needs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_memory_bytes": peak, "allocated_at_start_bytes": start,
            "peak_above_start_bytes": peak - start}


def step_timing(train, params, state, batch, opt):
    """One family's step: ms (best of 3 after warm-up, CUDA events) of the
    whole step, of the forward alone (``StepFns.loss``), of the forward and
    backward (``StepFns.grads``) and of the optimizer; peak memory of a
    step (:func:`peak_memory`)."""
    fns = train.__self__
    memory = peak_memory(lambda: train(params, state, batch, 10, 1.0))
    step_ms = time_ms(lambda: train(params, state, batch, 11, 1.0))
    forward_ms = time_ms(lambda: fns.loss(params, batch, 12, 1.0))
    fwd_bwd_ms = time_ms(lambda: fns.grads(params, state.leaves, batch, 13, 1.0))
    grads = fns.grads(params, state.leaves, batch, 14, 1.0)[0]
    optimizer_ms = time_ms(lambda: opt.step(state, grads))
    b = batch["vid_feats"].shape[0]
    return {"batch": b, "step_ms": step_ms, "samples_per_s": b / (step_ms / 1e3),
            "forward_ms": forward_ms, "backward_ms": fwd_bwd_ms - forward_ms,
            "optimizer_ms": optimizer_ms, **memory}


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
    loss_err, grad_err, grad_worst, _ = f32_card_vs_cpu(loss_fn, params, small, device)
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


def expected_counts(b1=0, b2=0) -> dict:
    """Launch counts of a call that ran B1 ``b1`` times and B2 ``b2`` times,
    all on their tensor-core bodies, and B3 and B4 never."""
    return {"gru_seq": b1, "gru_seq_bt": 0, "gru_seq_dma": 0, "gru_seq_tc": b1,
            "gru_seq_dma_tc": 0, "lstm_seq": b2, "lstm_seq_tc": b2}


def counted(cuda_gru, cuda_lstm, fn):
    """fn() with the counts set to 0 just before and read just after ->
    (result, counts)."""
    reset_counts(cuda_gru, cuda_lstm)
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts(cuda_gru, cuda_lstm)


def run_cli(cuda_gru, cuda_lstm, argv):
    """cli.main(argv) with its output held back, the counts set to 0 just
    before and read just after -> (result, counts); on a failure the end of
    its output goes to standard error."""
    from vcr_tpu_torch import cli

    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return counted(cuda_gru, cuda_lstm, lambda: cli.main(argv))
    except BaseException:
        print(out.getvalue()[-4000:], file=sys.stderr)
        raise


def write_corpus(root, n_words, glove_dim, n_train, n_val, frames, feat_dim, seed):
    """A corpus in the layout the pipeline reads (msvd_vgg under ``root``):
    a GloVe file (glove.txt) of ``n_words`` random words, two captions of
    5-19 of those words per video, and (frames, feat_dim) float32 features
    per video under feats/, or with a tuple ``feat_dim`` (F, K, K) YOLO grid
    features under bbox_feats/, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    cdir = os.path.join(root, "msvd_vgg")
    feat_shape = (feat_dim,) if isinstance(feat_dim, int) else tuple(feat_dim)
    feat_dir = "feats" if len(feat_shape) == 1 else "bbox_feats"
    os.makedirs(os.path.join(cdir, "glove"))
    os.makedirs(os.path.join(cdir, feat_dir))
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
            np.save(os.path.join(cdir, feat_dir, key + ".npy"),
                    rng.standard_normal((frames, *feat_shape), dtype=np.float32))
        with open(os.path.join(cdir, f"{split}_captions.json"), "w") as f:
            json.dump(samples, f)
    return ["--data_dir", root, "--corpus", "msvd_vgg", "--glove_emb_file", "glove.txt"]


def cli_phase(cuda_gru, cuda_lstm, smi):
    """Phase 7: the command line at full width, resume, its times, and
    float32 card against CPU on a tiny corpus."""
    from vcr_tpu_torch import cli, tools
    from vcr_tpu_torch.config import Config
    from vcr_tpu_torch.data.pipeline import BatchIterator
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
        train, launches["train"], out = run(
            data + model + bsize + ["--mode", "train", "--save_path", s2vt_dir,
                                    "--epochs", "2", "--beam_size", str(CLI_BEAM)])
        train_s = time.perf_counter() - t0
        loop_route = [line.split(": ")[1].split()[0] for line in out.splitlines()
                      if line.startswith("====> Input route: ")]
        check(loop_route == ["native"], f"the train loop's input route: {loop_route}")
        # per epoch: each step, then each val batch's greedy eval step and beam
        want = expected_counts(2 * (2 * steps + (2 + 2) * val_batches))
        check(launches["train"] == want,
              f"--mode train launched {launches['train']}, not {want}")
        check(math.isfinite(train["loss"]) and all(
            checkpoint.checkpoint_exists(os.path.join(s2vt_dir, name))
            for name in ("model_latest", "model_best")),
              f"--mode train: loss {train['loss']}, or a checkpoint missing")

        evaluation, launches["eval"], _ = run(
            data + bsize + ["--mode", "eval", "--save_path", s2vt_dir,
                            "--beam_size", str(CLI_BEAM)])
        want = expected_counts((2 + 2) * val_batches)
        check(launches["eval"] == want, f"--mode eval launched {launches['eval']}, "
                                        f"not {want}")
        check(math.isfinite(evaluation["loss"]), f"eval loss {evaluation['loss']}")
        for beam in (CLI_BEAM, 1):
            _, launches[f"decode_beam{beam}"], _ = run(
                data + bsize + ["--mode", "decode", "--save_path", s2vt_dir,
                                "--beam_size", str(beam)])
            want = expected_counts(2 * val_batches)
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
        want = expected_counts(2 * (rsteps + rval), 2 * (rsteps + rval))
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
              and launches["resume"] == expected_counts(0),
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
        routes = {"native": train_it, "numpy": BatchIterator(
            train_it.ds, CLI_BATCH, shuffle=True, seed=pipe_cfg.seed,
            num_threads=pipe_cfg.nworkers, use_native=False)}
        check({r: it.route for r, it in routes.items()}
              == {"native": "native", "numpy": "numpy"}, "the loader routes")
        pipeline_ms, first_epoch = {r: {} for r in routes}, {}
        for name in ("first_pass", "warm_pass"):
            for route, it in routes.items():
                it.epoch = 0
                t0 = time.perf_counter()
                epoch = list(it)
                pipeline_ms[route][name] = (time.perf_counter() - t0) * 1e3 / len(epoch)
                first_epoch.setdefault(route, epoch)
        check(len(first_epoch["native"]) == len(first_epoch["numpy"]) == 2 and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k].view(np.uint8),
                                                        b[k].view(np.uint8))
            for a, b in zip(first_epoch["native"], first_epoch["numpy"])
            for k in ("vid_feats", "sent", "sent_len", "valid", "sample_idx")),
              "the native and numpy routes' batches differ")
        host_batches = first_epoch["native"]
        del first_epoch
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
         steps_timed=train["perf/steps"], loop_input_route=loop_route[0],
         input_pipeline_ms_per_batch=pipeline_ms["native"]["warm_pass"],
         copy_to_card_ms=copy_ms, train_step_alone_ms=step_ms,
         nworkers=pipe_cfg.nworkers, nvidia_smi=smi)
    # one epoch of the train split (2 batches of (256, 30, 4096) float32,
    # 126 MB each) per route; the files were written by this run a minute
    # before, so even the first pass reads them from the page cache
    emit("cli_input_pipeline", batch=CLI_BATCH, videos=CLI_TRAIN_VIDEOS,
         batch_bytes=CLI_BATCH * 30 * 4096 * 4, input_pipeline_ms_per_batch=pipeline_ms,
         page_cache="warm on both passes: the files were written by this run",
         batches_equal_bit_for_bit=True, loop_input_route=loop_route[0],
         loop_step_ms_one_interval=train["perf/step_ms_p50"],
         nworkers=pipe_cfg.nworkers, nvidia_smi=smi)
    emit("cli_eval", batch=CLI_BATCH, beam=CLI_BEAM, videos=CLI_VAL_VIDEOS,
         decode_seconds=evaluation["eval_decode_s"],
         host_metrics_seconds=evaluation["eval_host_metrics_s"], nvidia_smi=smi)
    for beam, rate in decode_rate.items():
        emit("cli_decode", beam=beam, batch=CLI_BATCH, videos=len(feats),
             captions_per_s=rate, nvidia_smi=smi)


def s2vt_att_phase(cuda_gru, cuda_lstm, smi):
    """Phase 8: S2VT-att served, RationaleNet over it, its train step and
    its command line, at full width; returns what the kernels line reports
    of it."""
    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import rationale, s2vt_att
    from vcr_tpu_torch.nn.attention import bahdanau_attend, bahdanau_project_keys
    from vcr_tpu_torch.train import optim, step

    t_phase = time.perf_counter()
    spec, params = entry.make_spec_and_params(**entry.S2VT_ATT, device="cuda")
    cd, frames, b = spec.cdtype, spec.num_frames, ATT_BATCH
    gen = torch.Generator(device="cuda").manual_seed(8)
    feats = torch.randn((b, frames, spec.vid_feat_size), generator=gen, device="cuda")

    # serving: one B1 launch per call, greedy and beam
    caption = serving.build_captioner(params, spec)
    tokens, serve_launches = counted(cuda_gru, cuda_lstm, lambda: caption(feats))
    check(serve_launches == expected_counts(1),
          f"the S2VT-att captioner launched {serve_launches}, not B1 once on the "
          "tensor-core body and nothing else")
    check(tuple(tokens.shape) == (b, spec.max_len) and tokens.dtype == torch.int32
          and 0 <= int(tokens.min()) and int(tokens.max()) < spec.vocab_size,
          f"S2VT-att tokens {tuple(tokens.shape)} {tokens.dtype}")
    beam_caption = serving.build_captioner(params, spec, beam_size=ATT_BEAM)
    beam_tokens, beam_launches = counted(cuda_gru, cuda_lstm, lambda: beam_caption(feats))
    check(beam_launches == expected_counts(1) and tuple(beam_tokens.shape) == (
        b, spec.max_len), f"the S2VT-att beam-{ATT_BEAM} captioner launched {beam_launches}")

    spec32 = spec.with_(compute_dtype="float32")
    few = feats[:4]
    on_card = serving.build_captioner(params, spec32)(few).cpu()
    on_cpu = serving.build_captioner(params, spec32, device="cpu")(few.cpu())
    with torch.inference_mode():
        logits_card = s2vt_att.apply(params, spec32, few).cpu()
        logits_cpu = s2vt_att.apply(params_to(params, "cpu"), spec32, few.cpu())
    logit_err = (logits_card - logits_cpu).abs().max().item()
    check(torch.equal(on_card, on_cpu), "S2VT-att float32 tokens differ, card vs CPU")
    check(bool(torch.isfinite(logits_card).all()) and logit_err <= LOGIT_TOL,
          f"S2VT-att float32 logits card vs CPU: err {logit_err}")

    # times: the call (best and median of 3), beam 5, and the stages
    runs = []
    caption(feats)
    for _ in range(3):
        runs.append(time_ms(lambda: caption(feats), reps=1))
    caption_ms, caption_median_ms = min(runs), sorted(runs)[1]
    beam_ms = time_ms(lambda: beam_caption(feats))
    with torch.inference_mode():
        vf = feats.to(cd)
        eo, ef = s2vt_att.encode(params, spec, vf)
        att = params["decoder"]["attention"]
        pk = bahdanau_project_keys(att, eo, cd)
        values = eo.to(cd)
        stages = {
            "encode_ms": time_ms(lambda: s2vt_att.encode(params, spec, vf)),
            "decode_ms": time_ms(lambda: s2vt_att.decode(params, spec, eo, ef,
                                                         emit="tokens")),
            "attend_one_step_ms": time_ms(lambda: bahdanau_attend(att, ef, pk, values, cd),
                                          iters=5),
        }
    emit("s2vt_att_serving", batch=b, launches=serve_launches,
         beam_launches=beam_launches, f32_tokens_card_eq_cpu=True,
         f32_logits_max_abs_err=logit_err, caption_ms=caption_ms,
         caption_ms_median=caption_median_ms, caption_ms_runs=runs,
         captions_per_s=b / (caption_ms / 1e3),
         captions_per_s_median=b / (caption_median_ms / 1e3),
         beam=ATT_BEAM, beam_caption_ms=beam_ms,
         beam_captions_per_s=b / (beam_ms / 1e3), stages=stages, nvidia_smi=smi)

    # RationaleNet over S2VT-att: B2 once per direction, then B1 once
    rspec, rparams = entry.make_spec_and_params(
        **dict(entry.S2VT_ATT, arch="rationale", base_arch="s2vt-att", tau=1.0),
        device="cuda")
    rcaption = serving.build_captioner(rparams, rspec)
    rfeats = feats[:ATT_RATIONALE_BATCH]
    rtokens, rat_launches = counted(cuda_gru, cuda_lstm, lambda: rcaption(rfeats))
    check(rat_launches == expected_counts(1, 2),
          f"RationaleNet over S2VT-att launched {rat_launches}, not B2 twice and B1 "
          "once (tensor-core bodies) and nothing else")
    check(tuple(rtokens.shape) == (ATT_RATIONALE_BATCH, rspec.max_len),
          f"RationaleNet over S2VT-att tokens {tuple(rtokens.shape)}")
    rspec32 = rspec.with_(compute_dtype="float32")
    noise = torch.from_numpy(np.random.default_rng(6).gumbel(
        size=(4, frames, 2)).astype(np.float32))
    rparams_cpu = params_to(rparams, "cpu")
    with torch.inference_mode():
        rtok_card, rprobs_card = rationale.apply(rparams, rspec32, few, emit="tokens",
                                                 gumbel_noise=noise.cuda())
        rtok_cpu, rprobs_cpu = rationale.apply(rparams_cpu, rspec32, few.cpu(),
                                               emit="tokens", gumbel_noise=noise)
    check(torch.equal(rprobs_card.cpu(), rprobs_cpu),
          "RationaleNet over S2VT-att: float32 selections differ, card vs CPU")
    check(torch.equal(rtok_card.cpu(), rtok_cpu),
          "RationaleNet over S2VT-att: float32 tokens differ, card vs CPU")
    rationale_ms = time_ms(lambda: rcaption(rfeats))
    emit("s2vt_att_rationale", batch=ATT_RATIONALE_BATCH, launches=rat_launches,
         f32_probs_card_eq_cpu=True, f32_tokens_card_eq_cpu=True,
         f32_frames_selected_share=rprobs_cpu[..., 1].mean().item(),
         caption_ms=rationale_ms,
         captions_per_s=ATT_RATIONALE_BATCH / (rationale_ms / 1e3), nvidia_smi=smi)

    # the train step: B1 once per step (twice with remat), card vs CPU, times
    opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("s2vt-att", spec, opt, static_tf=1.0, device="cuda")
    batch = train_batch(gen, b, spec, cd)
    query_w = params["decoder"]["attention"]["query_layer"]["w"]
    before = query_w.detach().clone()
    step_launches, step_losses = [], []
    for i in range(3):
        (_, _, metrics, _), counts = counted(
            cuda_gru, cuda_lstm, lambda: train(params, state, batch, i, 1.0))
        step_launches.append(counts)
        step_losses.append(metrics["loss"].item())
    check(all(c == expected_counts(1) for c in step_launches),
          f"S2VT-att train steps launched {step_launches}, not B1 once each")
    check(all(math.isfinite(x) for x in step_losses) and not torch.equal(before, query_w),
          f"S2VT-att losses {step_losses}, or the query layer did not move")
    remat_train, _ = step.build_step_fns("s2vt-att", spec, opt, static_tf=1.0, remat=True,
                                         device="cuda")
    _, remat_launches = counted(cuda_gru, cuda_lstm,
                                lambda: remat_train(params, state, batch, 3, 1.0))
    check(remat_launches == expected_counts(2),
          f"a remat=True S2VT-att step launched {remat_launches}, not B1 twice")
    fns32 = step.build_step_fns("s2vt-att", spec32.with_(dropout_p=0.0), opt,
                                static_tf=1.0, device="cuda")[0].__self__
    loss_err, grad_err, grad_worst, _ = f32_card_vs_cpu(
        lambda p, bt: fns32.loss(p, bt, 0, 1.0), params,
        train_batch(gen, 4, spec32, torch.float32), "cuda")
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
          f"S2VT-att float32 card vs CPU: loss err {loss_err}, gradient err {grad_err} "
          f"({grad_worst})")
    timing = step_timing(train, params, state, batch, opt)
    # AttentionScan alone at this batch: its forward (the plain loop, no
    # tape) against its backward (the reverse loop and the two rebuilt
    # (B, N, H) gradients)
    dec = params["decoder"]
    with torch.enable_grad():
        eo, ef = s2vt_att.encode(params, spec, batch["vid_feats"])
        pk = bahdanau_project_keys(dec["attention"], eo, cd)
        s_in = torch.cat([torch.full((b, 1), spec.sos_id, device="cuda",
                                     dtype=torch.int32), batch["sent"]], dim=1)
        embs = dec["embedding"]["table"][s_in[:, :spec.max_len]].transpose(0, 1)
        args = (dec["attention"], dec["rnn"], pk, eo, ef, embs, cd)
        states = s2vt_att.attention_scan(*args)
        leaves = [dec["attention"]["query_layer"]["w"], pk, eo]
        cot = torch.randn(states.shape, generator=gen, device="cuda")
        scan = {"forward_ms": time_ms(lambda: s2vt_att.attention_scan(*args)),
                "backward_ms": time_ms(lambda: torch.autograd.grad(
                    states, leaves, cot, retain_graph=True))}
    emit("s2vt_att_train", batch=b, losses=step_losses, launches_per_step=step_launches[-1],
         remat_launches_per_step=remat_launches, f32_loss_err=loss_err,
         f32_grad_rel_err=grad_err, f32_grad_worst_leaf=grad_worst,
         f32_loss_tolerance=TRAIN_LOSS_TOL, f32_grad_tolerance=TRAIN_GRAD_TOL,
         timing=timing, attention_scan=scan, nvidia_smi=smi)

    # the command line on a synthetic 512-d corpus
    def run(argv):
        return run_cli(cuda_gru, cuda_lstm, argv)

    with tempfile.TemporaryDirectory() as tmp:
        data = write_corpus(os.path.join(tmp, "data"), CLI_WORDS, 300, ATT_CLI_TRAIN_VIDEOS,
                            ATT_CLI_VAL_VIDEOS, frames, spec.vid_feat_size, seed=9)
        model = ["--arch", "s2vt-att", "--num_frames", str(frames), "--vid_feat_size",
                 str(spec.vid_feat_size), "--max_len", str(spec.max_len), "--hidden_size",
                 str(spec.hidden_size), "--compute_dtype", "bfloat16", "--vocab_pad_to",
                 "128", "--log_dir", ""]
        save = os.path.join(tmp, "s2vt_att")
        io_flags = data + ["--bsize", str(CLI_BATCH), "--save_path", save]
        steps = -(-ATT_CLI_TRAIN_VIDEOS // CLI_BATCH)
        val_batches = -(-ATT_CLI_VAL_VIDEOS // CLI_BATCH)
        cli_launches = {}
        trained, cli_launches["train"] = run(io_flags + model + ["--mode", "train",
                                                                 "--epochs", "1"])
        # each step, then each val batch's greedy eval step
        check(cli_launches["train"] == expected_counts(steps + val_batches)
              and math.isfinite(trained["loss"]),
              f"--arch s2vt-att --mode train launched {cli_launches['train']}, loss "
              f"{trained['loss']}")
        evaluation, cli_launches["eval"] = run(io_flags + ["--mode", "eval"])
        check(cli_launches["eval"] == expected_counts(val_batches)
              and math.isfinite(evaluation["loss"]),
              f"--mode eval launched {cli_launches['eval']}")
        decoded, cli_launches["decode"] = run(io_flags + ["--mode", "decode"])
        net, _ = run(io_flags + ["--mode", "export_reference"])
        parity, cli_launches["verify_parity"] = run(
            io_flags + model + ["--mode", "verify_parity", "--pretrained_base", net,
                                "--save_path", os.path.join(tmp, "parity")])
        for mode in ("decode", "verify_parity"):
            check(cli_launches[mode] == expected_counts(val_batches),
                  f"--mode {mode} launched {cli_launches[mode]}")
        check(len(parity) == ATT_CLI_VAL_VIDEOS and parity == decoded,
              "verify_parity of the exported .net differs from decode of its checkpoint")
    emit("s2vt_att_cli", videos={"train": ATT_CLI_TRAIN_VIDEOS, "val": ATT_CLI_VAL_VIDEOS},
         batch=CLI_BATCH, launches=cli_launches, train_loss=trained["loss"],
         eval_metrics={k: evaluation[k] for k in ("loss", "acc", "METEOR", "BLEU4")},
         verify_parity_eq_decode=True, phase_seconds=time.perf_counter() - t_phase)
    return {"serve": serve_launches, "rationale": rat_launches,
            "train": step_launches[-1], "train_remat": remat_launches}


def spatial_phase(cuda_gru, cuda_lstm, smi):
    """Phase 9: SpatialNet served (greedy, beam, over S2VT-att), float32
    card against CPU, its train step and its command line, at full width;
    returns what the kernels line reports of it."""
    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import s2vt, spatial
    from vcr_tpu_torch.nn.attention import bahdanau_project_keys
    from vcr_tpu_torch.train import optim, step

    t_phase = time.perf_counter()
    spec, params = entry.make_spec_and_params(**entry.SPATIAL, device="cuda")
    cd, frames, b, k = spec.cdtype, spec.num_frames, SPATIAL_BATCH, spec.grid_size
    f, hidden = spec.vid_feat_size, spec.hidden_size
    gen = torch.Generator(device="cuda").manual_seed(10)
    feats = torch.randn((b, frames, f, k, k), generator=gen, device="cuda")

    # serving: B1 once per call (S2VT's prime), greedy and beam
    caption = serving.build_captioner(params, spec)
    tokens, serve_launches = counted(cuda_gru, cuda_lstm, lambda: caption(feats))
    check(serve_launches == expected_counts(1),
          f"the SpatialNet captioner launched {serve_launches}, not B1 once on the "
          "tensor-core body and nothing else")
    check(tuple(tokens.shape) == (b, spec.max_len) and tokens.dtype == torch.int32
          and 0 <= int(tokens.min()) and int(tokens.max()) < spec.vocab_size,
          f"SpatialNet tokens {tuple(tokens.shape)} {tokens.dtype}")
    beam_caption = serving.build_captioner(params, spec, beam_size=SPATIAL_BEAM)
    beam_tokens, beam_launches = counted(cuda_gru, cuda_lstm, lambda: beam_caption(feats))
    check(beam_launches == expected_counts(1) and tuple(beam_tokens.shape) == (
        b, spec.max_len), f"the SpatialNet beam-{SPATIAL_BEAM} captioner launched "
                          f"{beam_launches}")
    aspec, aparams = entry.make_spec_and_params(**dict(entry.SPATIAL, base_arch="s2vt-att"),
                                                device="cuda")
    att_caption = serving.build_captioner(aparams, aspec)
    att_tokens, att_launches = counted(cuda_gru, cuda_lstm, lambda: att_caption(feats))
    check(att_launches == expected_counts(0) and tuple(att_tokens.shape) == (
        b, spec.max_len), f"SpatialNet over S2VT-att launched {att_launches}, not nothing")

    # float32 at B=2, TF32 off (main() turns it off for cuBLAS and cuDNN)
    spec32 = spec.with_(compute_dtype="float32")
    few = feats[:2].clone()
    params_cpu = params_to(params, "cpu")
    with torch.inference_mode():
        logits_card, alphas_card, _ = spatial.apply(params, spec32, few)
        logits_cpu, alphas_cpu, _ = spatial.apply(params_cpu, spec32, few.cpu())
    logit_err = max_err(logits_card.cpu(), logits_cpu)
    alpha_err = max_err(alphas_card.cpu(), alphas_cpu)
    on_card = serving.build_captioner(params, spec32)(few).cpu()
    check(torch.equal(on_card, logits_cpu.argmax(-1).to(torch.int32)),
          "SpatialNet float32 tokens differ, card vs CPU")
    check(all_finite(logits_card) and logit_err <= LOGIT_TOL
          and alpha_err <= SPATIAL_ALPHA_TOL,
          f"SpatialNet float32 card vs CPU: logits err {logit_err}, alphas err "
          f"{alpha_err}")

    # times: the call (best and median of 3), beam 5, over S2VT-att, stages
    runs = []
    for _ in range(3):
        runs.append(time_ms(lambda: caption(feats), reps=1))
    caption_ms, caption_median_ms = min(runs), sorted(runs)[1]
    memory = peak_memory(lambda: caption(feats))
    beam_ms = time_ms(lambda: beam_caption(feats))
    att_ms = time_ms(lambda: att_caption(feats))
    att = params["attention"]
    with torch.inference_mode():
        frames_in = feats.reshape(b * frames, f, k, k)
        trunk, _ = spatial.conv_trunk(params, spec, frames_in, False)
        keys = trunk.reshape(b, frames, hidden, k * k).transpose(2, 3)
        output1, state1, _, _ = spatial.encode_spatial(params, spec, feats, False)
        state2 = s2vt._prime_state2(params["caption_net"], spec, output1)
        stages = {
            "conv_trunk_ms": time_ms(lambda: spatial.conv_trunk(params, spec, frames_in,
                                                                False)),
            "key_projection_ms": time_ms(lambda: bahdanau_project_keys(att, keys, cd)),
            "encode_ms": time_ms(lambda: spatial.encode_spatial(params, spec, feats,
                                                                False)),
            "prime_ms": time_ms(lambda: s2vt._prime_state2(params["caption_net"], spec,
                                                           output1)),
            "decode_ms": time_ms(lambda: s2vt.decode_from_states(
                params["caption_net"], spec, state1, state2, emit="tokens")),
        }
    stages["encoder_loop_ms_derived"] = (stages["encode_ms"] - stages["conv_trunk_ms"]
                                         - stages["key_projection_ms"])
    trunk_bound, trunk_bound_by = conv_bound_ms(b * frames, f, hidden, k, PEAKS)
    emit("spatial_serving", batch=b, feats=[frames, f, k, k], launches=serve_launches,
         beam_launches=beam_launches, s2vt_att_launches=att_launches,
         f32_tokens_card_eq_cpu=True, f32_logits_max_abs_err=logit_err,
         f32_alphas_max_abs_err=alpha_err, caption_ms=caption_ms,
         caption_ms_median=caption_median_ms, caption_ms_runs=runs,
         captions_per_s=b / (caption_ms / 1e3),
         captions_per_s_median=b / (caption_median_ms / 1e3), memory=memory,
         beam=SPATIAL_BEAM, beam_caption_ms=beam_ms,
         beam_captions_per_s=b / (beam_ms / 1e3), s2vt_att_caption_ms=att_ms,
         s2vt_att_captions_per_s=b / (att_ms / 1e3), stages=stages,
         conv_trunk={"ms": stages["conv_trunk_ms"], "bound_ms": trunk_bound,
                     "bound_by": trunk_bound_by, "route": "F.conv2d in bf16 (cuDNN), "
                     "BatchNorm and ReLU in plain PyTorch"}, nvidia_smi=smi)
    del feats, trunk, keys, frames_in, output1

    # the train step: B1 once per step (twice with remat), BN stats moved,
    # card vs CPU, times
    b = SPATIAL_TRAIN_BATCH
    opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("spatial", spec, opt, static_tf=1.0, device="cuda")
    batch = train_batch(gen, b, spec, torch.float32, grid=(k, k))
    conv_w, bn_mean = params["conv1"]["w"], params["bn1"]["mean"]
    before = (conv_w.detach().clone(), bn_mean.clone())
    step_launches, step_losses = [], []
    for i in range(3):
        (_, _, metrics, _), counts = counted(
            cuda_gru, cuda_lstm, lambda: train(params, state, batch, i, 1.0))
        step_launches.append(counts)
        step_losses.append(metrics["loss"].item())
    check(all(c == expected_counts(1) for c in step_launches),
          f"SpatialNet train steps launched {step_launches}, not B1 once each")
    check(all(math.isfinite(x) for x in step_losses)
          and not torch.equal(before[0], conv_w) and not torch.equal(before[1], bn_mean),
          f"SpatialNet losses {step_losses}, or conv1 or bn1's running mean did not move")
    remat_train, _ = step.build_step_fns("spatial", spec, opt, static_tf=1.0, remat=True,
                                         device="cuda")
    _, remat_launches = counted(cuda_gru, cuda_lstm,
                                lambda: remat_train(params, state, batch, 3, 1.0))
    check(remat_launches == expected_counts(2),
          f"a remat=True SpatialNet step launched {remat_launches}, not B1 twice")
    fns32 = step.build_step_fns("spatial", spec32.with_(dropout_p=0.0), opt,
                                static_tf=1.0, device="cuda")[0].__self__
    loss_err, grad_err, grad_worst, bn_err = f32_card_vs_cpu(
        lambda p, bt: fns32.loss(p, bt, 0, 1.0), params,
        train_batch(gen, 2, spec32, torch.float32, grid=(k, k)), "cuda")
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
          and bn_err <= SPATIAL_BN_TOL,
          f"SpatialNet float32 card vs CPU: loss err {loss_err}, gradient err {grad_err} "
          f"({grad_worst}), BN stats err {bn_err}")
    timing = step_timing(train, params, state, batch, opt)
    emit("spatial_train", batch=b, losses=step_losses, launches_per_step=step_launches[-1],
         remat_launches_per_step=remat_launches, f32_loss_err=loss_err,
         f32_grad_rel_err=grad_err, f32_grad_worst_leaf=grad_worst, f32_bn_stats_err=bn_err,
         f32_loss_tolerance=TRAIN_LOSS_TOL, f32_grad_tolerance=TRAIN_GRAD_TOL,
         f32_bn_tolerance=SPATIAL_BN_TOL, timing=timing, nvidia_smi=smi)
    del batch

    # the command line on a synthetic corpus of YOLO grid features
    with tempfile.TemporaryDirectory() as tmp:
        # ~2 GB of features; a quarter of the videos where the disk is short
        n_train, n_val = SPATIAL_CLI_TRAIN_VIDEOS, SPATIAL_CLI_VAL_VIDEOS
        if shutil.disk_usage(tmp).free < 3 * (n_train + n_val) * frames * f * k * k * 4:
            n_train, n_val = n_train // 4, n_val // 4
        t0 = time.perf_counter()
        data = write_corpus(os.path.join(tmp, "data"), CLI_WORDS, 300, n_train, n_val,
                            frames, (f, k, k), seed=11)
        corpus_s = time.perf_counter() - t0
        model = ["--arch", "s2vt", "--num_frames", str(frames), "--vid_feat_size", str(f),
                 "--max_len", str(spec.max_len), "--hidden_size", str(hidden),
                 "--compute_dtype", "bfloat16", "--vocab_pad_to", "128", "--log_dir", ""]
        save = os.path.join(tmp, "spatial")
        io_flags = data + ["--bsize", str(b), "--save_path", save]
        steps, val_batches = -(-n_train // b), -(-n_val // b)
        cli_launches = {}
        trained, cli_launches["train_spatial"] = run_cli(
            cuda_gru, cuda_lstm, io_flags + model + ["--mode", "train_spatial", "--epochs",
                                                     "1", "--beam_size", str(SPATIAL_BEAM)])
        # each step, then each val batch's greedy eval step and its beam search
        check(cli_launches["train_spatial"] == expected_counts(steps + 2 * val_batches)
              and math.isfinite(trained["loss"]),
              f"--mode train_spatial launched {cli_launches['train_spatial']}, loss "
              f"{trained['loss']}")
        evaluation, cli_launches["eval"] = run_cli(cuda_gru, cuda_lstm,
                                                   io_flags + ["--mode", "eval"])
        check(cli_launches["eval"] == expected_counts(val_batches)
              and math.isfinite(evaluation["loss"]),
              f"--mode eval launched {cli_launches['eval']}")
        decoded, cli_launches["decode"] = run_cli(cuda_gru, cuda_lstm,
                                                  io_flags + ["--mode", "decode"])
        net, _ = run_cli(cuda_gru, cuda_lstm, io_flags + ["--mode", "export_reference"])
        parity, cli_launches["verify_parity"] = run_cli(
            cuda_gru, cuda_lstm, io_flags + model + [
                "--mode", "verify_parity", "--pretrained_base", net,
                "--save_path", os.path.join(tmp, "parity")])
        for mode in ("decode", "verify_parity"):
            check(cli_launches[mode] == expected_counts(val_batches),
                  f"--mode {mode} launched {cli_launches[mode]}")
        check(len(parity) == n_val and parity == decoded,
              "verify_parity of the exported .net differs from decode of its checkpoint")
    emit("spatial_cli", videos={"train": n_train, "val": n_val},
         feats=[frames, f, k, k], corpus_seconds=corpus_s, batch=b, launches=cli_launches,
         train_loss=trained["loss"],
         eval_metrics={k_: evaluation[k_] for k_ in ("loss", "acc", "METEOR", "BLEU4")},
         verify_parity_eq_decode=True, phase_seconds=time.perf_counter() - t_phase)
    return {"serve": serve_launches, "beam": beam_launches, "s2vt_att": att_launches,
            "train": step_launches[-1], "train_remat": remat_launches}


def lineage_lockstep_gap(tr, gather_rows, params, spec, e_outputs, k, gen):
    """The lineage and gather steppers driven in lockstep (bf16): the same
    random words each step and the same random reorder within each item,
    the lineage one through its ancestry, the gather one by gathering its
    caches -> the largest |logit difference| over the steps."""
    b = e_outputs.shape[0]
    step_l, state_l, reorder_l = tr.make_cached_stepper(params, spec, e_outputs,
                                                        beam_tile=k, lineage=True)
    step_g, state_g = tr.make_cached_stepper(params, spec, e_outputs, beam_tile=k)
    gap = 0.0
    for i in range(spec.max_len):
        words = torch.randint(0, spec.vocab_size, (b * k,), generator=gen,
                              device="cuda", dtype=torch.int32)
        if i > 0:
            src = torch.randint(0, k, (b, k), generator=gen, device="cuda")
            flat = (torch.arange(b, device="cuda")[:, None] * k + src).reshape(-1)
            state_l, state_g = reorder_l(state_l, flat), gather_rows(state_g, flat)
        state_l, logits_l = step_l(state_l, words, i)
        state_g, logits_g = step_g(state_g, words, i)
        gap = max(gap, (logits_l.double() - logits_g.double()).abs().max().item())
    return gap


def transformer_phase(cuda_gru, cuda_lstm, smi):
    """Phase 10: the Transformer served (KV-cached greedy, beam 5 with
    gathered caches and with lineage, sampling), its parity decodes, float32
    card against CPU, the bf16 lineage checks and its train step, at full
    width; returns its launch counts for the kernels line."""
    from vcr_tpu_torch import decode, entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import transformer as tr
    from vcr_tpu_torch.train import optim, step

    t_phase = time.perf_counter()
    spec, params = entry.make_spec_and_params(**entry.TRANSFORMER, device="cuda")
    cd, frames, f, eos = spec.cdtype, spec.num_frames, spec.vid_feat_size, spec.sos_id + 1
    gen = torch.Generator(device="cuda").manual_seed(12)
    feats = torch.randn((TF_FAST_BATCH, frames, f), generator=gen, device="cuda")
    beam_feats, parity_feats = feats[:TF_BEAM_BATCH], feats[:TF_PARITY_BATCH]
    launches = {}

    def valid(tokens, b):
        return (tuple(tokens.shape) == (b, spec.max_len) and tokens.dtype == torch.int32
                and 0 <= int(tokens.min()) and int(tokens.max()) < spec.vocab_size)

    # serving and the parity decodes: no kernel of the port launches
    caption = serving.build_captioner(params, spec)
    beam_caption = serving.build_captioner(params, spec, beam_size=TF_BEAM)
    sample_caption = serving.build_captioner(params, spec, sample_temperature=0.7)

    def lineage_beam():
        with torch.inference_mode():
            return decode.transformer_beam_decode_fast(params, spec, beam_feats.to(cd),
                                                       TF_BEAM, eos, lineage=True)[0][:, 0]

    def parity_greedy():
        with torch.inference_mode():
            return tr.apply(params, spec, parity_feats, emit="tokens")

    calls = {"greedy": (lambda: caption(feats), TF_FAST_BATCH),
             "beam_gather": (lambda: beam_caption(beam_feats), TF_BEAM_BATCH),
             "beam_lineage": (lineage_beam, TF_BEAM_BATCH),
             "sample": (lambda: sample_caption(beam_feats), TF_BEAM_BATCH),
             "parity_greedy": (parity_greedy, TF_PARITY_BATCH)}
    for name, (fn, b) in calls.items():
        tokens, launches[name] = counted(cuda_gru, cuda_lstm, fn)
        check(launches[name] == expected_counts(0) and valid(tokens, b),
              f"Transformer {name} launched {launches[name]} or gave tokens "
              f"{tuple(tokens.shape)} {tokens.dtype}")

    # float32 card vs CPU at full width, TF32 off (main() turns it off)
    spec32 = spec.with_(compute_dtype="float32")
    few = feats[:TF_CHECK_BATCH].clone()
    params_cpu = params_to(params, "cpu")
    with torch.inference_mode():
        logits_card = tr.apply(params, spec32, few)
        logits_cpu = tr.apply(params_cpu, spec32, few.cpu())
        lin_card = decode.transformer_beam_decode_fast(params, spec32, few, TF_BEAM, eos,
                                                       lineage=True)[0].cpu()
        lin_cpu = decode.transformer_beam_decode_fast(params_cpu, spec32, few.cpu(), TF_BEAM,
                                                      eos, lineage=True)[0]
    logit_err = max_err(logits_card.cpu(), logits_cpu)
    check(all_finite(logits_card) and logit_err <= LOGIT_TOL
          and torch.equal(logits_card.argmax(-1).cpu(), logits_cpu.argmax(-1)),
          f"Transformer float32 parity greedy card vs CPU: logits err {logit_err}, or "
          "tokens differ")
    fast_card = serving.build_captioner(params, spec32)(few).cpu()
    fast_cpu = serving.build_captioner(params, spec32, device="cpu")(few.cpu())
    check(torch.equal(fast_card, fast_cpu), "Transformer float32 fast greedy tokens "
                                            "differ, card vs CPU")
    check(torch.equal(lin_card, lin_cpu), "Transformer float32 lineage beam-5 tokens "
                                          "differ, card vs CPU")
    dropout = tr.INTERNAL_DROPOUT
    try:
        tr.INTERNAL_DROPOUT = 0.0
        opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
        fns32 = step.build_step_fns("transformer", spec32.with_(dropout_p=0.0), opt,
                                    static_tf=1.0, device="cuda")[0].__self__
        loss_err, grad_err, grad_worst, _ = f32_card_vs_cpu(
            lambda p, bt: fns32.loss(p, bt, 0, 1.0), params,
            train_batch(gen, 2, spec32, torch.float32), "cuda")
    finally:
        tr.INTERNAL_DROPOUT = dropout
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
          f"Transformer float32 train card vs CPU: loss err {loss_err}, gradient err "
          f"{grad_err} ({grad_worst})")

    # bf16 on the card: the lineage bookkeeping equals a physical reorder bit
    # for bit; lineage against gather within the lockstep bound
    lfeats = feats[:TF_LINEAGE_BATCH].to(cd)
    with torch.inference_mode():
        e_out = tr.encode(params, spec, lfeats, tr.create_masks_inp(lfeats))
        step_fn, init, reorder = tr.make_cached_stepper(params, spec, e_out,
                                                        beam_tile=TF_BEAM, lineage=True)
        identity = init["anc"]

        def physical(state, flat_src):
            moved = decode.gather_rows({k: v for k, v in state.items() if k != "anc"},
                                       flat_src)
            return dict(moved, anc=identity)

        runs = [decode.beam_search(step_fn, init, lfeats.shape[0], TF_BEAM, spec.max_len,
                                   spec.sos_id, eos, reorder_fn=fn)
                for fn in (reorder, physical)]
        gap = lineage_lockstep_gap(tr, decode.gather_rows, params, spec, e_out, TF_BEAM,
                                   torch.Generator(device="cuda").manual_seed(42))
        lineage_tokens = decode.transformer_beam_decode_fast(params, spec, lfeats, TF_BEAM,
                                                             eos, lineage=True)[0]
        gather_tokens = decode.transformer_beam_decode_fast(params, spec, lfeats, TF_BEAM,
                                                            eos)[0]
    check(torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1]),
          "bf16 lineage bookkeeping differs from a physical reorder")
    check(gap < TF_LINEAGE_GAP, f"bf16 lineage vs gather lockstep logit gap {gap}")
    differ = (lineage_tokens != gather_tokens).nonzero().tolist()
    emit("transformer_checks", f32_batch=TF_CHECK_BATCH, f32_parity_tokens_card_eq_cpu=True,
         f32_parity_logits_max_abs_err=logit_err, f32_fast_tokens_card_eq_cpu=True,
         f32_lineage_beam_tokens_card_eq_cpu=True, f32_train_loss_err=loss_err,
         f32_train_grad_rel_err=grad_err, f32_train_grad_worst_leaf=grad_worst,
         bf16_lineage_bookkeeping_eq_physical=True, bf16_lockstep_logit_gap=gap,
         bf16_lockstep_gap_bound=TF_LINEAGE_GAP,
         bf16_lineage_vs_gather_cells_differing=len(differ),
         bf16_lineage_vs_gather_cells=lineage_tokens.numel(),
         bf16_lineage_vs_gather_differing_cells=differ[:50])

    # times: best and median of 3, and the peak memory above each call's start
    timing = {}
    for name, (fn, b) in calls.items():
        if name == "sample":
            continue
        best, median = median_best_ms(fn)
        timing[name] = {"batch": b, "ms": best, "ms_median": median,
                        "captions_per_s": b / (best / 1e3),
                        "captions_per_s_median": b / (median / 1e3), **peak_memory(fn)}
    with torch.inference_mode():
        timing["encode_ms_at_fast_batch"] = time_ms(
            lambda: tr.encode(params, spec, feats.to(cd), tr.create_masks_inp(feats)))
    emit("transformer_serving", launches=launches, beam=TF_BEAM, timing=timing,
         nvidia_smi=smi)
    del feats

    # the train step at B=128: no kernel launch, times, memory
    opt = optim.build_optimizer("adam", 2e-3, 4e-5, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("transformer", spec, opt, static_tf=1.0, device="cuda")
    batch = train_batch(gen, TF_TRAIN_BATCH, spec, torch.float32)
    before = params["decoder"]["pred_linear"]["w"].detach().clone()
    step_launches, step_losses = [], []
    for i in range(3):
        (_, _, metrics, _), counts = counted(
            cuda_gru, cuda_lstm, lambda: train(params, state, batch, i, 1.0))
        step_launches.append(counts)
        step_losses.append(metrics["loss"].item())
    remat_train, _ = step.build_step_fns("transformer", spec, opt, static_tf=1.0,
                                         remat=True, device="cuda")
    _, remat_launches = counted(cuda_gru, cuda_lstm,
                                lambda: remat_train(params, state, batch, 3, 1.0))
    check(all(c == expected_counts(0) for c in step_launches + [remat_launches]),
          f"Transformer train steps launched {step_launches}, {remat_launches}")
    check(all(math.isfinite(x) for x in step_losses)
          and not torch.equal(before, params["decoder"]["pred_linear"]["w"]),
          f"Transformer losses {step_losses}, or pred_linear.w did not move")
    emit("transformer_train", batch=TF_TRAIN_BATCH, losses=step_losses,
         launches_per_step=step_launches[-1], remat_launches_per_step=remat_launches,
         timing=step_timing(train, params, state, batch, opt),
         phase_seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return {**launches, "train": step_launches[-1], "train_remat": remat_launches,
            "timing": timing}


# The daemon's load, run in a process of its own so the clients do not share
# the daemon's interpreter lock: argv url, requests, threads, batch rows,
# seed, frames, feature width; prints {"seconds", "singles": [[tokens,
# latency s]], "batch": [tokens | null]}. The features are the parent's: the
# same seed.
LOAD_CLIENT = r"""
import concurrent.futures, json, sys, time
import numpy as np
from vcr_tpu_torch.client import CaptionClient

url = sys.argv[1]
n, threads, batch, seed, frames, width = map(int, sys.argv[2:8])
feats = np.random.default_rng(seed).standard_normal((n + batch, frames, width),
                                                    dtype=np.float32)
client = CaptionClient(url, timeout_s=600, retries=0)


def one(i):
    t = time.perf_counter()
    tokens, _ = client.caption(feats[i])
    return tokens, time.perf_counter() - t


t0 = time.perf_counter()
with concurrent.futures.ThreadPoolExecutor(threads + 1) as ex:
    batch_future = ex.submit(client.caption_batch, feats[n:])
    singles = [f.result() for f in [ex.submit(one, i) for i in range(n)]]
    rows = batch_future.result()
json.dump({"seconds": time.perf_counter() - t0, "singles": singles,
           "batch": [None if r is None else r[0] for r in rows]}, sys.stdout)
"""


def cut_at_eos(row, eos):
    """A token row up to and including its first eos, as a list."""
    row = list(row)
    return row[: row.index(eos) + 1] if eos in row else row


def token_agreement(got, want):
    """Share of token positions equal over pairs of token lists, each pair
    counted over the longer of the two."""
    total = sum(max(len(g), len(w)) for g, w in zip(got, want))
    same = sum(sum(a == b for a, b in zip(g, w)) for g, w in zip(got, want))
    return same / total


def admission_kernels(cuda_gru, cuda_lstm, spec):
    """B1 and B2 at the admission chunk's shapes: each against its plain
    version in bf16 and float32 (phase 3's bounds, both LSTM directions),
    then bf16 times beside the bound, the plain version and cuDNN (with the
    input projection, timed alone too)."""
    from vcr_tpu_torch.nn.layers import vdot

    hidden, frames, cd = spec.hidden_size, spec.num_frames, torch.bfloat16
    cases, failures, timing = [], [], {"gru_seq": {}, "lstm_seq": {}}
    for dtype, gtol, ltol in ((torch.bfloat16, BF16_TOL, LSTM_BF16_TOL),
                              (torch.float32, F32_TOL, LSTM_F32_TOL)):
        name = str(dtype).split(".")[-1]
        for b in CONT_ADMIT_BATCHES:
            args = gru_inputs(frames, b, hidden, dtype, seed=100 + b)
            tc = cuda_gru.launches_tc
            got = cuda_gru.gru_recurrence_cuda(*args, dtype)
            tc = cuda_gru.launches_tc - tc
            runs = [("gru_seq", None, got, cuda_gru.gru_recurrence_plain(*args, dtype),
                     tc, gtol)]
            for reverse in (False, True):
                largs = lstm_inputs(frames, b, hidden, dtype, seed=200 + b)
                tc = cuda_lstm.launches_tc
                lgot = cuda_lstm.lstm_recurrence_cuda(*largs, dtype, reverse)
                tc = cuda_lstm.launches_tc - tc
                runs.append(("lstm_seq", reverse, lgot,
                             cuda_lstm.lstm_recurrence_plain(*largs, dtype, reverse), tc,
                             ltol))
            torch.cuda.synchronize()
            for kernel, reverse, out, want, tc, tol in runs:
                err = max_err(out, want)
                cases.append({"kernel": kernel, "dtype": name, "steps": frames, "batch": b,
                              "reverse": reverse,
                              "body": "tensor-core" if tc else "scalar",
                              "max_abs_err": err, "tolerance": tol})
                if not (all_finite(out) and err <= tol):
                    failures.append(f"{kernel} at B={b} {name} reverse={reverse}: err {err}")
                if tc != int(dtype == torch.bfloat16):
                    failures.append(f"{kernel} at B={b} {name} ran the wrong body")
    check(not failures, "; ".join(failures))
    g = torch.Generator(device="cuda").manual_seed(7)
    gru = torch.nn.GRU(spec.vid_feat_size, hidden).to("cuda", cd)
    lstm = torch.nn.LSTM(spec.vid_feat_size, hidden).to("cuda", cd)
    w_ih = torch.randn((spec.vid_feat_size, 3 * hidden), generator=g, device="cuda")
    for b in CONT_ADMIT_BATCHES:
        xs = torch.randn((frames, b, spec.vid_feat_size), generator=g, device="cuda").to(cd)
        projection_ms = time_ms(lambda: vdot(xs.reshape(-1, xs.shape[-1]), w_ih, cd))
        with torch.inference_mode():
            args = gru_inputs(frames, b, hidden, cd, seed=100 + b)
            bound, by = gru_bound_ms(frames, b, hidden, PEAKS)
            timing["gru_seq"][b] = {
                "ms": time_ms(lambda: cuda_gru.gru_recurrence_cuda(*args, cd), iters=5),
                "plain_ms": time_ms(lambda: cuda_gru.gru_recurrence_plain(*args, cd)),
                "bound_ms": bound, "bound_by": by, "library_ms": time_ms(lambda: gru(xs)),
                "library": "torch.nn.GRU (cuDNN), input projection included",
                "projection_ms": projection_ms}
            largs = lstm_inputs(frames, b, hidden, cd, seed=200 + b)
            bound, by = lstm_bound_ms(frames, b, hidden, PEAKS)
            timing["lstm_seq"][b] = {
                "ms": time_ms(lambda: cuda_lstm.lstm_recurrence_cuda(*largs, cd, False),
                              iters=5),
                "plain_ms": time_ms(lambda: cuda_lstm.lstm_recurrence_plain(*largs, cd,
                                                                            False)),
                "bound_ms": bound, "bound_by": by, "library_ms": time_ms(lambda: lstm(xs)),
                "library": "torch.nn.LSTM (cuDNN), one direction, input projection "
                           "included", "projection_ms": projection_ms}
    return cases, timing


def continuous_phase(cuda_gru, cuda_lstm, smi, tf_timing):
    """Phase 11: B1 and B2 at the admission shapes, the HTTP daemon over
    the flagship S2VT's slot pool under concurrent clients, the
    Transformer's and RationaleNet's pools; returns what the kernels line
    reports of it."""
    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.client import CaptionClient
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.server import CaptionServer
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    t_phase = time.perf_counter()
    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
    frames, eos = spec.num_frames, spec.sos_id + 1
    cases, kernel_timing = admission_kernels(cuda_gru, cuda_lstm, spec)
    emit("continuous_kernels", cases=cases, timing=kernel_timing, nvidia_smi=smi)

    # the daemon under load from a client process: the counts set to 0 just
    # before, read just after
    seed, width = 11, spec.vid_feat_size
    feats = np.random.default_rng(seed).standard_normal(
        (CONT_REQUESTS + CONT_BATCH, frames, width), dtype=np.float32)
    pool = ContinuousCaptioner(params, spec, slots=CONT_SLOTS, admit_chunk=CONT_ADMIT)
    with CaptionServer(pool, port=0) as server:
        url = f"http://127.0.0.1:{server.port}"
        client = CaptionClient(url, timeout_s=600, retries=0)
        client.caption(feats[0])                      # first use of the card's pool
        before = client.health()
        reset_counts(cuda_gru, cuda_lstm)
        load = subprocess.run(
            [sys.executable, "-c", LOAD_CLIENT, url] + [str(x) for x in (
                CONT_REQUESTS, CONT_THREADS, CONT_BATCH, seed, frames, width)],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        torch.cuda.synchronize()
        daemon_launches = launch_counts(cuda_gru, cuda_lstm)
        after = client.health()
        error = server.error
    check(load.returncode == 0, f"the client process failed: {load.stderr[-2000:]}")
    load = json.loads(load.stdout)
    wall, singles = load["seconds"], load["singles"]
    responses = [t for t, _ in singles] + load["batch"]
    check(error is None, f"the daemon's scheduler failed: {error}")
    nulls = sum(r is None for r in responses)
    check(nulls == 0, f"{nulls} null responses of {len(responses)}")
    stats = {k: after[k] - before[k] for k in ("ticks", "admit_chunks", "served",
                                               "useful_steps", "slot_steps")}
    check(daemon_launches == expected_counts(b1=2 * stats["admit_chunks"]),
          f"the daemon launched {daemon_launches} in {stats['admit_chunks']} admission "
          "chunks, not B1 twice per chunk on the tensor-core body and nothing else")
    with torch.inference_mode():
        batch_tokens = serving.build_captioner(params, spec)(feats).cpu().numpy()
    agreement = token_agreement(responses, [cut_at_eos(r, eos) for r in batch_tokens])
    check(agreement >= CONT_TOKEN_AGREEMENT,
          f"daemon against batch greedy: {agreement} of the tokens equal")
    latency = sorted(dt for _, dt in singles)
    spec32 = spec.with_(compute_dtype="float32")
    f32 = [ContinuousCaptioner(params_to(params, d), spec32, slots=CONT_CHECK_SLOTS,
                               admit_chunk=2, device=d).caption_all(
               dict(enumerate(feats[:2 * CONT_CHECK_SLOTS]))) for d in ("cuda", "cpu")]
    check(all(f32[0][k].tolist() == f32[1][k].tolist() for k in f32[1]),
          "float32 pool tokens differ, card vs CPU")
    emit("continuous_daemon", slots=CONT_SLOTS, admit_chunk=CONT_ADMIT,
         requests=CONT_REQUESTS, client_threads=CONT_THREADS, batch_request_rows=CONT_BATCH,
         seconds=wall, captions_per_s=len(responses) / wall,
         client_latency_p50_ms=1e3 * latency[len(latency) // 2],
         client_latency_p99_ms=1e3 * latency[int(len(latency) * 0.99)],
         daemon_latency_p50_ms=after.get("latency_p50_ms"),
         daemon_latency_p95_ms=after.get("latency_p95_ms"), stats=stats,
         occupancy=stats["useful_steps"] / stats["slot_steps"],
         mean_caption_tokens=stats["useful_steps"] / stats["served"],
         launches=daemon_launches, token_agreement_vs_batch_greedy=agreement,
         token_agreement_bound=CONT_TOKEN_AGREEMENT,
         f32_check_slots=CONT_CHECK_SLOTS, f32_tokens_card_eq_cpu=True, nvidia_smi=smi)

    # the Transformer's pool: greedy, lineage beam 5; no kernel launch
    tspec, tparams = entry.make_spec_and_params(**entry.TRANSFORMER, device="cuda")
    tf_runs = {}
    for name, slots, beam in (("greedy", TF_CONT_SLOTS, 1),
                              ("beam_lineage", TF_CONT_BEAM_SLOTS, TF_BEAM)):
        tpool = ContinuousCaptioner(tparams, tspec, slots=slots, admit_chunk=CONT_ADMIT,
                                    beam_size=beam)
        tpool.caption_all(dict(enumerate(feats[:CONT_ADMIT])))      # first use
        t0 = time.perf_counter()
        out, counts = counted(cuda_gru, cuda_lstm, lambda: tpool.caption_all(
            dict(enumerate(feats[:slots]))))
        dt = time.perf_counter() - t0
        check(counts == expected_counts(0) and len(out) == slots,
              f"the Transformer's {name} pool launched {counts} or lost requests")
        tokens = sum(len(t) for t in out.values())
        tf_runs[name] = {"slots": slots, "beam": beam, "requests": slots, "seconds": dt,
                         "captions_per_s": slots / dt, "tokens_per_s": tokens / dt,
                         "mean_caption_tokens": tokens / slots, "launches": counts}
    batch_ms = tf_timing["greedy"]["ms"]
    tf_runs["phase10_kv_cached_greedy"] = {
        "batch": TF_FAST_BATCH, "ms": batch_ms,
        "captions_per_s": TF_FAST_BATCH / (batch_ms / 1e3),
        "tokens_per_s": TF_FAST_BATCH * tspec.max_len / (batch_ms / 1e3)}
    tspec32 = tspec.with_(compute_dtype="float32")
    tf32 = [ContinuousCaptioner(params_to(tparams, d), tspec32, slots=CONT_CHECK_SLOTS,
                                admit_chunk=2, device=d).caption_all(
                dict(enumerate(feats[:CONT_CHECK_SLOTS]))) for d in ("cuda", "cpu")]
    check(all(tf32[0][k].tolist() == tf32[1][k].tolist() for k in tf32[1]),
          "the Transformer's float32 pool tokens differ, card vs CPU")
    emit("continuous_transformer", runs=tf_runs, f32_check_slots=CONT_CHECK_SLOTS,
         f32_tokens_card_eq_cpu=True, nvidia_smi=smi)
    del tparams

    # RationaleNet's pool: B2 and B1 twice per admission chunk
    rspec, rparams = entry.make_spec_and_params(**entry.RATIONALE, device="cuda")
    rpool = ContinuousCaptioner(rparams, rspec, slots=RATIONALE_CONT_SLOTS,
                                admit_chunk=CONT_ADMIT)
    rpool.caption_all(dict(enumerate(feats[:CONT_ADMIT])))           # first use
    chunks = rpool.stats["admit_chunks"]
    t0 = time.perf_counter()
    out, rationale_launches = counted(cuda_gru, cuda_lstm, lambda: rpool.caption_all(
        dict(enumerate(feats[:RATIONALE_CONT_SLOTS]))))
    dt = time.perf_counter() - t0
    chunks = rpool.stats["admit_chunks"] - chunks
    check(rationale_launches == expected_counts(b1=2 * chunks, b2=2 * chunks)
          and len(out) == RATIONALE_CONT_SLOTS,
          f"RationaleNet's pool launched {rationale_launches} in {chunks} chunks, not B2 "
          "and B1 twice per chunk, or lost requests")
    emit("continuous_rationale", slots=RATIONALE_CONT_SLOTS, admit_chunk=CONT_ADMIT,
         requests=RATIONALE_CONT_SLOTS, admit_chunks=chunks, seconds=dt,
         captions_per_s=RATIONALE_CONT_SLOTS / dt, launches=rationale_launches,
         phase_seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return {"daemon": daemon_launches, "daemon_admit_chunks": stats["admit_chunks"],
            "rationale": rationale_launches, "rationale_admit_chunks": chunks,
            "kernel_cases": cases, "kernel_timing": kernel_timing}


def cache_bytes(state) -> dict:
    """Bytes of a Transformer slot state's caches, read off its tensors:
    the self ("c*") and cross ("x*") K/V, codes and scales apart."""
    out = {"self_codes": 0, "self_scales": 0, "cross_codes": 0, "cross_scales": 0}
    for name, leaves in state.items():
        if name == "anc":
            continue
        side = "self" if name.startswith("c") else "cross"
        for t in leaves:
            kind = "scales" if t.dtype == torch.float32 else "codes"
            out[f"{side}_{kind}"] += t.numel() * t.element_size()
    return out


def quantized_phase(cuda_gru, cuda_lstm, smi):
    """Phase 12: the quantized serving modes at full width: the
    Transformer's KV-cached greedy in each mode, its lineage beam under an
    int8 cache, the int8-weight pools of the flagship S2VT and of
    RationaleNet, and float32 card against CPU in every mode; returns the
    W8 pools' launch counts for the kernels line."""
    from vcr_tpu_torch import decode, entry, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import transformer as tr
    from vcr_tpu_torch.ops import kvquant
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    t_phase = time.perf_counter()
    spec, params = entry.make_spec_and_params(**entry.TRANSFORMER, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    feats = torch.randn((TF_FAST_BATCH, spec.num_frames, spec.vid_feat_size),
                        generator=gen, device="cuda")
    heads, d_k = spec.tf_heads, tr._attn_hidden(params["decoder"]["layers"]) // spec.tf_heads
    with torch.inference_mode():
        e_out = tr.encode(params, spec, feats.to(spec.cdtype),
                          tr.create_masks_inp(feats))
    runs, base = {}, None
    for kv, dw in QUANT_MODES:
        name = f"{kv}_kv_{dw}_weights"
        cap = serving.build_captioner(params, spec, kv_cache=kv, decode_weights=dw)
        tokens, counts = counted(cuda_gru, cuda_lstm, lambda: cap(feats))
        check(counts == expected_counts(0) and tokens.shape == (TF_FAST_BATCH, spec.max_len),
              f"the Transformer's {name} greedy launched {counts} or gave {tokens.shape}")
        best, median = median_best_ms(lambda: cap(feats))
        _, init_self, cross = tr.make_slot_stepper(params, spec, kv_cache=kv,
                                                   decode_weights=dw)
        with torch.inference_mode():
            nbytes = cache_bytes({**init_self(TF_FAST_BATCH), **cross(e_out)})
        base = tokens if base is None else base
        runs[name] = {"kv_cache": kv, "decode_weights": dw, "best_ms": best,
                      "median_ms": median, "captions_per_s": TF_FAST_BATCH / (best / 1e3),
                      "cache_bytes": nbytes,
                      "token_agreement_vs_bf16": (tokens == base).float().mean().item(),
                      "launches": counts}
        del cap
    # the cache bytes against the arithmetic: codes a half (int8) or a
    # quarter (int4) of bf16's, plus one float32 scale per vector
    vectors = {"self": TF_FAST_BATCH * heads * spec.max_len * 2 * spec.tf_layers,
               "cross": TF_FAST_BATCH * heads * spec.num_frames * 2 * spec.tf_layers}
    bf16 = runs["bf16_kv_bf16_weights"]["cache_bytes"]
    for name, run in runs.items():
        got, divide = run["cache_bytes"], {"bf16": 1, "int8": 2, "int4": 4}[run["kv_cache"]]
        for side in ("self", "cross"):
            check(got[f"{side}_codes"] * divide == bf16[f"{side}_codes"]
                  == vectors[side] * d_k * 2
                  and got[f"{side}_scales"] == (0 if divide == 1 else vectors[side] * 4),
                  f"{name}: {side} cache bytes {got} against bf16's {bf16}")
        run["cache_bytes_ratio_vs_bf16"] = sum(got.values()) / sum(bf16.values())

    # the lineage beam 5 under an int8 cache
    beam_feats = feats[:TF_BEAM_BATCH].to(spec.cdtype)

    def lineage():
        with torch.inference_mode():
            return decode.transformer_beam_decode_fast(params, spec, beam_feats, TF_BEAM,
                                                       spec.sos_id + 1, lineage=True,
                                                       kv_cache="int8")
    (btok, bscores), bcounts = counted(cuda_gru, cuda_lstm, lineage)
    check(bcounts == expected_counts(0) and btok.shape == (TF_BEAM_BATCH, TF_BEAM,
                                                           spec.max_len)
          and all_finite(bscores), f"the int8 lineage beam launched {bcounts}")
    bbest, bmedian = median_best_ms(lineage)
    runs["lineage_beam5_int8_kv"] = {"batch": TF_BEAM_BATCH, "beam": TF_BEAM,
                                     "best_ms": bbest, "median_ms": bmedian,
                                     "captions_per_s": TF_BEAM_BATCH / (bbest / 1e3),
                                     "launches": bcounts}

    # float32 card against CPU in every mode, at a small batch: codes,
    # tokens and logits
    # the quantizers themselves on identical inputs, card against CPU: the
    # K/V codes and scales of every mode (a zero vector and exact ties
    # included) and the decoder's int8 weights, bit for bit
    qgen = torch.Generator().manual_seed(15)
    vecs = torch.randn((64, 8, 20, d_k), generator=qgen) * 3
    vecs[0, 0, 0] = 0.0
    halves = (torch.arange(d_k) % 7 + 0.5) * (1 - 2 * (torch.arange(d_k) % 2))
    vecs[1, 0, 0], vecs[1, 0, 1] = halves, halves              # amax 7: ties under
    vecs[1, 0, 0, 0], vecs[1, 0, 1, 0] = 7.0, 127.0          # int4; 127: under int8
    for mode in ("int8", "int4"):
        got = kvquant.quantize_store(vecs.cuda(), mode)
        want = kvquant.quantize_store(vecs, mode)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"{mode} K/V codes or scales of identical inputs differ, card vs CPU")
    wq_card = tr.quantize_decoder_params(params)["decoder"]
    wq_cpu = tr.quantize_decoder_params(params_to(params, "cpu"))["decoder"]
    check(all(torch.equal(wq_card[k]["wq"].cpu(), wq_cpu[k]["wq"])
              and torch.equal(wq_card[k]["ws"].cpu(), wq_cpu[k]["ws"])
              for k in ("pred_linear",))
          and torch.equal(wq_card["layers"]["ff"]["linear_1"]["wq"].cpu(),
                          wq_cpu["layers"]["ff"]["linear_1"]["wq"]),
          "int8 decode weights of identical weights differ, card vs CPU")
    del wq_card, wq_cpu

    spec32 = spec.with_(compute_dtype="float32")
    encoded = []
    for device in ("cuda", "cpu"):
        p = params_to(params, device)
        x = feats[:QUANT_CHECK_BATCH].to(device)
        with torch.inference_mode():
            encoded.append((device, p, tr.encode(p, spec32, x, tr.create_masks_inp(x))))
    last = f"c{spec.tf_layers - 1}"
    f32_gap = {}
    for kv, dw in QUANT_MODES:
        per_device = []
        for device, p, eo in encoded:
            with torch.inference_mode():
                step, st = tr.make_cached_stepper(p, spec32, eo, kv_cache=kv,
                                                  decode_weights=dw)
                words = torch.full((QUANT_CHECK_BATCH,), spec.sos_id, dtype=torch.int32,
                                   device=device)
                logits, toks = [], []
                for i in range(spec.max_len):
                    st, lg = step(st, words, i)
                    words = lg.argmax(-1).to(torch.int32)
                    logits.append(lg.cpu())
                    toks.append(words.cpu())
            per_device.append((torch.stack(logits), torch.stack(toks),
                               [t.cpu() for t in st[last] if t.dtype != torch.float32]))
        (cl, ct, cc), (pl, pt, pc) = per_device
        # the card's float32 sums differ from the CPU's in their last bits,
        # and 6 layers and 20 steps carry that on: a code whose value sits
        # near a rounding boundary moves by one step, and then the logits by
        # up to the JAX package's envelope of the mode
        # (tests/test_kv_quant.py:185); codes 2 or more apart are a fault
        code_gap = [(kvquant.unpack(a).int() - kvquant.unpack(b).int()).abs()
                    for a, b in zip(cc, pc)]
        flipped = sum(int((g > 0).sum()) for g in code_gap)
        n_codes = sum(g.numel() for g in code_gap)
        bound = LOGIT_TOL if flipped == 0 else QUANT_ENVELOPE[kv]
        f32_gap[f"{kv}_kv_{dw}_weights"] = {"logits": max_err(cl, pl), "logit_bound": bound,
                                             "codes_one_step_apart": flipped,
                                             "codes": n_codes}
        check(torch.equal(ct, pt) and max_err(cl, pl) <= bound
              and all(int(g.max()) <= 1 for g in code_gap if g.numel())
              and flipped <= QUANT_CODE_FLIPS * n_codes,
              f"float32 {kv}/{dw} card vs CPU: tokens, codes ({flipped} of {n_codes}) "
              f"or logits ({max_err(cl, pl)}) differ")
    emit("quantized_transformer", batch=TF_FAST_BATCH, runs=runs,
         f32_check_batch=QUANT_CHECK_BATCH, f32_logit_gap=f32_gap,
         f32_tokens_card_eq_cpu=True, f32_code_flip_bound=QUANT_CODE_FLIPS,
         quantizers_card_eq_cpu_bit_for_bit=True,
         nvidia_smi=smi)
    del params, e_out, encoded

    # the int8-weight pools: the flagship S2VT's (B1 twice per admission
    # chunk) against its bf16 pool, RationaleNet's (B2 and B1 twice)
    pools = {}
    np_feats = np.random.default_rng(14).standard_normal(
        (CONT_SLOTS, spec.num_frames, spec.vid_feat_size), dtype=np.float32)
    for name, cfg, slots in (("s2vt", entry.FLAGSHIP, CONT_SLOTS),
                             ("rationale", entry.RATIONALE, RATIONALE_CONT_SLOTS)):
        pspec, pparams = entry.make_spec_and_params(**cfg, device="cuda")
        requests = dict(enumerate(np_feats[:slots]))
        out = {}
        for dw in ("bf16", "int8"):
            pool = ContinuousCaptioner(pparams, pspec, slots=slots, admit_chunk=CONT_ADMIT,
                                       decode_weights=dw)
            pool.caption_all(dict(enumerate(np_feats[:CONT_ADMIT])))        # first use
            chunks = pool.stats["admit_chunks"]
            t0 = time.perf_counter()
            got, counts = counted(cuda_gru, cuda_lstm, lambda: pool.caption_all(requests))
            dt = time.perf_counter() - t0
            chunks = pool.stats["admit_chunks"] - chunks
            want = expected_counts(b1=2 * chunks, b2=2 * chunks if name == "rationale" else 0)
            check(counts == want and len(got) == slots,
                  f"the {name} {dw}-weight pool launched {counts} in {chunks} chunks, "
                  f"not {want}, or lost requests")
            out[dw] = {"tokens": got, "seconds": dt, "captions_per_s": slots / dt,
                       "admit_chunks": chunks, "launches": counts}
            del pool
        agreement = token_agreement([out["int8"]["tokens"][k] for k in requests],
                                    [out["bf16"]["tokens"][k] for k in requests])
        pools[name] = {"slots": slots, "admit_chunk": CONT_ADMIT,
                       "token_agreement_int8_vs_bf16": agreement,
                       **{dw: {k: v for k, v in o.items() if k != "tokens"}
                          for dw, o in out.items()}}
        del pparams
    emit("quantized_pools", pools=pools, phase_seconds=time.perf_counter() - t_phase,
         nvidia_smi=smi)
    return {"s2vt_w8": pools["s2vt"]["int8"]["launches"],
            "s2vt_w8_admit_chunks": pools["s2vt"]["int8"]["admit_chunks"],
            "rationale_w8": pools["rationale"]["int8"]["launches"],
            "rationale_w8_admit_chunks": pools["rationale"]["int8"]["admit_chunks"]}


# the serving host of phase 13: a child process that imports torch, numpy and
# the op library only, loads the flagship's artifact by the recipe of
# export_serving's docstring, and captions on the card
ARTIFACT_HOST = r"""
import json, os, sys, time
import numpy as np
import torch
import vcr_tpu_torch.ops.library  # registers the ops
from torch.export.passes import move_to_device_pass
from vcr_tpu_torch.ops import _build, cuda_gru, cuda_lstm

art, feats_path, out_path = sys.argv[1:4]
t0 = time.perf_counter()
with open(os.path.join(art, "meta.json")) as f:
    meta = json.load(f)
for name, digest in meta["kernel_sources"].items():
    assert _build.source_digest(_build.CSRC / f"{name}.cu") == digest, name
program = move_to_device_pass(torch.export.load(os.path.join(art, "serving_fn.pt2")),
                              torch.device("cuda")).module()
with np.load(os.path.join(art, "weights.npz")) as w:
    leaves = [torch.from_numpy(w[k]).to("cuda", getattr(torch, dt))
              for k, dt in zip(sorted(w.files), meta["leaf_dtypes"])]
assert meta["draws"]["plan"] == [] and not meta["float32_conv"]
feats = torch.from_numpy(np.load(feats_path)).cuda()
torch.cuda.synchronize()
load_s = time.perf_counter() - t0


def caption(x):
    with torch.no_grad():
        return program(leaves, x, [])


def counts():
    return {"gru_seq": cuda_gru.launches, "gru_seq_bt": cuda_gru.launches_bt,
            "gru_seq_dma": cuda_gru.launches_dma, "gru_seq_tc": cuda_gru.launches_tc,
            "lstm_seq": cuda_lstm.launches}


def best_median(fn):
    fn()
    runs = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
    runs.sort()
    return runs[0], runs[1]


first_s = time.perf_counter()
tokens = caption(feats)
torch.cuda.synchronize()
first_s = time.perf_counter() - first_s
before = counts()
tokens = caption(feats)
torch.cuda.synchronize()
launches = {k: v - before[k] for k, v in counts().items()}
one = feats[:1].contiguous()
np.save(out_path, tokens.cpu().numpy())
mods = sorted(m for m in sys.modules if m.startswith("vcr_tpu_torch"))
print(json.dumps({"load_s": load_s, "first_call_s": first_s, "launches": launches,
                  "ms": best_median(lambda: caption(feats)),
                  "ms_b1": best_median(lambda: caption(one)), "modules": mods}))
"""
# the package's modules a serving host of an exported program imports
HOST_MODULES = {"vcr_tpu_torch", "vcr_tpu_torch.ops", "vcr_tpu_torch.ops._build",
                "vcr_tpu_torch.ops.cuda_gru", "vcr_tpu_torch.ops.cuda_lstm",
                "vcr_tpu_torch.ops.library", "vcr_tpu_torch.nn", "vcr_tpu_torch.nn.init",
                "vcr_tpu_torch.nn.layers", "vcr_tpu_torch.nn.rnn"}


def dir_bytes(path) -> dict:
    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def first_difference(got, want) -> dict:
    """Agreement of two token tensors and their first differing cell."""
    same = got == want
    where = (~same).nonzero()
    first = None
    if len(where):
        r, c = where[0].tolist()
        first = {"row": r, "col": c, "got": int(got[r, c]), "want": int(want[r, c])}
    return {"agreement": same.float().mean().item(), "first_difference": first}


TF_EXPORT_WORKER = r"""
import json, os, sys, time
os.nice(10)
import torch
torch.set_num_threads(2)
from vcr_tpu_torch import entry, export_serving

spec, params = entry.make_spec_and_params(**entry.TRANSFORMER, device="cpu")
t0 = time.perf_counter()
export_serving.export_captioner(params, spec, sys.argv[1], device="cpu")
print(json.dumps({"export_s": time.perf_counter() - t0}), flush=True)
"""


def start_tf_export():
    """Phase 13's Transformer artifact, exported on the CPU by a child process
    that sees no card, from the weights phase 13 draws (entry's seed), beside
    the phases before it -> (process, artifact directory, log path). The
    child is killed, and its directory removed, at exit."""
    root = tempfile.mkdtemp(prefix="vcr_tf_export_")
    log = open(os.path.join(root, "export.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", TF_EXPORT_WORKER, os.path.join(root, "transformer")],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
        stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(root, ignore_errors=True)
    atexit.register(stop)
    return proc, os.path.join(root, "transformer"), log.name


def artifact_phase(cuda_gru, cuda_lstm, smi, tf_export):
    """Phase 13: the deployable artifacts, exported on the CPU and run on the
    card; ``tf_export`` is :func:`start_tf_export`'s. Returns what the
    kernels line reports of it."""
    from vcr_tpu_torch import entry, export_continuous, export_serving, serving
    from vcr_tpu_torch.client import CaptionClient
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vcr_artifacts_")
    out = {}
    try:
        # 1. the flagship, served from a child process that loads no model code
        spec, params_cpu = entry.make_spec_and_params(**entry.FLAGSHIP, device="cpu")
        params = params_to(params_cpu, "cuda")
        art = os.path.join(root, "flagship")
        t0 = time.perf_counter()
        export_serving.export_captioner(params_cpu, spec, art, device="cpu")
        export_s = time.perf_counter() - t0
        feats = np.random.default_rng(13).standard_normal(
            (TIMING_BATCH, spec.num_frames, spec.vid_feat_size), dtype=np.float32)
        feats_path, tokens_path = os.path.join(root, "feats.npy"), os.path.join(root,
                                                                                 "tok.npy")
        np.save(feats_path, feats)
        host = subprocess.run([sys.executable, "-c", ARTIFACT_HOST, art, feats_path,
                               tokens_path],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        check(host.returncode == 0, f"the artifact host failed: {host.stderr[-3000:]}")
        host = json.loads(host.stdout.strip().splitlines()[-1])
        extra = sorted(set(host["modules"]) - HOST_MODULES)
        check(not extra, f"the artifact host imported model code: {extra}")
        live = serving.build_captioner(params, spec)
        fc = torch.from_numpy(feats).cuda()
        want = live(fc).cpu()
        got = torch.from_numpy(np.load(tokens_path))
        diff = first_difference(got, want)
        emit("artifact_flagship_tokens", batch=TIMING_BATCH, **diff)
        check(torch.equal(got, want), f"the flagship artifact's tokens differ from the "
                                      f"live call's: {diff}")
        want_launches = {"gru_seq": 2, "gru_seq_bt": 0, "gru_seq_dma": 0, "gru_seq_tc": 2,
                         "lstm_seq": 0}
        check(host["launches"] == want_launches,
              f"the flagship artifact launched {host['launches']} in a call")
        live_ms = median_best_ms(lambda: live(fc))
        live_b1_ms = median_best_ms(lambda: live(fc[:1]))
        out["flagship"] = host["launches"]
        emit("artifact_flagship", batch=TIMING_BATCH, export_s=export_s,
             files_bytes=dir_bytes(art), exported_on="cpu", host_modules=host["modules"],
             load_s=host["load_s"], first_call_s=host["first_call_s"],
             launches_per_call=host["launches"],
             artifact_ms_best_median=host["ms"], live_ms_best_median=live_ms,
             artifact_b1_ms_best_median=host["ms_b1"], live_b1_ms_best_median=live_b1_ms,
             captions_per_s=TIMING_BATCH / (host["ms"][0] / 1e3),
             live_captions_per_s=TIMING_BATCH / (live_ms[0] / 1e3), nvidia_smi=smi)

        # 2.-3. RationaleNet (its selection noise an input, drawn by the
        # loader), S2VT beam 5 and the Transformer's KV-cached greedy
        cases = (("rationale", entry.RATIONALE, RATIONALE_BATCH, {}, {"gru_seq": 2,
                                                                      "lstm_seq": 2}),
                 ("s2vt_beam5", entry.FLAGSHIP, ART_BEAM_BATCH, {"beam_size": 5},
                  {"gru_seq": 2, "lstm_seq": 0}),
                 ("transformer", entry.TRANSFORMER, TF_FAST_BATCH, {},
                  {"gru_seq": 0, "lstm_seq": 0}))
        for name, dims, batch, kw, launches_want in cases:
            cspec, cparams_cpu = entry.make_spec_and_params(**dims, device="cpu")
            cparams = params_to(cparams_cpu, "cuda")
            t0 = time.perf_counter()
            if name == "transformer":
                # exported by the child since the build: wait for it
                proc, cart, log = tf_export
                try:
                    rc = proc.wait(timeout=TF_EXPORT_WAIT_S)
                except subprocess.TimeoutExpired:
                    rc = None
                with open(log) as f:
                    lines = f.read().splitlines()
                check(rc == 0, f"the Transformer artifact's export (rc {rc}):\n"
                               + "\n".join(lines[-30:]))
                export_s = json.loads(lines[-1])["export_s"]
            else:
                cart = os.path.join(root, name)
                export_serving.export_captioner(cparams_cpu, cspec, cart, device="cpu",
                                                **kw)
                export_s = time.perf_counter() - t0
            waited_s = time.perf_counter() - t0
            del cparams_cpu
            t0 = time.perf_counter()
            loaded = export_serving.load_artifact(cart, device="cuda")
            load_s = time.perf_counter() - t0
            x = torch.from_numpy(np.random.default_rng(batch).standard_normal(
                (batch, cspec.num_frames, cspec.vid_feat_size), dtype=np.float32)).cuda()
            clive = serving.build_captioner(cparams, cspec, **kw)
            want = clive(x)
            reset_counts(cuda_gru, cuda_lstm)
            got = loaded(x)
            torch.cuda.synchronize()
            counts = launch_counts(cuda_gru, cuda_lstm)
            diff = first_difference(got.cpu(), want.cpu())
            emit(f"artifact_{name}_tokens", batch=batch, **diff)
            check(torch.equal(got, want), f"the {name} artifact's tokens differ from the "
                                          f"live call's: {diff}")
            check({k: counts[k] for k in launches_want} == launches_want
                  and counts["gru_seq_bt"] == counts["gru_seq_dma"] == 0,
                  f"the {name} artifact launched {counts} in a call")
            out[name] = counts
            emit(f"artifact_{name}", batch=batch, export_s=export_s, waited_s=waited_s,
                 load_s=load_s,
                 files_bytes=dir_bytes(cart), draws=loaded.meta["draws"],
                 launches_per_call=counts,
                 artifact_ms_best_median=median_best_ms(lambda: loaded(x)),
                 live_ms_best_median=median_best_ms(lambda: clive(x)), nvidia_smi=smi)
            del loaded, clive, cparams

        # 4. the frozen flagship pool against the live pool, then --mode serve
        # on the artifact directory
        pool_dir = os.path.join(root, "pool")
        t0 = time.perf_counter()
        export_continuous.export_continuous(params_cpu, spec, pool_dir, slots=CONT_SLOTS,
                                            admit_chunk=CONT_ADMIT, device="cpu")
        pool_export_s = time.perf_counter() - t0
        frozen = export_continuous.load_continuous(pool_dir, device="cuda")
        livepool = ContinuousCaptioner(params, spec, slots=CONT_SLOTS,
                                       admit_chunk=CONT_ADMIT)
        reqs = {i: f for i, f in enumerate(np.random.default_rng(14).standard_normal(
            (CONT_REQUESTS, spec.num_frames, spec.vid_feat_size), dtype=np.float32))}
        frozen.caption_all({0: reqs[0]})                      # first use
        livepool.caption_all({0: reqs[0]})
        pools = {}
        for label, pool in (("frozen", frozen), ("live", livepool), ("frozen", frozen),
                            ("live", livepool)):
            chunks = pool.stats["admit_chunks"]
            reset_counts(cuda_gru, cuda_lstm)
            t0 = time.perf_counter()
            result = pool.caption_all(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts(cuda_gru, cuda_lstm)
            chunks = pool.stats["admit_chunks"] - chunks
            best = pools.get(label)
            if best is None or wall < best["seconds"]:
                pools[label] = {"seconds": wall, "captions_per_s": len(reqs) / wall,
                                "admit_chunks": chunks, "launches": counts,
                                "result": result}
        fr, lv = pools["frozen"], pools["live"]
        differing = [k for k in reqs if not np.array_equal(fr["result"][k],
                                                           lv["result"][k])]
        check(not differing, f"the frozen pool's tokens differ from the live pool's for "
                             f"{len(differing)} requests, e.g. {differing[:5]}")
        per_chunk = {k: v / fr["admit_chunks"] for k, v in fr["launches"].items()}
        check(fr["launches"]["gru_seq"] == 2 * fr["admit_chunks"]
              and fr["launches"]["gru_seq_tc"] == 2 * fr["admit_chunks"]
              and fr["launches"]["lstm_seq"] == fr["launches"]["gru_seq_bt"]
              == fr["launches"]["gru_seq_dma"] == 0,
              f"the frozen pool launched {fr['launches']} over {fr['admit_chunks']} "
              "admission chunks")
        out["pool_per_chunk"] = per_chunk
        emit("artifact_frozen_pool", slots=CONT_SLOTS, admit_chunk=CONT_ADMIT,
             requests=len(reqs), export_s=pool_export_s, files_bytes=dir_bytes(pool_dir),
             tokens_equal_live=True, launches_per_admit_chunk=per_chunk,
             frozen={k: v for k, v in fr.items() if k != "result"},
             live={k: v for k, v in lv.items() if k != "result"}, nvidia_smi=smi)
        del frozen, livepool

        serve = subprocess.Popen(
            [sys.executable, "-m", "vcr_tpu_torch.cli", "--mode", "serve",
             "--pretrained_base", pool_dir, "--serve_port", "0"],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            line = ""
            for line in serve.stdout:
                if line.startswith("serving"):
                    break
            check(line.startswith("serving"), f"--mode serve on the artifact: {line}")
            url = line.split(" on ")[1].split()[0]
            client = CaptionClient(url, timeout_s=600, retries=0)
            answers = [client.caption(reqs[i]) for i in range(8)]
            check(all(list(t) == list(lv["result"][i])
                      for i, (t, _) in enumerate(answers)),
                  "--mode serve on the artifact answered other tokens than the live pool")
            serve.send_signal(signal.SIGTERM)
            serve_rc = serve.wait(120)
        finally:
            serve.kill()
            serve.wait(120)
            serve.stdout.close()
        check(serve_rc == 0, f"--mode serve on the artifact exited {serve_rc}")
        emit("artifact_serve", answered=len(answers), arch=line.split()[1],
             captions=[c for _, c in answers[:2]], exit_code=serve_rc)

        # 5. float32 SpatialNet over S2VT, exported on the CPU, run on the card
        # with cuDNN's TF32 left on by the caller: the loader turns it off
        sspec, sparams = entry.make_spec_and_params(**entry.SPATIAL, device="cpu",
                                                    compute_dtype="float32")
        sart = os.path.join(root, "spatial_f32")
        export_serving.export_captioner(sparams, sspec, sart, device="cpu")
        sx = np.random.default_rng(15).standard_normal(
            (ART_F32_BATCH, sspec.num_frames, sspec.vid_feat_size, sspec.grid_size,
             sspec.grid_size), dtype=np.float32)
        on_cpu = export_serving.load_artifact(sart, device="cpu")(sx)
        on_card_art = export_serving.load_artifact(sart, device="cuda")
        torch.backends.cudnn.allow_tf32 = True
        try:
            on_card = on_card_art(sx).cpu()
            flag_after = torch.backends.cudnn.allow_tf32
            # the same program without the loader's scope: informational
            with torch.no_grad():
                tf32_tokens = on_card_art._module(
                    on_card_art.leaves, torch.from_numpy(sx).cuda(), []).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        diff = first_difference(on_card, on_cpu)
        check(on_card_art.meta["float32_conv"] and flag_after,
              "the float32 SpatialNet artifact: meta or the caller's TF32 flag")
        check(torch.equal(on_card, on_cpu), f"the float32 SpatialNet artifact, card "
                                            f"against CPU: {diff}")
        emit("artifact_spatial_f32", batch=ART_F32_BATCH, float32_conv=True,
             tokens_equal_cpu=True, caller_cudnn_tf32=True, caller_flag_restored=flag_after,
             without_loader_scope=first_difference(tf32_tokens, on_cpu))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("artifact_phase", seconds=time.perf_counter() - t_phase)
    return out


def tree_bytes(tree) -> int:
    from vcr_tpu_torch.export_serving import flatten_tree

    return sum(t.numel() * t.element_size() for t in flatten_tree(tree)[0])


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float().cpu() - want.float().cpu()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def featurizers_phase(cuda_gru, cuda_lstm, smi, device="cuda"):
    """Phase 14 on ``device``: raw frames -> captions through the fused
    featurizers at the published widths; returns what the kernels line
    reports of it."""
    from vcr_tpu_torch import entry, export_serving, serving
    from vcr_tpu_torch.device import params_to
    from vcr_tpu_torch.models import darknet, resnet, vgg

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="vcr_featurizers_")
    out = {}
    try:
        cfg_path = os.path.join(root, "yolov3_first_head.cfg")
        with open(cfg_path, "w") as f:
            f.write(darknet.yolov3_first_head_cfg(DARKNET_SIZE))
        net = darknet.Darknet(cfg_path)
        types = [b["type"] for b in net.blocks[1:]]
        counts = {t: types.count(t) for t in sorted(set(types))}
        check(counts == {"convolutional": 59, "shortcut": 23, "yolo": 1},
              f"Darknet-53 + first head: {counts}")
        paths = {
            "vgg16_s2vt": ("vgg16", entry.FLAGSHIP, VGG_BATCH, VGG_SIZE, 2,
                           lambda: vgg.init_params(torch.Generator().manual_seed(0))),
            "resnet34_s2vt_att": ("resnet", entry.S2VT_ATT, RESNET_BATCH, RESNET_SIZE, 1,
                                  lambda: resnet.init_params(
                                      torch.Generator().manual_seed(0), "resnet34")),
            "darknet_spatial": ("yolo", entry.SPATIAL, DARKNET_BATCH, DARKNET_SIZE, 1,
                                lambda: net),
        }
        for name, (feat, dims, b, size, b1, make_fp) in paths.items():
            spec, params = entry.make_spec_and_params(**dims, device=device)
            fp_cpu = make_fp()
            fp = (darknet.Darknet.from_blocks(fp_cpu.blocks,
                                              params_to(fp_cpu.params, device),
                                              fp_cpu.header)
                  if feat == "yolo" else params_to(fp_cpu, device))
            g = torch.Generator(device=device).manual_seed(14)
            frames = torch.randn((b, spec.num_frames, 3, size, size), generator=g,
                                 device=device).to(torch.bfloat16)
            caption = serving.build_captioner(params, spec, feat, fp, device=device)
            tokens, launches = counted(cuda_gru, cuda_lstm, lambda: caption(frames))
            check(launches == expected_counts(b1=b1),
                  f"{name}: launches {launches}, want B1 {b1} on its tensor-core body")
            check(tokens.shape == (b, spec.max_len) and tokens.dtype == torch.int32
                  and bool(((tokens >= 0) & (tokens < spec.vocab_size)).all()),
                  f"{name}: tokens {tuple(tokens.shape)} {tokens.dtype}")
            featurize = serving.make_featurize(spec, feat, fp if feat == "yolo" else None)
            weights = fp.params if feat == "yolo" else fp
            with torch.inference_mode():
                feats = featurize(weights, frames)
                want_shape = ((b, spec.num_frames, spec.vid_feat_size, spec.grid_size,
                               spec.grid_size) if feat == "yolo"
                              else (b, spec.num_frames, spec.vid_feat_size))
                check(tuple(feats.shape) == want_shape and all_finite(feats),
                      f"{name}: features {tuple(feats.shape)}, want {want_shape}")
                flops = benchutil.flops(lambda: featurize(weights, frames))
                bound, bound_by = backbone_bound_ms(
                    flops, frames.numel() * 2 + tree_bytes(weights),
                    feats.numel() * 4, PEAKS)
                backbone_ms = median_best_ms(lambda: featurize(weights, frames))
                path_ms = median_best_ms(lambda: caption(frames))
                memory = peak_memory(lambda: caption(frames))
            out[name] = {"featurizer": feat, "videos": b, "frames": b * spec.num_frames,
                         "image_size": size, "launches": launches,
                         "backbone_gflop": flops / 1e9, "backbone_ms": backbone_ms,
                         "backbone_bound_ms": bound, "bound_by": bound_by,
                         "path_ms": path_ms,
                         "captions_per_s": b / (path_ms[0] / 1e3), **memory}

            # float32 (TF32 off) and bf16: one video on the card against the CPU
            gaps = {}
            x = frames[:CHECK_VIDEOS].float()
            for dtype in ("float32", "bfloat16"):
                dspec, dparams = entry.make_spec_and_params(**dims, compute_dtype=dtype,
                                                            device="cpu")
                dfeat = serving.make_featurize(dspec, feat, fp_cpu if feat == "yolo"
                                               else None)
                dweights = fp_cpu.params if feat == "yolo" else fp_cpu
                with torch.inference_mode():
                    on_cpu = dfeat(dweights, x.cpu())
                    on_card = dfeat(fp.params if feat == "yolo" else fp, x)
                cpu_tokens = serving.build_captioner(dparams, dspec, feat, fp_cpu,
                                                     device="cpu")(x.cpu())
                card_tokens = serving.build_captioner(dparams, dspec, feat, fp,
                                                      device=device)(x)
                gaps[dtype] = {"feature_rel_gap": rel_gap(on_card, on_cpu),
                               "token_agreement": (card_tokens.cpu() == cpu_tokens
                                                   ).float().mean().item()}
            check(gaps["float32"]["feature_rel_gap"] <= FEAT_F32_TOL
                  and gaps["float32"]["token_agreement"] == 1.0,
                  f"{name}: float32 card against CPU {gaps['float32']}")
            check(gaps["bfloat16"]["feature_rel_gap"] <= FEAT_BF16_GAP[feat],
                  f"{name}: bf16 card against CPU {gaps['bfloat16']}, bound "
                  f"{FEAT_BF16_GAP[feat]}")
            out[name]["card_vs_cpu"] = {"videos": CHECK_VIDEOS, **gaps,
                                        "f32_tolerance": FEAT_F32_TOL,
                                        "bf16_bound": FEAT_BF16_GAP[feat]}
            emit(f"featurizers_{name}", **out[name], nvidia_smi=smi)
            if name == "vgg16_s2vt":
                vgg_case = (spec, params, fp_cpu, frames, tokens)
            del caption, feats, frames

        # the fused VGG16 -> S2VT artifact: exported on the CPU, run on the card
        spec, params, fp_cpu, frames, tokens = vgg_case
        art = os.path.join(root, "vgg16_s2vt")
        t0 = time.perf_counter()
        export_serving.export_captioner(params_to(params, "cpu"), spec, art, "vgg16",
                                        fp_cpu, image_size=VGG_SIZE, device="cpu")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = export_serving.load_artifact(art, device=device)
        load_s = time.perf_counter() - t0
        got, launches = counted(cuda_gru, cuda_lstm, lambda: loaded(frames))
        check(launches == expected_counts(b1=2),
              f"VGG16 artifact: launches {launches}, want B1 2")
        diff = first_difference(got, tokens)
        check(diff["agreement"] == 1.0, f"VGG16 artifact tokens against the live "
                                        f"call: {diff}")
        out["vgg16_artifact"] = {"launches": launches, "export_s": export_s,
                                 "load_s": load_s, "bytes": dir_bytes(art),
                                 "ms": median_best_ms(lambda: loaded(frames)),
                                 "live_ms": out["vgg16_s2vt"]["path_ms"], **diff}
        emit("featurizers_vgg16_artifact", **out["vgg16_artifact"],
             phase_s=time.perf_counter() - t_phase, nvidia_smi=smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


DIST_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, out_path, per_rank, steps, seed = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                               int(sys.argv[4]), int(sys.argv[5]),
                                               int(sys.argv[6]))
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank)
from vcr_tpu_torch import entry
from vcr_tpu_torch.ops import cuda_gru
from vcr_tpu_torch.parallel import mesh as pmesh
from vcr_tpu_torch.train import optim, step

spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
spec = spec.with_(dropout_p=0.0)
mesh = pmesh.make_mesh(2, 1, "cuda")
specs = pmesh.param_specs(params, spec.padded_vocab_size, 1)
params = pmesh.shard_params(params, mesh, specs)
opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
state = opt.init(params)
train, _ = step.build_step_fns("s2vt", spec, opt, static_tf=1.0, device="cuda",
                               mesh=mesh, specs=specs)
r = np.random.default_rng(seed)
losses, launches, ms = [], [], []
for i in range(steps):
    batch = {"vid_feats": r.standard_normal((2 * per_rank, spec.num_frames,
                                             spec.vid_feat_size)).astype(np.float32),
             "sent": r.integers(0, spec.vocab_size, (2 * per_rank, spec.max_len)
                                ).astype(np.int32),
             "sent_len": np.full((2 * per_rank,), 12, np.int32),
             "valid": np.ones((2 * per_rank,), np.float32)}
    local = step.device_batch(pmesh.shard_batch(batch, mesh), "cuda")
    torch.cuda.synchronize()
    cuda_gru.launches = cuda_gru.launches_tc = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    params, state, m, _ = train(params, state, local, i, 1.0)
    end.record()
    torch.cuda.synchronize()
    losses.append(m["loss"].item())
    launches.append({"gru_seq": cuda_gru.launches, "gru_seq_tc": cuda_gru.launches_tc})
    ms.append(start.elapsed_time(end))
with open(out_path, "w") as f:
    json.dump({"losses": losses, "launches": launches, "step_ms": ms}, f)
dist.destroy_process_group()
"""


def distributed_train(cuda_gru, cuda_lstm, smi):
    """Two processes on the one card over gloo, dp=2: S2VT at full width,
    DIST_BATCH rows per rank, DIST_STEPS steps, against one process on the
    global batch (float32 losses, p=0) at the bf16 train bound."""
    from vcr_tpu_torch import entry
    from vcr_tpu_torch.parallel.launch import free_port
    from vcr_tpu_torch.train import optim, step

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="vcr_dist_")
    try:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST_WORKER, str(r), port,
             os.path.join(out_dir, f"rank{r}.json"), str(DIST_BATCH), str(DIST_STEPS), "5"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"distributed rank {r} failed:\n{out[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # one process on the same global batches
    spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cuda")
    spec = spec.with_(dropout_p=0.0)
    opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("s2vt", spec, opt, static_tf=1.0, device="cuda")
    r = np.random.default_rng(5)
    want = []
    for i in range(DIST_STEPS):
        b = 2 * DIST_BATCH
        batch = {"vid_feats": r.standard_normal((b, spec.num_frames, spec.vid_feat_size)
                                                ).astype(np.float32),
                 "sent": r.integers(0, spec.vocab_size, (b, spec.max_len)).astype(np.int32),
                 "sent_len": np.full((b,), 12, np.int32),
                 "valid": np.ones((b,), np.float32)}
        params, state, m, _ = train(params, state, step.device_batch(batch, "cuda"), i, 1.0)
        want.append(m["loss"].item())
    gaps = [abs(a - w) for a, w in zip(ranks[0]["losses"], want)]
    check(ranks[0]["losses"] == ranks[1]["losses"],
          f"the ranks' global losses differ: {ranks[0]['losses']} {ranks[1]['losses']}")
    check(max(gaps) <= DIST_LOSS_TOL,
          f"two processes against one: losses {ranks[0]['losses']} vs {want}")
    per_step = [x["gru_seq"] for x in ranks[0]["launches"] + ranks[1]["launches"]]
    check(all(n == 2 for n in per_step) and all(
        x["gru_seq_tc"] == 2 for x in ranks[0]["launches"] + ranks[1]["launches"]),
        f"B1 launches per step and rank {per_step}, want 2 on the tensor-core body")
    row = {"processes": 2, "backend": "gloo", "dp": 2, "mp": 1,
           "batch_per_rank": DIST_BATCH, "steps": DIST_STEPS, "losses": ranks[0]["losses"],
           "one_process_losses": want, "max_loss_gap": max(gaps),
           "tolerance": DIST_LOSS_TOL, "launches_per_step_per_rank": 2,
           "step_ms_by_rank": [x["step_ms"] for x in ranks],
           "seconds": time.perf_counter() - t0}
    emit("harnesses_distributed_train", **row, nvidia_smi=smi)
    return row


def harnesses_phase(cuda_gru, cuda_lstm, smi, flagship):
    """Phase 15: the harnesses on the card. benchutil's timing, FLOP count
    and MFU of the flagship at B=2048 beside phase 5's ms; every row of
    vcr_tpu_torch.checks; tune_serving over two geometries of the flagship's
    pool; two processes training S2VT on the card."""
    from vcr_tpu_torch import checks, tune_serving

    t_phase = time.perf_counter()
    spec, params, caption, feats, caption_ms = flagship
    with torch.inference_mode():
        timed = benchutil.time_chained(caption, (feats,), "cuda")
    check(timed["flops"] > 0 and timed["mfu"] is not None and 0 < timed["mfu"] < 1,
          f"flagship MFU reading {timed}")
    with torch.inference_mode():
        _, launches = counted(cuda_gru, cuda_lstm, lambda: caption(feats))
    emit("harnesses_mfu", batch=feats.shape[0], phase5_caption_ms=caption_ms,
         best_ms=timed["best_s"] * 1e3, median_ms=timed["median_s"] * 1e3,
         gflop_per_call=timed["flops"] / 1e9, mfu=timed["mfu"],
         peak_bf16_flops=benchutil.peak_bf16_flops("cuda"), loadavg=timed["loadavg"],
         launches=launches, nvidia_smi=smi)

    t0 = time.perf_counter()
    rc = checks.main([])
    check(rc == 0, f"vcr_tpu_torch.checks on the card exited {rc}")
    emit("harnesses_checks", rows=len(checks.Checks(torch.device("cuda"),
                                                    checks.CARD).rows()),
         exit_code=rc, seconds=time.perf_counter() - t0, nvidia_smi=smi)

    t0 = time.perf_counter()
    rows, bests = tune_serving.tune(params, spec, spec.sos_id + 1, TUNE_GEOMETRIES, [0.0],
                                    TUNE_REQUESTS, device="cuda")
    for r in rows:
        check(r["served"] == TUNE_REQUESTS, f"tune_serving served {r['served']}")
        check(r["launches"]["gru_seq"] == 2 * r["admit_chunks"]
              and r["launches"]["lstm_seq"] == 0,
              f"tune_serving launches {r['launches']} for {r['admit_chunks']} admission "
              "chunks, want B1 twice a chunk")
    emit("harnesses_tune_serving", geometries=rows, best=bests,
         seconds=time.perf_counter() - t0, nvidia_smi=smi)

    dist_row = distributed_train(cuda_gru, cuda_lstm, smi)
    emit("harnesses", phase_seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return {"mfu": timed, "tune": rows, "distributed": dist_row}


MESH_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, port, out_path, conf = int(sys.argv[1]), sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank)
from vcr_tpu_torch import entry
from vcr_tpu_torch.ops import cuda_gru, cuda_lstm
from vcr_tpu_torch.parallel import mesh as pmesh
from vcr_tpu_torch.serving_continuous import ContinuousCaptioner
from vcr_tpu_torch.train import optim, step

mesh = pmesh.make_mesh(2, 1, "cuda")
res = {}


def counts():
    return {"gru_seq": cuda_gru.launches, "gru_seq_tc": cuda_gru.launches_tc,
            "lstm_seq": cuda_lstm.launches, "lstm_seq_tc": cuda_lstm.launches_tc}


def reset():
    cuda_gru.launches = cuda_gru.launches_tc = cuda_gru.launches_bt = 0
    cuda_gru.launches_dma = cuda_gru.launches_dma_tc = 0
    cuda_lstm.launches = cuda_lstm.launches_tc = 0


def timed(cc, name, log):
    fn = getattr(cc, name)

    def run(*args):
        t = time.perf_counter()
        out = fn(*args)
        log.append(time.perf_counter() - t)
        return out
    setattr(cc, name, run)


def serve(name, model, pool):
    spec, params = entry.make_spec_and_params(**getattr(entry, model), device="cuda")
    cc = ContinuousCaptioner(params, spec, slots=pool["slots"], admit_chunk=pool["admit"],
                             step_chunk=pool["step"], mesh=mesh)
    feats = np.random.default_rng(pool["seed"]).standard_normal(
        (pool["requests"], spec.num_frames, spec.vid_feat_size), dtype=np.float32)
    row = {}
    for run in ("warm", "burst"):
        n = pool["admit"] if run == "warm" else pool["requests"]
        torch.cuda.synchronize()
        reset()
        if rank == 0:
            logs = {"encode_admit": [], "tick": [], "poll_active": []}
            if run == "burst":
                for op, log in logs.items():
                    timed(cc, op, log)
            chunks = cc.stats["admit_chunks"]
            t0 = time.perf_counter()
            got = cc.caption_all({i: feats[i] for i in range(n)})
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            cc.stop()
            row = {"seconds": seconds, "captions_per_s": n / seconds,
                   "admit_chunks": cc.stats["admit_chunks"] - chunks,
                   "host_ms": {op: 1e3 * sum(log) / max(len(log), 1)
                               for op, log in logs.items()},
                   "calls": {op: len(log) for op, log in logs.items()},
                   "tokens": [got[i].tolist() for i in range(n)]}
        else:
            cc.follow()
            torch.cuda.synchronize()
        row["launches"] = counts()
    res[name] = row
    del cc, params


if conf.get("flagship"):
    serve("flagship", "FLAGSHIP", conf["flagship"])
if conf.get("rationale"):
    serve("rationale", "RATIONALE", conf["rationale"])
if conf.get("spatial"):
    sp = conf["spatial"]
    spec, params = entry.make_spec_and_params(**entry.SPATIAL, device="cuda")
    spec = spec.with_(dropout_p=0.0)
    specs = pmesh.param_specs(params, spec.padded_vocab_size, 1)
    opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("spatial", spec, opt, static_tf=1.0, device="cuda",
                                   mesh=mesh, specs=specs)
    losses, launches, ms = [], [], []
    for i in range(sp["steps"]):
        g = torch.Generator(device="cuda").manual_seed(sp["seed"] + i)
        b = sp["batch"]
        batch = {"vid_feats": torch.randn((b, spec.num_frames, spec.vid_feat_size,
                                           spec.grid_size, spec.grid_size), generator=g,
                                          device="cuda"),
                 "sent": torch.randint(0, spec.vocab_size, (b, spec.max_len), generator=g,
                                       device="cuda", dtype=torch.int32),
                 "sent_len": torch.full((b,), 12, dtype=torch.int32, device="cuda"),
                 "valid": torch.ones((b,), device="cuda")}
        local = pmesh.shard_batch(batch, mesh)
        torch.cuda.synchronize()
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m, _ = train(params, state, local, i, 1.0)
        end.record()
        torch.cuda.synchronize()
        losses.append(m["loss"].item())
        launches.append(counts())
        ms.append(start.elapsed_time(end))
    res["spatial"] = {"losses": losses, "launches": launches, "step_ms": ms}
with open(out_path, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def run_mesh_workers(conf, timeout=600):
    """MESH_WORKER in two processes on the one card over gloo -> each rank's
    results."""
    from vcr_tpu_torch.parallel.launch import free_port

    out_dir = tempfile.mkdtemp(prefix="vcr_mesh_")
    try:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER, str(r), port,
             os.path.join(out_dir, f"rank{r}.json"), json.dumps(conf)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"mesh rank {r} failed:\n{out[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def one_process_pool(model, pool):
    """The one-process pool of MESH_WORKER's run: a warm-up of one chunk,
    then the burst, the same host timers -> its row."""
    from vcr_tpu_torch import entry
    from vcr_tpu_torch.serving_continuous import ContinuousCaptioner

    spec, params = entry.make_spec_and_params(**getattr(entry, model), device="cuda")
    cc = ContinuousCaptioner(params, spec, slots=pool["slots"], admit_chunk=pool["admit"],
                             step_chunk=pool["step"])
    feats = np.random.default_rng(pool["seed"]).standard_normal(
        (pool["requests"], spec.num_frames, spec.vid_feat_size), dtype=np.float32)
    cc.caption_all({i: feats[i] for i in range(pool["admit"])})
    logs = {"encode_admit": [], "tick": [], "poll_active": []}
    for op, log in logs.items():
        fn = getattr(cc, op)

        def run(*args, fn=fn, log=log):
            t = time.perf_counter()
            out = fn(*args)
            log.append(time.perf_counter() - t)
            return out
        setattr(cc, op, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = cc.caption_all({i: feats[i] for i in range(pool["requests"])})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "captions_per_s": pool["requests"] / seconds,
            "host_ms": {op: 1e3 * sum(log) / max(len(log), 1) for op, log in logs.items()},
            "calls": {op: len(log) for op, log in logs.items()},
            "tokens": [got[i].tolist() for i in range(pool["requests"])]}


def mesh_daemon(smi):
    """--mode serve through the launcher over a saved flagship checkpoint,
    with --nproc 1 and with --nproc 2 --mesh_dp 2: MESH_DAEMON_REQUESTS
    POSTs each against the batch greedy, then SIGTERM."""
    from vcr_tpu_torch import serving
    from vcr_tpu_torch.client import CaptionClient
    from vcr_tpu_torch.config import Config
    from vcr_tpu_torch.models import base
    from vcr_tpu_torch.train import checkpoint, loop

    root = tempfile.mkdtemp(prefix="vcr_mesh_daemon_")
    proc = None
    try:
        data = write_corpus(os.path.join(root, "data"), CLI_WORDS, 300, 1, 1, 30, 4096,
                            seed=9)
        save = os.path.join(root, "s2vt")
        cfg = Config(mode="train", data_dir=data[1], corpus="msvd_vgg",
                     glove_emb_file="glove.txt", num_frames=30, vid_feat_size=4096,
                     max_len=20, hidden_size=512, compute_dtype="bfloat16",
                     vocab_pad_to=128, save_path=save, log_dir="")
        vocab = loop.load_vocab(cfg)
        spec = base.spec_from_config(cfg, vocab)
        params = loop.init_params(cfg, spec, vocab, "cuda")
        checkpoint.save_checkpoint(checkpoint.best_path(save), params, {},
                                   {"config": cfg.to_dict(), "n_iter": 0, "epoch": 0})
        feats = np.random.default_rng(21).standard_normal(
            (MESH_DAEMON_REQUESTS, spec.num_frames, spec.vid_feat_size), dtype=np.float32)
        with torch.inference_mode():
            want = serving.build_captioner(params, spec, vocab=vocab)(feats).cpu().numpy()
        eos = vocab.eos_id
        rows = {}
        for nproc in (1, 2):
            mesh = ["--mesh_dp", "2"] if nproc == 2 else []
            proc = subprocess.Popen(
                [sys.executable, "-u", "-m", "vcr_tpu_torch.parallel.launch", "--nproc",
                 str(nproc), "--", "--mode", "serve", *mesh, "--serve_port", "0",
                 "--serve_slots", str(MESH_POOL["slots"]),
                 "--serve_admit_chunk", str(MESH_POOL["admit"]), *data, "--save_path", save],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("serving"):
                    break
            check(lines and lines[-1].startswith("serving")
                  and (nproc == 1 or "dp=2" in lines[-1]),
                  f"the daemon of {nproc} processes did not start:\n"
                  + "".join(lines)[-3000:])
            url = lines[-1].split(" on ")[1].split()[0]
            client = CaptionClient(url, timeout_s=600, retries=0)
            client.caption(feats[0])                                    # first use

            def one(i, client=client):
                return client.caption(feats[i])[0]

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(MESH_DAEMON_THREADS) as ex:
                got = list(ex.map(one, range(MESH_DAEMON_REQUESTS)))
            seconds = time.perf_counter() - t0
            health = client.health()
            proc.send_signal(signal.SIGTERM)
            out = proc.stdout.read()
            rc = proc.wait(timeout=120)
            check(rc == 0, f"the daemon of {nproc} processes exited {rc}:\n"
                  + ("".join(lines) + out)[-3000:])
            check(nproc == 1 or "following rank 0" in "".join(lines) + out,
                  "rank 1 did not follow rank 0")
            agreement = token_agreement(got, [cut_at_eos(r, eos) for r in want])
            check(agreement >= CONT_TOKEN_AGREEMENT,
                  f"the daemon of {nproc} processes against batch greedy: {agreement} "
                  "of the tokens equal")
            rows[f"processes_{nproc}"] = {
                "seconds": seconds, "captions_per_s": MESH_DAEMON_REQUESTS / seconds,
                "daemon_latency_p50_ms": health.get("latency_p50_ms"),
                "daemon_latency_p95_ms": health.get("latency_p95_ms"),
                "token_agreement_vs_batch_greedy": agreement, "exit_code": rc}
        return {"requests": MESH_DAEMON_REQUESTS, "client_threads": MESH_DAEMON_THREADS,
                "slots": MESH_POOL["slots"], "admit_chunk": MESH_POOL["admit"], **rows}
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def mesh_artifact(cuda_gru, cuda_lstm, smi):
    """The flagship artifact exported with dp=2 (on the CPU) and loaded on
    ["cuda:0", "cuda:0"], against the dp=1 artifact at MESH_ART_BATCH."""
    from vcr_tpu_torch import entry, export_serving

    root = tempfile.mkdtemp(prefix="vcr_mesh_art_")
    try:
        spec, params = entry.make_spec_and_params(**entry.FLAGSHIP, device="cpu")
        two = os.path.join(root, "dp2")
        t0 = time.perf_counter()
        export_serving.export_captioner(params, spec, two, dp=2, device="cpu")
        export_s = time.perf_counter() - t0
        # the dp=1 artifact: the same program, its meta saying dp=1
        one = os.path.join(root, "dp1")
        shutil.copytree(two, one)
        meta_path = os.path.join(one, export_serving.META_FILE)
        with open(meta_path) as f:
            meta = json.load(f)
        with open(meta_path, "w") as f:
            json.dump(dict(meta, dp=1, nr_devices=1), f)
        art2 = export_serving.load_artifact(two, devices=["cuda:0", "cuda:0"])
        art1 = export_serving.load_artifact(one, device="cuda")
        check(art2.meta["dp"] == 2 and len(art2.devices) == 2, "the dp=2 artifact's meta")
        feats = torch.as_tensor(np.random.default_rng(23).standard_normal(
            (MESH_ART_BATCH, spec.num_frames, spec.vid_feat_size), dtype=np.float32),
            device="cuda")
        got, want = art2(feats).cpu().numpy(), art1(feats).cpu().numpy()
        check(got.shape == want.shape == (MESH_ART_BATCH, spec.max_len), "artifact shapes")
        agreement = float((got == want).mean())
        check(agreement >= CONT_TOKEN_AGREEMENT,
              f"the dp=2 artifact against dp=1: {agreement} of the tokens equal")
        _, launches = counted(cuda_gru, cuda_lstm, lambda: art2(feats))
        check(launches == expected_counts(b1=4),
              f"the dp=2 artifact launched {launches} in a call, want B1 twice per slice")
        ms2, med2 = median_best_ms(lambda: art2(feats))
        ms1, med1 = median_best_ms(lambda: art1(feats))
        return {"batch": MESH_ART_BATCH, "devices": ["cuda:0", "cuda:0"],
                "export_s": export_s, "token_agreement_vs_dp1": agreement,
                "launches_per_call": launches,
                "dp2_ms": ms2, "dp2_median_ms": med2, "dp1_ms": ms1, "dp1_median_ms": med1}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def multidevice_serving_phase(cuda_gru, cuda_lstm, smi):
    """Phase 16: the sharded pools, SpatialNet's dp training, the dp daemon
    and the dp artifact, two processes on the one card; returns what the
    kernels line reports of it."""
    from vcr_tpu_torch import entry
    from vcr_tpu_torch.train import optim, step

    t_phase = time.perf_counter()
    pools = {"flagship": dict(MESH_POOL, seed=31), "rationale": dict(MESH_RATIONALE_POOL,
                                                                     seed=32)}
    ranks = run_mesh_workers({**pools, "spatial": dict(MESH_SPATIAL, seed=33)})
    out = {}
    for name, model in (("flagship", "FLAGSHIP"), ("rationale", "RATIONALE")):
        pool = pools[name]
        one = one_process_pool(model, pool)
        lead = ranks[0][name]
        agreement = token_agreement(lead["tokens"], one["tokens"])
        check(agreement >= CONT_TOKEN_AGREEMENT,
              f"the dp=2 {name} pool against one process: {agreement} of the tokens equal")
        chunks = lead["admit_chunks"]
        b2 = 2 * chunks if name == "rationale" else 0
        per_rank = [r[name]["launches"] for r in ranks]
        check(all(c == {"gru_seq": 2 * chunks, "gru_seq_tc": 2 * chunks, "lstm_seq": b2,
                        "lstm_seq_tc": b2} for c in per_rank),
              f"the dp=2 {name} pool launched {per_rank} per rank in {chunks} chunks, "
              f"want B1 {2 * chunks} and B2 {b2} on the tensor-core bodies")
        out[name] = {"launches_per_rank": per_rank, "admit_chunks": chunks}
        emit(f"multidevice_serving_{name}_pool", dp=2, **{k: pool[k] for k in pool},
             seconds=lead["seconds"], captions_per_s=lead["captions_per_s"],
             host_ms=lead["host_ms"], calls=lead["calls"], admit_chunks=chunks,
             launches_per_rank=per_rank, one_process={k: one[k] for k in (
                 "seconds", "captions_per_s", "host_ms", "calls")},
             token_agreement_vs_one_process=agreement,
             token_agreement_bound=CONT_TOKEN_AGREEMENT, nvidia_smi=smi)

    # SpatialNet: one process on the same global batches
    sp = MESH_SPATIAL
    spec, params = entry.make_spec_and_params(**entry.SPATIAL, device="cuda")
    spec = spec.with_(dropout_p=0.0)
    opt = optim.build_optimizer("adam", 1e-3, 0.0, 1.0)
    state = opt.init(params)
    train, _ = step.build_step_fns("spatial", spec, opt, static_tf=1.0, device="cuda")
    want = []
    for i in range(sp["steps"]):
        g = torch.Generator(device="cuda").manual_seed(33 + i)
        b = sp["batch"]
        batch = {"vid_feats": torch.randn((b, spec.num_frames, spec.vid_feat_size,
                                           spec.grid_size, spec.grid_size), generator=g,
                                          device="cuda"),
                 "sent": torch.randint(0, spec.vocab_size, (b, spec.max_len), generator=g,
                                       device="cuda", dtype=torch.int32),
                 "sent_len": torch.full((b,), 12, dtype=torch.int32, device="cuda"),
                 "valid": torch.ones((b,), device="cuda")}
        params, state, m, _ = train(params, state, batch, i, 1.0)
        want.append(m["loss"].item())
    del params, state
    got = [r["spatial"] for r in ranks]
    gaps = [abs(a - w) for a, w in zip(got[0]["losses"], want)]
    check(got[0]["losses"] == got[1]["losses"],
          f"the ranks' SpatialNet losses differ: {got[0]['losses']} {got[1]['losses']}")
    check(max(gaps) <= DIST_LOSS_TOL,
          f"SpatialNet dp=2 against one process: {got[0]['losses']} vs {want}")
    per_step = [c for r in got for c in r["launches"]]
    check(all(c["gru_seq"] == c["gru_seq_tc"] == 1 and c["lstm_seq"] == 0
              for c in per_step),
          f"SpatialNet dp=2 launches per step and rank {per_step}, want B1 once")
    out["spatial"] = {"launches_per_step_per_rank": 1}
    emit("multidevice_serving_spatial_train", dp=2, batch=sp["batch"],
         batch_per_rank=sp["batch"] // 2, steps=sp["steps"], losses=got[0]["losses"],
         one_process_losses=want, max_loss_gap=max(gaps), tolerance=DIST_LOSS_TOL,
         launches_per_step_per_rank=1, step_ms_by_rank=[r["step_ms"] for r in got],
         nvidia_smi=smi)

    t0 = time.perf_counter()
    daemon = mesh_daemon(smi)
    emit("multidevice_serving_daemon", **daemon, phase_seconds=time.perf_counter() - t0,
         nvidia_smi=smi)
    artifact = mesh_artifact(cuda_gru, cuda_lstm, smi)
    emit("multidevice_serving_artifact", **artifact, nvidia_smi=smi)
    out["artifact"] = artifact["launches_per_call"]
    emit("multidevice_serving", phase_seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2

    from vcr_tpu_torch import entry, serving
    from vcr_tpu_torch.data import native
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
                      (cuda_gru._lib, cuda_gru._dma_lib, cuda_lstm._lib, native.get_lib)]:
            built.result()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         kernels=["gru_seq", "gru_seq_dma", "lstm_seq"], host_libraries=["npy_loader"])
    # phase 13's Transformer artifact, exported on the host from here on
    tf_export = start_tf_export()

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
        # SpatialNet's prime pass runs B1 at B=16 (train) and B=64 (serving)
        shapes = [(frames, b) for b in (SMOKE_BATCH, 1, 3, 17, SPATIAL_TRAIN_BATCH,
                                        SPATIAL_BATCH)] + [(1, 17)]
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
    flagship = (spec, params, caption, feats, caption_ms)
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
        # the dispatcher: B1 through its custom op (the path every caller
        # takes) against the launcher called directly, in turns; then the
        # host time of one call of each at T=1, B=16, where the host sets
        # the pace
        op_ms = float("inf")
        for _ in range(2):
            op_ms = min(op_ms, time_ms(lambda: cuda_gru.gru_recurrence(*gru_args),
                                       iters=5))
            kernel_ms = min(kernel_ms, time_ms(gru_runs["gru_seq"], iters=5))
        small = (x_gates[:1, :16].contiguous(),) + gru_args[1:3] + (
            torch.zeros((16, hidden), device="cuda"), cd)
        host_us = {}
        for name, fn in (("launcher", cuda_gru.gru_recurrence_cuda),
                         ("op", cuda_gru.gru_recurrence)) * 2:
            fn(*small)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(*small)
            took = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            host_us[name] = min(host_us.get(name, float("inf")), took)
        dispatcher = {"launcher_ms": kernel_ms, "op_ms": op_ms,
                      "host_us_per_call": host_us, "host_batch": 16, "host_steps": 1}
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
         encoder=encoder, dispatcher=dispatcher, nvidia_smi=smi)

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

    # 8. S2VT-att: serving, RationaleNet over it, training, the command line
    att = s2vt_att_phase(cuda_gru, cuda_lstm, smi)

    # 9. SpatialNet: serving, float32 card vs CPU, training, the command line
    sp = spatial_phase(cuda_gru, cuda_lstm, smi)

    # 10. the Transformer: serving, parity decodes, float32 card vs CPU, the
    # bf16 lineage checks, training
    tf = transformer_phase(cuda_gru, cuda_lstm, smi)

    # 11. continuous batching: the slot pools and the HTTP daemon
    cont = continuous_phase(cuda_gru, cuda_lstm, smi, tf["timing"])

    # 12. the quantized serving modes
    quant = quantized_phase(cuda_gru, cuda_lstm, smi)

    # 13. the deployable artifacts
    art = artifact_phase(cuda_gru, cuda_lstm, smi, tf_export)

    # 14. raw frames -> captions through the fused featurizers
    feat = featurizers_phase(cuda_gru, cuda_lstm, smi)

    # 15. the harnesses: MFU, the checks, the pool tuner, two processes
    harness = harnesses_phase(cuda_gru, cuda_lstm, smi, flagship)

    # 16. multi-device serving: the sharded pools, SpatialNet's dp training,
    # the dp daemon and the dp artifact, two processes on the one card
    mesh = multidevice_serving_phase(cuda_gru, cuda_lstm, smi)
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
        "launches_s2vt_att": att["serve"]["gru_seq"],
        "launches_rationale_s2vt_att": att["rationale"]["gru_seq"],
        "launches_spatial": sp["serve"]["gru_seq"],
        "launches_spatial_beam": sp["beam"]["gru_seq"],
        "launches_spatial_s2vt_att": sp["s2vt_att"]["gru_seq"],
        "launches_transformer": tf["greedy"]["gru_seq"],
        "launches_continuous_daemon": cont["daemon"]["gru_seq"],
        "continuous_daemon_admit_chunks": cont["daemon_admit_chunks"],
        "launches_continuous_rationale": cont["rationale"]["gru_seq"],
        "launches_w8_pool": quant["s2vt_w8"]["gru_seq"],
        "w8_pool_admit_chunks": quant["s2vt_w8_admit_chunks"],
        "launches_w8_rationale_pool": quant["rationale_w8"]["gru_seq"],
        "launches_per_artifact_call": {name: art[name]["gru_seq"] for name in (
            "flagship", "rationale", "s2vt_beam5", "transformer")},
        "launches_per_frozen_pool_admit_chunk": art["pool_per_chunk"]["gru_seq"],
        "launches_per_featurized_call": {name: feat[name]["launches"]["gru_seq"]
                                         for name in ("vgg16_s2vt", "resnet34_s2vt_att",
                                                      "darknet_spatial",
                                                      "vgg16_artifact")},
        "launches_per_tune_serving_geometry": {
            "R%d_A%d_S%d" % (r["slots"], r["admit_chunk"], r["step_chunk"]):
                {"launches": r["launches"]["gru_seq"], "admit_chunks": r["admit_chunks"]}
            for r in harness["tune"]},
        "launches_per_distributed_step_per_rank":
            harness["distributed"]["launches_per_step_per_rank"],
        "launches_per_rank_mesh_pool": mesh["flagship"],
        "launches_per_rank_mesh_rationale_pool": mesh["rationale"],
        "launches_per_spatial_dp2_step_per_rank":
            mesh["spatial"]["launches_per_step_per_rank"],
        "launches_per_dp2_artifact_call": mesh["artifact"]["gru_seq"],
        "flagship_mfu": harness["mfu"]["mfu"],
        "at_admission_batch": cont["kernel_timing"]["gru_seq"],
        "at_admission_batch_max_abs_err": worst(cont["kernel_cases"], "bfloat16",
                                                "gru_seq"),
        "max_abs_err": worst(cases, "bfloat16"), "tolerance": BF16_TOL,
        "f32_max_abs_err": worst(cases, "float32"), "f32_tolerance": F32_TOL,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "projection_ms": projection_ms, "at_rationale_batch": b1_half,
        "dispatcher": dispatcher,
        "train_launches_per_step": {
            "s2vt": train_s2vt["launches_per_step"]["gru_seq"],
            "s2vt_remat": train_s2vt["remat_launches_per_step"]["gru_seq"],
            "rationale": train_rationale["launches_per_step"]["gru_seq"],
            "s2vt_att": att["train"]["gru_seq"],
            "s2vt_att_remat": att["train_remat"]["gru_seq"],
            "spatial": sp["train"]["gru_seq"],
            "spatial_remat": sp["train_remat"]["gru_seq"],
            "transformer": tf["train"]["gru_seq"]},
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
        "launches_rationale_s2vt_att": att["rationale"]["lstm_seq"],
        "launches_transformer": tf["greedy"]["lstm_seq"],
        "launches_continuous_rationale": cont["rationale"]["lstm_seq"],
        "continuous_rationale_admit_chunks": cont["rationale_admit_chunks"],
        "launches_w8_rationale_pool": quant["rationale_w8"]["lstm_seq"],
        "w8_rationale_pool_admit_chunks": quant["rationale_w8_admit_chunks"],
        "launches_per_rank_mesh_rationale_pool": mesh["rationale"],
        "launches_per_artifact_call": {name: art[name]["lstm_seq"] for name in (
            "flagship", "rationale", "s2vt_beam5", "transformer")},
        "at_admission_batch": cont["kernel_timing"]["lstm_seq"],
        "at_admission_batch_max_abs_err": worst(cont["kernel_cases"], "bfloat16",
                                                "lstm_seq"),
        "max_abs_err": worst(lstm_cases, "bfloat16"), "tolerance": LSTM_BF16_TOL,
        "f32_max_abs_err": worst(lstm_cases, "float32"),
        "f32_tolerance": LSTM_F32_TOL,
        "ms": lstm_ms, "plain_ms": lstm_plain_ms, "bound_ms": lstm_bound,
        "bound_by": lstm_bound_by, "library_ms": lstm_library_ms,
        "projection_ms": lstm_projection_ms,
        "train_launches_per_step": {
            "rationale": train_rationale["launches_per_step"]["lstm_seq"],
            "transformer": tf["train"]["lstm_seq"]},
        "backward": {"route": backward_route.format("lstm_sequence", "414-423"),
                     "batch": RATIONALE_TRAIN_BATCH,
                     **train_rationale["lstm_seq_forward_direction"]}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
