"""Build a model spec and seeded random parameters, as the JAX package's
``__graft_entry__._make_spec_and_params`` does."""

from __future__ import annotations

import numpy as np
import torch

from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base

# The flagship captioner: S2VT greedy on MSVD-VGG 4096-d features, H=512,
# N=30 frames, L=20 tokens, vocab 9000 padded to 128, bf16 products.
FLAGSHIP = dict(vocab_size=9000, embed_size=300, hidden=512, vid_feat=4096,
                max_len=20, num_frames=30)
# RationaleNet over that S2VT at the same widths (bench_all.py's rationale
# row): a BiLSTM generator with H=512 picks frames by hard Gumbel-Softmax.
RATIONALE = dict(FLAGSHIP, arch="rationale", base_arch="s2vt", tau=1.0)
# S2VT with Bahdanau attention on MSVD ResNet 512-d features, the JAX
# package's bench row (bench_all.py:151-152, bench_train.py:30): H=512,
# N=30, L=20, vocab 9000 padded to 128, bf16 products.
S2VT_ATT = dict(FLAGSHIP, arch="s2vt-att", vid_feat=512)
# SpatialNet over that S2VT on YOLOv3 grid features (30, 1024, 13, 13), the
# JAX package's bench row (bench_all.py:514-517 serves it at B=64,
# bench_train.py:33 trains it at B=16): a 2-conv trunk 1024 -> 512, Bahdanau
# attention over the 169 cells per frame, then S2VT's decode; bf16 products.
SPATIAL = dict(FLAGSHIP, arch="spatial", base_arch="s2vt", vid_feat=1024, grid_size=13)
# The Transformer on MSR-VTT 4096-d features, the JAX package's bench row
# (bench_all.py:154-190 serves it at B=128 parity and B=512 KV-cached,
# bench_train.py:31 trains it at B=128): the encoder at the raw 4096 width,
# the decoder at 300, H=512, 6 layers, 8 heads, N=30, L=20, vocab 9000 padded
# to 128, bf16 products.
TRANSFORMER = dict(FLAGSHIP, arch="transformer", tf_layers=6, tf_heads=8)


def make_spec_and_params(vocab_size: int, embed_size: int, hidden: int,
                         vid_feat: int, max_len: int, num_frames: int,
                         seed: int = 0, compute_dtype: str = "bfloat16",
                         vocab_pad_to: int = 128, arch: str = "s2vt",
                         device=None, **spec_kw):
    """-> (spec, params on ``device``). The GloVe stand-in comes from a numpy
    generator and the weights from a CPU ``torch.Generator``, both seeded with
    ``seed``, so the same seed gives the same weights on every device."""
    device = resolve_device(device)
    glove = np.random.default_rng(seed).standard_normal(
        (vocab_size, embed_size)).astype(np.float32)
    spec = base.ModelSpec(
        arch=arch, vocab_size=vocab_size, embed_size=embed_size,
        hidden_size=hidden, vid_feat_size=vid_feat, max_len=max_len,
        num_frames=num_frames, dropout_p=0.2, sos_id=vocab_size - 4,
        compute_dtype=compute_dtype, vocab_pad_to=vocab_pad_to, **spec_kw)
    init_fn, _ = base.build_model(arch)
    params = init_fn(torch.Generator().manual_seed(seed), spec, glove)
    return spec, params_to(params, device)

