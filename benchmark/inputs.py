"""Everything a run feeds the program, made from ``--seed`` on the device:
the weights as a state_dict in the reference project's layout, the video
features, the training sentences and the Gumbel noise.

Each kind of draw has a generator of its own, seeded with the run's seed and
the draw's tag, so adding a draw leaves the others as they were. Tensors are
drawn in a few large calls, in float32.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 62-bit seed for the draw ``tag`` of the run seeded with ``seed``
    (any whole number, negative or beyond 64 bits included)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def state_dict(layout: List[Tuple[str, tuple, Optional[float]]], m: dict, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The weights of ``layout`` ((key, shape, bound) triples): one uniform
    draw for every tensor with a bound, scaled into [-bound, bound], one
    normal draw at ``m["embedding_std"]`` for those without (the
    embeddings)."""
    gen = generator(seed, "weights", device)
    sizes = [int(np.prod(shape)) for _, shape, _ in layout]
    uniform_n = sum(n for n, (_, _, b) in zip(sizes, layout) if b is not None)
    normal_n = sum(n for n, (_, _, b) in zip(sizes, layout) if b is None)
    uni = torch.rand(uniform_n, generator=gen, device=device)
    nor = torch.randn(normal_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for n, (key, shape, bound) in zip(sizes, layout):
        if bound is None:
            out[key] = (nor[inn:inn + n] * m["embedding_std"]).reshape(shape)
            inn += n
        else:
            out[key] = ((uni[iu:iu + n] * 2.0 - 1.0) * bound).reshape(shape)
            iu += n
    return out


def video_feats(seed: int, index: int, batch: int, m: dict, device) -> torch.Tensor:
    """Batch ``index`` of VGG16 fc7-like features (batch, N, V) float32:
    post-ReLU, so about half are zero, the rest |N(0, 1)|."""
    gen = generator(seed, f"feats{index}", device)
    x = torch.randn((batch, m["num_frames"], m["vid_feat_size"]), generator=gen,
                    device=device)
    return x.clamp_(min=0.0)


def gumbel(seed: int, index: int, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of ``shape`` for batch ``index``, float32."""
    gen = generator(seed, f"gumbel{index}", device)
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=1e-20)
    return -torch.log(-torch.log(u))


def sentence_lengths(seed: int, index: int, batch: int, weights: Dict[str, float]
                     ) -> np.ndarray:
    """``batch`` caption lengths in words, the same multiset for every seed
    and index (each length's share of ``weights`` rounded, largest shares
    first), in an order drawn from the seed."""
    words = np.array([int(k) for k in weights])
    share = np.array([float(v) for v in weights.values()])
    share = share / share.sum()
    counts = np.floor(share * batch).astype(int)
    for i in np.argsort(-(share * batch - counts))[: batch - counts.sum()]:
        counts[i] += 1
    lens = np.repeat(words, counts)
    return np.random.default_rng(derive(seed, f"lens{index}")).permutation(lens)


def sentences(seed: int, index: int, batch: int, m: dict, weights: Dict[str, float],
              device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of training captions: word ids uniform over the
    vocabulary's words (every id below <sos>), <eos> after the last word,
    <pad> after that; ``sent_len`` counts the words and the <eos>."""
    words = sentence_lengths(seed, index, batch, weights)
    length = m["max_len"]
    if words.max() >= length:
        raise ValueError(f"a caption of {words.max()} words and <eos> exceeds "
                         f"max_len={length}")
    gen = generator(seed, f"sent{index}", device)
    ids = torch.randint(0, m["sos_id"], (batch, length), generator=gen, device=device)
    n = torch.as_tensor(words, device=device)[:, None]
    pos = torch.arange(length, device=device)[None]
    sent = torch.where(pos < n, ids, torch.where(pos == n, m["eos_id"], m["pad_id"]))
    return {"sent": sent.to(torch.int32), "sent_len": (n[:, 0] + 1).to(torch.int32),
            "valid": torch.ones((batch,), dtype=torch.float32, device=device)}
