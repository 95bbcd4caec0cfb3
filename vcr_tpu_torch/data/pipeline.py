"""Host-side input pipeline producing fixed-shape numpy batches: the
counterpart of ``vcr_tpu/data/pipeline.py``.

* Every batch has the same shapes: the final partial batch is zero-padded to
  the batch size and carries a ``valid`` (B,) mask.
* Per item: per-video .npy features zero-padded or truncated to
  ``num_frames``, one caption drawn per epoch, lowercased, <unk>-mapped,
  <eos>-terminated and <pad>-padded to ``max_len``, and the reference strings
  for the caption metrics.
* ``num_shards``/``shard_index`` take a strided shard of the samples per
  process; one process (1 and 0) until multi-device training is ported
  (ROADMAP A15).

Features load through a thread pool with ``np.load``: .npy reads release the
interpreter lock. The JAX package also has a C++ batch loader
(``vcr_tpu/data/native.py``); this package has none yet (ROADMAP A20), and
loads every batch this way.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List

import numpy as np

from vcr_tpu_torch.data.captions import read_caption_file
from vcr_tpu_torch.vocab import Vocab


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Run the underlying iterator in a background thread with a bounded
    queue, overlapping host-side batch assembly (and the copy to the device)
    with the current step.

    Abandon-safe: if the consumer stops iterating early, the generator's
    finally sets a stop event and drains the queue, so the worker, which puts
    with a timeout and re-checks the event, exits instead of blocking on a
    full queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        while True:  # unblock a worker mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break


class CaptionDataset:
    """One corpus split: msvd and msvd_vgg keyed by 'video_key', msrvtt by
    'video_id'. Reads the CNN features under ``feats/``; SpatialNet's box
    features (``bbox_feats/``) come with its workload, ROADMAP A11."""

    def __init__(self, root: str, corpus: str, split: str, vocab: Vocab,
                 num_frames: int, max_len: int):
        if corpus not in ("msvd", "msvd_vgg", "msrvtt"):
            raise NotImplementedError(f"Unknown corpus {corpus!r}")
        self.key_field = "video_id" if corpus == "msrvtt" else "video_key"
        self.corpus_dir = os.path.join(root, corpus)
        self.captions = read_caption_file(
            os.path.join(self.corpus_dir, f"{split}_captions.json"))
        self.vocab = vocab
        self.num_frames = num_frames
        self.max_len = max_len
        self.vid_feat_dir = os.path.join(self.corpus_dir, "feats/")

    def __len__(self) -> int:
        return len(self.captions)

    def load_features(self, idx: int) -> np.ndarray:
        """One video's features, zero-padded or truncated to num_frames."""
        key = self.captions[idx][self.key_field]
        feats = np.load(os.path.join(self.vid_feat_dir, key + ".npy"))
        return np.concatenate(
            [feats, np.zeros((max(0, self.num_frames - feats.shape[0]),
                              *feats.shape[1:]), dtype=feats.dtype)],
            axis=0)[: self.num_frames].astype(np.float32)

    def text_fields(self, idx: int, cap_choice: int) -> Dict:
        """The text half of a sample. ``cap_choice`` picks the caption; the
        caller draws it (np.random.Generator is not thread-safe)."""
        caps = self.captions[idx]["captions"]
        sent_toks = caps[cap_choice % len(caps)]["desc"]
        return {
            "sent": self.vocab.encode(sent_toks, self.max_len),
            "sent_raw": " ".join(sent_toks).lower(),
            "sent_len": min(self.max_len, len(sent_toks) + 1),
            "refs": [" ".join(c["desc"]).lower() for c in caps],
            "vid_key": self.captions[idx][self.key_field],
        }

    def item(self, idx: int, cap_choice: int) -> Dict:
        out = self.text_fields(idx, cap_choice)
        out["vid_feats"] = self.load_features(idx)
        return out


class BatchIterator:
    """Epoch iterator over fixed-shape batches.

    Yields dicts with numpy arrays: vid_feats (B, ...), sent (B, L) int32,
    sent_len (B,) int32, valid (B,) float32, sample_idx (B,) int32 (the
    dataset index of each row, -1 for padding), and host-side lists refs /
    vid_key / sent_raw. B is constant; short final batches are padded with
    zeros and valid=0 rows.

    The order of an epoch comes from ``np.random.default_rng((seed,
    epoch))``, which also draws each row's caption choice, even for the
    batches that ``skip_next`` (a mid-epoch resume) skips, so every later
    batch is the one an unskipped epoch gives.
    """

    def __init__(self, dataset: CaptionDataset, batch_size: int, shuffle: bool,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                 num_threads: int = 8):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self.skip_next = 0  # mid-epoch resume: batches to skip, consumed once
        # num_threads <= 0: load synchronously, through one thread
        self.num_threads = max(1, num_threads)
        self._pool = ThreadPoolExecutor(max_workers=self.num_threads)
        self._pad_shape = None

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_index::self.num_shards]
        b = self.batch_size
        skip = self.skip_next
        self.skip_next = 0

        # strided shards differ in length by up to 1: every shard iterates
        # the largest shard's batch count, the exhausted ones emitting
        # all-padding batches, so processes stay in lockstep. Skipped
        # batches count as emitted.
        emitted = skip
        if self.num_shards > 1:
            max_shard = -(-len(self.ds) // self.num_shards)
            target = -(-max_shard // b)
        else:
            target = None

        for start in range(0, len(order), b):
            idxs = order[start:start + b]
            # drawn even for skipped batches: the stream stays the
            # unskipped epoch's
            cap_choices = rng.integers(0, 2 ** 31, size=len(idxs))
            if skip > 0:
                skip -= 1
                continue  # no feature IO for a skipped batch
            yield self._python_batch(idxs, cap_choices, b)
            emitted += 1
        if target is not None:
            while emitted < target:
                yield self._empty_batch(b)
                emitted += 1
        self.epoch += 1

    def _empty_batch(self, b):
        """All-padding batch (valid=0 everywhere), for shard lockstep."""
        if self._pad_shape is None:
            self._pad_shape = tuple(self.ds.load_features(0).shape[1:])
        feats = np.zeros((b, self.ds.num_frames, *self._pad_shape), np.float32)
        return self._assemble(b, feats, [], [], [], [], [])

    def _assemble(self, b, feats, sents, lens, raws, refs, keys, idxs=()):
        batch = {
            "vid_feats": feats,
            "sent": np.zeros((b, self.ds.max_len), np.int32),
            "sent_len": np.zeros((b,), np.int32),
            "valid": np.zeros((b,), np.float32),
            "sample_idx": np.full((b,), -1, np.int32),
            "refs": refs, "vid_key": keys, "sent_raw": raws,
        }
        for j in range(len(sents)):
            batch["sent"][j] = sents[j]
            batch["sent_len"][j] = lens[j]
            batch["valid"][j] = 1.0
        for j, idx in enumerate(idxs):
            batch["sample_idx"][j] = int(idx)
        return batch

    def _python_batch(self, idxs, cap_choices, b):
        items = list(self._pool.map(
            lambda pair: self.ds.item(int(pair[0]), int(pair[1])),
            zip(idxs, cap_choices)))
        feats = np.zeros((b, *items[0]["vid_feats"].shape), np.float32)
        for j, it in enumerate(items):
            feats[j] = it["vid_feats"]
        return self._assemble(
            b, feats,
            [it["sent"] for it in items], [it["sent_len"] for it in items],
            [it["sent_raw"] for it in items], [it["refs"] for it in items],
            [it["vid_key"] for it in items], idxs)
