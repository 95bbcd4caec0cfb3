"""The host-side slot scheduler of continuous-batching serving.

The counterpart of ``run_slot_scheduler`` in
``vcr_tpu/serving_continuous.py``. It drives any object that speaks the
scheduler-ops protocol: the live pool
(``serving_continuous.ContinuousCaptioner``) and a frozen one
(``export_continuous.ContinuousArtifact``), and the seeds of their
per-request random streams. It imports numpy and the span recorder
(``utils.profiling``, which loads no torch) only, so a serving host that
runs a frozen pool loads no model code with it. Each round's device half
runs under the spans ``pool.admit`` (with the admitted keys), ``pool.tick``,
``pool.poll`` and ``pool.harvest``.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from vcr_tpu_torch.utils.profiling import span


def run_slot_scheduler(ops, requests: Iterable[Optional[Tuple[object, np.ndarray]]],
                       *, poll_cancelled=None) -> Iterator[Tuple[object, np.ndarray]]:
    """The host-side slot scheduler. ``ops`` supplies the device half:

      slots / admit_chunk / step_chunk : pool geometry (ints)
      stats : dict, in_flight : int    : observability (mutated here)
      encode_admit(feats (A,...), ids (A,), valid (A,)) : encode a chunk and
          copy it into the slots
      tick() : advance all slots step_chunk tokens
      poll_active() -> np.bool_ (R,)   : which slots still decode
      read_tokens() -> (toks (R, L), steps (R,)) numpy

    ``requests``: an iterable of (key, feats), or (key, feats, opts) where
    ``opts`` is a per-request dict (sampling parameters); forwarding opts
    needs ``ops.accepts_request_opts`` (a ValueError otherwise). Pulled
    lazily, so a generator models live arrivals. A live source may yield
    ``None`` as a poll marker ("nothing available right now"), which skips
    admission for that round instead of blocking in-flight decodes; it ends
    the stream by returning. Yields (key, tokens (n,) int32 ending at eos or
    max_len) in COMPLETION order.

    ``poll_cancelled`` (optional): a callable taking the set of outstanding
    request keys (queued, and in flight where ``ops.release_slots`` exists)
    and returning the subset to cancel. Queued cancels are dropped;
    in-flight cancels release their slots through ``ops.release_slots(ids)``.
    Cancelled keys are never yielded; ``ops.stats["cancelled"]`` counts
    them.
    """
    a = ops.admit_chunk
    accepts_opts = getattr(ops, "accepts_request_opts", False)
    can_release = hasattr(ops, "release_slots")
    queue: deque = deque()
    req_iter = iter(requests)
    pending: Dict[int, object] = {}       # slot -> request key
    free = list(range(ops.slots - 1, -1, -1))
    exhausted = False
    feat_shape = None  # from the first request: SpatialNet's features are
    #                    (N, F, K, K), the others' (N, Dv)

    while True:
        # refill the host-side queue enough to fill free slots
        while not exhausted and len(queue) < min(len(free), a):
            try:
                item = next(req_iter)
            except StopIteration:
                exhausted = True
                break
            if item is None:      # poll marker: keep ticking
                break
            queue.append(item)
        # sweep cancellations after the refill and before admission: a
        # freshly pulled request is checked before it reaches the card, and a
        # released slot is admittable this same round
        if poll_cancelled is not None and (pending or queue):
            outstanding = {it[0] for it in queue}
            if can_release:
                outstanding |= set(pending.values())
            gone = poll_cancelled(outstanding)
            if gone:
                n_q = len(queue)
                queue = deque(it for it in queue if it[0] not in gone)
                n_cancel = n_q - len(queue)
                slot_ids = [s for s, key in pending.items() if key in gone]
                if slot_ids:
                    ops.release_slots(np.asarray(slot_ids, np.int32))
                    for s in slot_ids:
                        pending.pop(s)
                        free.append(s)
                    n_cancel += len(slot_ids)
                    ops.in_flight = len(pending)
                ops.stats["cancelled"] = ops.stats.get("cancelled", 0) + n_cancel
        # admit up to A requests into free slots (a fixed-shape chunk)
        if queue and free:
            n = min(len(queue), len(free), a)
            if feat_shape is None:
                feat_shape = tuple(np.asarray(queue[0][1]).shape)
            feats = np.zeros((a,) + feat_shape, np.float32)
            ids = np.zeros((a,), np.int32)
            valid = np.zeros((a,), bool)
            keys = []
            chunk_opts = [None] * a
            for j in range(n):
                item = queue.popleft()
                key, f = item[0], item[1]
                opt = item[2] if len(item) > 2 else None
                if opt and not accepts_opts:
                    raise ValueError(
                        f"request {key!r} carries opts {sorted(opt)} but this pool "
                        "does not accept per-request options (greedy or beam mode)")
                feats[j] = np.asarray(f, np.float32).reshape(feat_shape)
                ids[j] = free.pop()
                valid[j] = True
                keys.append(key)
                chunk_opts[j] = opt
            ops.stats["admit_chunks"] += 1
            with span("pool.admit", keys=keys):
                if accepts_opts:
                    ops.encode_admit(feats, ids, valid, chunk_opts)
                else:
                    ops.encode_admit(feats, ids, valid)
            for j in range(n):
                pending[int(ids[j])] = keys[j]
            ops.in_flight = len(pending)

        if not pending:
            if exhausted and not queue:
                return
            continue

        # advance all slots, then harvest finished ones
        with span("pool.tick"):
            ops.tick()
        ops.stats["ticks"] += 1
        ops.stats["slot_steps"] += ops.slots * ops.step_chunk
        with span("pool.poll"):
            active = ops.poll_active()
        done = [s for s in pending if not active[s]]
        if done:
            with span("pool.harvest"):
                toks, steps = ops.read_tokens()
            for s in done:
                ops.stats["served"] += 1
                ops.stats["useful_steps"] += int(steps[s])
                result = pending.pop(s), toks[s, : steps[s]].copy()
                ops.in_flight = len(pending)
                free.append(s)
                yield result


def stream_seed(seed: int, *index) -> int:
    """A generator seed from ``seed`` and an index tuple, the same on every
    host and for every pool geometry: the live pool and its artifact seed
    their draws of an admission with it."""
    digest = hashlib.blake2b(repr((int(seed),) + index).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1
