"""Continuous-batching caption serving: a pool of decode slots on the card.

The counterpart of ``vcr_tpu/serving_continuous.py``. Whole-batch serving
(``serving.build_captioner``) pays for its slowest row, and a new request
waits for the batch to drain. Here a fixed pool of R decode slots advances
one token at a time across every slot; the host harvests the slots that
finished and refills them from a request queue.

* Admission encodes a fixed-size chunk of A videos through the family's
  encoder (kernel B1 for S2VT's encode and prime, S2VT-att's encode and
  SpatialNet-over-S2VT's prime; B2 for RationaleNet's generator), then
  copies the valid rows into their slots (``index_copy_``). Every state
  leaf has one slot more than the pool, the sink slot R, which nothing
  reads: the invalid rows of an incomplete chunk are written there, so the
  slot their padded id names is left untouched, with no host-side
  selection of rows (the JAX package drops them at index R).
* A tick advances every slot ``step_chunk`` tokens with the family's decode
  cell: ``decode._s2vt_stepper``, ``decode._s2vt_att_stepper``, or the
  Transformer's ``make_slot_stepper``, whose rows each carry a position.
* A finished slot is not masked out of the cell: its row free-runs on
  garbage that nobody reads until the next admission resets it. Only the
  bookkeeping (last, steps, active, toks) is masked by ``active``, so a
  slot's tokens equal the batch greedy's cut at its first eos.
* Per tick the host reads the (R,) ``active`` flags and, when a slot
  finished, the (R, L) tokens and (R,) lengths: nothing else leaves the
  card.

The device half is three tensor-only functions, ``encode``, ``admit``
(which writes rows in place) and ``step`` (which returns a new state), that
``export_continuous`` freezes as they are, so a live pool and its artifact
decode identically. Every state leaf is a tensor of its own.
Each public operation runs under ``torch.inference_mode()``, whichever
thread calls it; the kernels launch on that thread's current stream, the
default one unless the caller chose another.

Beam search (``beam_size=K``): each slot owns K adjacent rows running
``decode.beam_search``'s step (two-stage top-k with ``lax.top_k``'s tie
order, eos-clamped continuation, within-slot reorder); a slot's harvest is
its best beam cut at the first eos, equal to the batch beam's best row. The
Transformer's beam is the lineage slot stepper: reordering moves only the
ancestry matrix.

Sampling: each request's stream depends only on the request (its admission
index and its row in the admission chunk) and the step, never on the pool's
size or on other slots. At admission its (max_len, V) Gumbel block is drawn
from a generator seeded with (seed, admission index, row); step s adds row
s to the filtered logits and takes the argmax, the form of
``jax.random.categorical``. RationaleNet's frame-selection noise of a chunk
comes from a generator seeded with (seed, admission index). Both can be
injected (``select_noise``, ``sample_noise``), as the tests inject the JAX
package's noise: JAX's random streams cannot be reproduced in torch.

Quantized modes: ``decode_weights="int8"`` (all five families) quantizes
the per-step dense weights once, at construction: the Transformer's decoder
denses are replaced by int8 codes, the GRU families' step dicts augmented
beside their float32 originals, which the encoders keep reading (B1 and B2
launch as before). ``kv_cache="int8"|"int4"`` (the Transformer's) stores its
self and cross K/V caches quantized.

Several processes (``mesh``, a ``parallel.mesh.Mesh`` of dp x mp processes,
one device each): dp index d holds the slots ``parallel.mesh.slot_block``
gives it, R/dp of them, and a sink slot of its own; mp splits the vocab
projection and the embedding as training does, and every other weight is
replicated. Every rank encodes the whole admission chunk and draws what the
one-process pool draws (RationaleNet's selection per admission, the
sampling streams per admitted row), then writes only the rows whose slots
it owns; the others go to its sink. A tick steps each rank's own rows:
under mp the greedy token is ``sharded_argmax``'s and the embedding
``embed_rows``', while the beam's top-k and the sampling filters run on the
full logits (``gather_vocab``): simple and exact, since mp serving buys
memory for a large vocab, not speed. ``poll_active`` and ``read_tokens``
return every slot's, gathered over dp. Rank 0 leads: each public operation
sends its command (``parallel.mesh.send_command``) before it runs, under the
lock of the pools' :class:`CommandChannel` (one for all of a process's pools
on a mesh), so ``run_slot_scheduler`` drives a sharded pool as it drives one
pool; ranks > 0 call :func:`follow`, which runs what they receive until rank
0's :func:`stop_followers`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from vcr_tpu_torch.decode import (NEG_INF, _s2vt_att_stepper, _s2vt_stepper, _top_k,
                                  augment_decode_weights, check_gru_kv_cache)
from vcr_tpu_torch.device import params_to, resolve_device
from vcr_tpu_torch.models import base as model_base
from vcr_tpu_torch.models import rationale, s2vt, s2vt_att, spatial
from vcr_tpu_torch.models import transformer as tr
from vcr_tpu_torch.nn.attention import bahdanau_project_keys
from vcr_tpu_torch.nn.gumbel import sample_gumbel
from vcr_tpu_torch.nn.layers import vocab_scope
from vcr_tpu_torch.scheduler import run_slot_scheduler, stream_seed
from vcr_tpu_torch.serving import resolve_eos_id

_ARCHS = ("s2vt", "s2vt-att", "spatial", "rationale", "transformer")

# A command names its operation by its index here and its pool by the order
# in which the process built its channel's pools, which every rank builds in
# one order.
_COMMANDS = ("stop", "noop", "admit", "tick", "poll", "read", "release")
# rank 0 of an idle daemon sends a command this often (keepalive)
KEEPALIVE_S = 5.0


class CommandChannel:
    """How rank 0 drives the sharded pools that one process builds on a
    mesh: the pools in the order built, the group the commands travel on
    (``parallel.mesh.host_group``), the lock rank 0 sends and runs each
    command under, and when it last sent one. Under the lock the commands of
    several pools driven from several threads reach every rank in the order
    rank 0 runs them. Every rank makes it (collective), in one order with
    its pools."""

    def __init__(self, mesh):
        from vcr_tpu_torch.parallel.mesh import host_group

        self.mesh = mesh
        self.group = host_group()
        self.pools = []
        self.lock = threading.Lock()
        self.last_command = 0.0

    def send(self, name: str, arrays=(), pool: int = 0) -> None:
        """Rank 0, under :attr:`lock`: send command ``name``."""
        from vcr_tpu_torch.parallel.mesh import send_command

        send_command(self.group, _COMMANDS.index(name), arrays, pool)
        self.last_command = time.monotonic()

    def gather_rows(self, local: np.ndarray) -> np.ndarray:
        """Each dp index's host ``local`` rows (one shape on all ranks, the
        same on the mp ranks of a dp index) concatenated in dp order, on
        every rank: an all-reduce of a CPU zero buffer over the channel's
        group, so a poll sends nothing to a device and back."""
        import torch.distributed as dist

        mesh, local = self.mesh, np.ascontiguousarray(local)
        if mesh.dp == 1:
            return local
        src = torch.from_numpy(local)
        buf = torch.zeros((mesh.dp * mesh.mp, *local.shape), dtype=src.dtype)
        buf[mesh.rank] = src
        dist.all_reduce(buf, group=self.group)
        return buf[::mesh.mp].reshape(-1, *local.shape[1:]).numpy()


def follow(channel: CommandChannel) -> None:
    """Ranks > 0 of a mesh: run rank 0's commands on the channel's pools
    until it sends stop (:func:`stop_followers`). A broken group raises."""
    if channel.mesh.rank == 0:
        raise RuntimeError("rank 0 leads a sharded pool; the other ranks follow")
    from vcr_tpu_torch.parallel.mesh import recv_command

    while True:
        op, pool, arrays = recv_command(channel.group)
        name = _COMMANDS[op]
        if name == "stop":
            return
        if name != "noop":
            channel.pools[pool]._run(name, arrays)


def stop_followers(channel: CommandChannel) -> None:
    """Rank 0: end every follower's :func:`follow`. A command sent after it
    reaches no follower until they follow again."""
    with channel.lock:
        channel.send("stop")


def keepalive(channel: CommandChannel) -> None:
    """Rank 0: send a command that does nothing where none went for
    :data:`KEEPALIVE_S` seconds, so that an idle pool's followers, which
    wait in a collective, stay inside the process group's timeout."""
    with channel.lock:
        if time.monotonic() - channel.last_command >= KEEPALIVE_S:
            channel.send("noop")


def _row_sampling_filters(logits: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
                          topp: torch.Tensor) -> torch.Tensor:
    """Row-wise ``decode.apply_sampling_filters``: (R, V) logits filtered by
    per-row temperature / top_k / top_p tensors (0 turns a filter off for
    that row, as in the scalar version)."""
    v = logits.shape[-1]
    lg = logits.float() / temp.clamp(min=1e-6)[:, None]
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    k_idx = (topk.long() - 1).clamp(0, v - 1)[:, None]
    kth = sorted_lg.gather(-1, k_idx)
    lg = torch.where((topk[:, None] > 0) & (lg < kth), NEG_INF, lg)
    probs = torch.softmax(lg, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    before = torch.cumsum(sp, dim=-1) - sp                      # mass above
    keep = (before < topp[:, None]).sum(dim=-1, keepdim=True)
    thresh = sp.gather(-1, (keep - 1).clamp(0, v - 1))
    apply_p = (topp > 0.0) & (topp < 1.0)
    return torch.where(apply_p[:, None] & (probs < thresh), NEG_INF, lg)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nests of dicts and tuples of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class ContinuousCaptioner:
    """The slot pool (see the module docstring).

    Args:
      params / spec: a model of any of the five families.
      slots: R, the pool's size (the serving batch).
      admit_chunk: A, videos encoded per admission (a fixed shape; the
        queue is drained A at a time into free slots).
      step_chunk: decode tokens per tick between host polls, at most
        max_len.
      eos_id / vocab: the end token (``serving.resolve_eos_id``).
      rng: int seed of RationaleNet's frame selection and of the sampling
        streams (see the module docstring).
      mesh: a ``parallel.mesh.Mesh`` of the initialised process group: the
        slots shard over dp (slots % dp == 0) and the vocab projection and
        embedding over mp (the padded vocab % mp == 0); every rank builds
        the pool from the same whole ``params``. Rank 0 drives it; ranks
        > 0 call :func:`follow` (see the module docstring).
      channel: the :class:`CommandChannel` of ``mesh``. Pools that one
        process drives at once on a mesh (a daemon serving several models)
        must share one, since a command names its pool by its index in the
        channel; None makes one for this pool alone.
      beam_size: K > 1 makes each slot a beam of K rows.
      sample_temperature / sample_top_k / sample_top_p: temperature > 0
        samples per slot (beam_size 1 only): the logits pass the row-wise
        ``decode.apply_sampling_filters`` and each slot draws from its own
        stream. top_k=1 is argmax and equals the greedy pool exactly.
      request_sampling: accept per-request opts ({"temperature", "top_k",
        "top_p"}, any subset), which override the pool's defaults for that
        slot. A request without opts decodes greedily unless the pool
        samples. Implied by sample_temperature > 0.
      kv_cache: "bf16" (None), or the Transformer's quantized "int8" or
        "int4" K/V caches; a GRU family raises ValueError for those.
      decode_weights: "bf16" (None) or "int8", every family (see the
        module docstring). Both modes are bounded-error: their tokens are
        not the bf16 pool's.
      select_noise: (admission index) -> (A, N, 2) Gumbel noise of that
        chunk's frame selection (RationaleNet); None draws it.
      sample_noise: (admission index, chunk row) -> (max_len, padded vocab)
        Gumbel noise of that request's sampling steps; None draws it.
      device: where the pool lives: the card unless given (``"cpu"`` runs
        the plain versions); under a mesh, the mesh's device unless given.
    """

    def __init__(self, params, spec: model_base.ModelSpec, *,
                 slots: int = 64, admit_chunk: int = 8, step_chunk: int = 4,
                 eos_id: Optional[int] = None, vocab=None, rng: Optional[int] = None,
                 mesh=None, channel: Optional[CommandChannel] = None,
                 beam_size: int = 1,
                 sample_temperature: float = 0.0, sample_top_k: int = 0,
                 sample_top_p: float = 0.0, request_sampling: bool = False,
                 kv_cache: Optional[str] = None, decode_weights: Optional[str] = None,
                 select_noise: Optional[Callable] = None,
                 sample_noise: Optional[Callable] = None, device=None):
        if spec.arch not in _ARCHS:
            raise NotImplementedError(f"continuous serving covers {_ARCHS}; got {spec.arch!r}")
        if not 1 <= admit_chunk <= slots:
            raise ValueError("need 1 <= admit_chunk <= slots")
        if (sample_temperature > 0 or request_sampling) and beam_size > 1:
            raise ValueError("per-slot sampling and beam search are mutually exclusive "
                             "(beam maximizes sequence log-prob; sampling draws from it)")
        self.kv_cache, self.decode_weights = model_base.check_serving_modes(
            kv_cache, decode_weights)
        # this process's slots [offset, offset + local); the sink is row local
        self.mesh, self._offset, self._local, self._shard = mesh, 0, slots, None
        if mesh is not None:
            from vcr_tpu_torch.parallel import mesh as pmesh

            if self.decode_weights == "int8" and mesh.mp > 1:
                raise ValueError("decode_weights='int8' with an mp>1 mesh is unsupported: "
                                 "the int8 vocab projection does not column-shard")
            self._offset, stop = pmesh.slot_block(mesh, slots)
            self._local = stop - self._offset
            if mesh.mp > 1 and spec.padded_vocab_size % mesh.mp:
                raise ValueError(
                    f"padded vocab {spec.padded_vocab_size} not divisible by mesh "
                    f"mp={mesh.mp}: the vocab projection and embedding cannot shard. Set "
                    "vocab_pad_to to a multiple of mp (or pass an mp=1 mesh)")
            device = mesh.device if device is None else device
        self.device = resolve_device(device)
        self.spec = spec
        self.params = params_to(params, self.device)
        if mesh is not None and mesh.mp > 1:
            specs = pmesh.param_specs(self.params, spec.padded_vocab_size, mesh.mp)
            self.params = pmesh.shard_params(self.params, mesh, specs)
            self._shard = pmesh.vocab_shard_for(self.params, specs, mesh,
                                                spec.padded_vocab_size)
        self.slots = slots
        self.admit_chunk = admit_chunk
        self.step_chunk = min(step_chunk, spec.max_len)
        self.beam_size = beam_size
        self.eos_id = resolve_eos_id(spec, eos_id, vocab)
        self.seed = 0 if rng is None else int(rng)
        self.sample_temperature = sample_temperature
        self.sample_top_k = sample_top_k
        self.sample_top_p = sample_top_p
        self._sample = sample_temperature > 0 or request_sampling
        # the scheduler checks this before forwarding per-request opts
        self.accepts_request_opts = self._sample
        # per-row defaults for requests without opts: the pool's sampling
        # knobs when set, else exact greedy (T=1, top_k=1 is argmax)
        self._row_defaults = ((sample_temperature, sample_top_k, sample_top_p)
                              if sample_temperature > 0 else (1.0, 1, 0.0))
        self._select_noise = select_noise
        self._sample_noise = sample_noise
        self._admit_count = 0
        self.stats = {"ticks": 0, "admit_chunks": 0, "served": 0,
                      "useful_steps": 0, "slot_steps": 0, "cancelled": 0}
        # occupied slots, kept by the scheduler: a polling request source
        # blocks while the pool is idle and polls while decodes are in flight
        self.in_flight = 0

        # the tick tree: spatial and rationale decode through their wrapped
        # captioner. Under int8 decode weights it is quantized once, here:
        # the Transformer's decoder denses replaced, the GRU families' step
        # dicts augmented beside their float32 originals, which the encoders
        # keep reading (B1 and B2 launch as before). One tree serves encode
        # and step, as the artifact's one weights file does.
        self._base = spec.base_arch if spec.arch in ("spatial", "rationale") else spec.arch
        if spec.arch in ("spatial", "rationale"):
            model_base.base_module(spec)  # raises for an unknown base
        check_gru_kv_cache(spec, self.kv_cache)
        self._step_params = (augment_decode_weights(self.params, spec)
                             if self.decode_weights == "int8" else self.params)
        self._fns = self._device_fns(self._step_params)
        with torch.inference_mode():
            self.state = self._init_state()
        self.channel = None
        if mesh is not None:
            if channel is not None and channel.mesh is not mesh:
                raise ValueError("the channel belongs to another mesh")
            self.channel = CommandChannel(mesh) if channel is None else channel
            self._pool_index = len(self.channel.pools)
            self.channel.pools.append(self)

    # ---------------------------------------------------------- device fns
    #
    # encode, admit and step take and return tensors only (nests of dicts of
    # them), so export_continuous freezes exactly these three, and a live
    # pool and its artifact decode identically, chunk for chunk. Every state
    # leaf has one row (K rows in beam mode) more than the pool has slots:
    # the sink slot R, where admission writes the rows of an incomplete
    # chunk. Nothing reads it.

    def _dec_params(self, params):
        return params["caption_net"] if self.spec.arch in ("spatial", "rationale") \
            else params

    def _device_fns(self, params):
        """The tick tree's closures: the decode cell ``cell(dec, words,
        state) -> (dec, logits)`` and, for the Transformer, the slot
        stepper's ``init_self`` and ``cross_state``. Built once for the
        pool's own tree, anew for another (the tree that torch.export
        traces)."""
        if getattr(self, "_fns", None) is not None and params is self._step_params:
            return self._fns
        spec, k, dw = self.spec, self.beam_size, self.decode_weights
        dec_params = self._dec_params(params)
        fns = {}
        if self._base == "transformer":
            slot_step, fns["init_self"], fns["cross_state"] = tr.make_slot_stepper(
                dec_params, spec, beam_tile=k, lineage=k > 1, kv_cache=self.kv_cache,
                decode_weights=dw)

            def cell(dec, words, st):
                steps = st["gstep"].repeat_interleave(k) if k > 1 else st["steps"]
                return slot_step(dec, words, steps.clamp(max=spec.max_len - 1))
        elif self._base == "s2vt":
            s2vt_step = _s2vt_stepper(dec_params, spec, (self._local + 1) * k, dw)

            def cell(dec, words, st):
                return s2vt_step(dec, words, 0)
        else:
            def cell(dec, words, st):
                step = _s2vt_att_stepper(dec_params, spec, dec["pk"], dec["eo"], dw)
                new_inner, logits = step({"h": dec["h"]}, words, 0)
                return dict(dec, **new_inner), logits
        fns["cell"] = cell
        return fns

    def _zeros_dec_state(self, rows: int):
        spec, dev = self.spec, self.device
        if self._base == "transformer":
            d_k = tr._attn_hidden(self._dec_params(self._step_params)["decoder"]["layers"]) \
                // spec.tf_heads
            return {**self._fns["init_self"](rows),
                    **{f"x{li}": tr._zero_kv(rows, spec.tf_heads, spec.num_frames, d_k,
                                             spec.cdtype, self.kv_cache, dev)
                       for li in range(spec.tf_layers)}}

        def h():
            return torch.zeros((rows, spec.hidden_size), dtype=torch.float32, device=dev)
        if self._base == "s2vt":
            return {"s1": h(), "s2": h()}
        # eo is stored at the compute dtype: the context product reads it
        # only through that cast, so the bits are the batch stepper's. pk
        # stays float32: it enters tanh beside the float32 query uncast.
        n = spec.num_frames
        return {"h": h(),
                "pk": torch.zeros((rows, n, spec.hidden_size), dtype=torch.float32,
                                  device=dev),
                "eo": torch.zeros((rows, n, spec.hidden_size), dtype=spec.cdtype,
                                  device=dev)}

    def _init_state(self):
        """The empty pool: this process's slots and its sink slot."""
        r, l, dev = self._local + 1, self.spec.max_len, self.device

        def i32(n, value=0):
            return torch.full((n,), value, dtype=torch.int32, device=dev)
        common = {"steps": i32(r),
                  "active": torch.zeros((r,), dtype=torch.bool, device=dev),
                  "toks": torch.zeros((r, l), dtype=torch.int32, device=dev)}
        if self.beam_size == 1:
            st = {"dec": self._zeros_dec_state(r), "last": i32(r, self.spec.sos_id),
                  **common}
            if self._sample:
                t0, k0, p0 = self._row_defaults
                st["stemp"] = torch.full((r,), t0, dtype=torch.float32, device=dev)
                st["stopk"] = i32(r, k0)
                st["stopp"] = torch.full((r,), p0, dtype=torch.float32, device=dev)
                st["gumbel"] = torch.zeros((r, l, self.spec.padded_vocab_size),
                                           dtype=torch.float32, device=dev)
            return st
        rows = r * self.beam_size
        # each slot owns K adjacent rows; "steps" is the harvest length the
        # scheduler reads (the best beam's first-eos cut), "gstep" counts the
        # decode steps
        return {"dec": self._zeros_dec_state(rows), "last": i32(rows, self.spec.sos_id),
                "scores": torch.zeros((rows,), dtype=torch.float32, device=dev),
                "bfin": torch.zeros((rows,), dtype=torch.bool, device=dev),
                "btoks": torch.zeros((rows, l), dtype=torch.int32, device=dev),
                "gstep": i32(r), **common}

    def _select_noise_for(self, admit: int, shape) -> torch.Tensor:
        if self._select_noise is not None:
            return torch.as_tensor(self._select_noise(admit), dtype=torch.float32,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, "select", admit))
        return sample_gumbel(shape, gen, self.device)

    def _sample_noise_for(self, admit: int, row: int) -> torch.Tensor:
        if self._sample_noise is not None:
            return torch.as_tensor(self._sample_noise(admit, row), dtype=torch.float32,
                                   device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, "sample", admit, row))
        return sample_gumbel((self.spec.max_len, self.spec.padded_vocab_size), gen,
                             self.device)

    def encode(self, params, feats: torch.Tensor,
               select_noise: Optional[torch.Tensor] = None):
        """(A, N, Dv) float32 (SpatialNet: (A, N, F, K, K)) -> the A rows of
        decode state: one fixed-shape encoder forward per chunk, over the
        tick tree ``params``. Features enter as the batch decodes take them:
        at the compute dtype, except SpatialNet's. RationaleNet's frame
        selection adds ``select_noise`` (A, N, 2)."""
        spec, cd = self.spec, self.spec.cdtype
        arch = spec.arch
        if arch == "rationale":
            feats, _ = rationale.generator(params["gen"], spec, feats.to(cd),
                                           gumbel_noise=select_noise, train=False)
            params, arch = params["caption_net"], spec.base_arch
        elif arch == "spatial":
            outs, state, _, _ = spatial.encode_for_base(params, spec, feats, train=False)
            cap = params["caption_net"]
            if spec.base_arch == "s2vt":
                return {"s1": state, "s2": s2vt._prime_state2(cap, spec, outs)}
            return {"h": state, "eo": outs.to(cd),
                    "pk": bahdanau_project_keys(cap["decoder"]["attention"], outs, cd)}
        elif arch == "transformer":
            vf = feats.to(cd)
            e_out = tr.encode(params, spec, vf, tr.create_masks_inp(vf))
            fns = self._device_fns(params)
            # the self caches ride along as zeros, so admission also resets
            # the slot's caches
            return {**fns["init_self"](feats.shape[0]), **fns["cross_state"](e_out)}
        else:
            feats = feats.to(cd)
        if arch == "s2vt":
            enc_outs, s1 = s2vt.encode(params, spec, feats)
            return {"s1": s1, "s2": s2vt._prime_state2(params, spec, enc_outs)}
        eo, h = s2vt_att.encode(params, spec, feats)
        return {"h": h, "eo": eo.to(cd),
                "pk": bahdanau_project_keys(params["decoder"]["attention"], eo, cd)}

    def admit(self, state, new_dec, ids: torch.Tensor, valid: torch.Tensor,
              row_opts=None, row_noise: Optional[torch.Tensor] = None):
        """Copy the rows of ``new_dec`` into slots ``ids`` (A,) and reset the
        slots' bookkeeping, in place; -> ``state``. A row that is not
        ``valid`` goes to the sink slot R instead, so the slot its padded
        id names (0, as the scheduler pads) is left as it was. Sampling
        also installs each request's filters ``row_opts`` (temp, top_k,
        top_p), (A,) each, and Gumbel block ``row_noise`` (A, L, V)."""
        k, sos = self.beam_size, self.spec.sos_id
        ids = torch.where(valid, ids.long(), self._local)
        if k == 1:
            _tree_map(lambda leaf, new: leaf.index_copy_(0, ids, new.to(leaf.dtype)),
                      state["dec"], new_dec)
            state["last"].index_fill_(0, ids, sos)
            if self._sample:
                for name, x in zip(("stemp", "stopk", "stopp", "gumbel"),
                                   (*row_opts, row_noise)):
                    state[name].index_copy_(0, ids, x.to(state[name].dtype))
        else:
            arange_k = torch.arange(k, device=ids.device)
            row_ids = (ids[:, None] * k + arange_k[None]).reshape(-1)
            tiled = _tree_map(lambda x: x.repeat_interleave(k, dim=0), new_dec)
            _tree_map(lambda leaf, new: leaf.index_copy_(0, row_ids, new.to(leaf.dtype)),
                      state["dec"], tiled)
            if "anc" in state["dec"]:
                # the lineage Transformer: re-arm each fresh group's ancestry
                # to the local identity (the tiled rows copied beam 0's)
                anc = state["dec"]["anc"]
                anc.index_copy_(0, row_ids, (row_ids % k).to(anc.dtype)[:, None]
                                .expand(-1, anc.shape[1]))
            # only beam 0 is live at step 0 (the K rows start as copies)
            scores0 = torch.where(arange_k == 0, 0.0, NEG_INF).to(torch.float32)
            state["last"].index_fill_(0, row_ids, sos)
            state["scores"].index_copy_(0, row_ids, scores0.repeat(ids.shape[0]))
            state["bfin"].index_fill_(0, row_ids, False)
            state["btoks"].index_fill_(0, row_ids, 0)
            state["gstep"].index_fill_(0, ids, 0)
        state["steps"].index_fill_(0, ids, 0)
        state["active"].index_fill_(0, ids, True)
        state["toks"].index_fill_(0, ids, 0)
        return state

    def step(self, params, state):
        """Advance every slot ``step_chunk`` tokens over the tick tree
        ``params`` -> the new state. The state it was given is left as it
        was, except where a leaf is returned unchanged."""
        cell = self._device_fns(params)["cell"]
        one = self._step_once if self.beam_size == 1 else self._step_once_beam
        for _ in range(self.step_chunk):
            state = one(cell, state)
        return state

    def _step_once(self, cell, st):
        """Every slot one greedy or sampled token."""
        l = self.spec.max_len
        active = st["active"]
        rows = torch.arange(active.shape[0], device=active.device)
        # dead rows free-run unmasked; only the bookkeeping is masked
        dec, logits = cell(st["dec"], st["last"], st)
        pos = st["steps"].clamp(max=l - 1).long()
        if self._sample:
            # each slot filters by its request's (temperature, top_k, top_p)
            # and adds its own stream's noise for this step
            filt = _row_sampling_filters(self._full_vocab(logits), st["stemp"],
                                         st["stopk"], st["stopp"])
            nxt = (filt + st["gumbel"][rows, pos]).argmax(dim=-1).to(torch.int32)
        elif self._shard is not None:
            from vcr_tpu_torch.parallel.mesh import sharded_argmax

            nxt = sharded_argmax(logits, self._shard).to(torch.int32)
        else:
            nxt = logits.argmax(dim=-1).to(torch.int32)
        toks = st["toks"].index_put((rows, pos),
                                    torch.where(active, nxt, st["toks"][rows, pos]))
        steps = st["steps"] + active.to(torch.int32)
        return dict(st, dec=dec, toks=toks, steps=steps,
                    active=active & (nxt != self.eos_id) & (steps < l),
                    last=torch.where(active, nxt, st["last"]))

    def _full_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits over the whole vocab: gathered over mp under a split."""
        if self._shard is None:
            return logits
        from vcr_tpu_torch.parallel.mesh import gather_vocab

        return gather_vocab(logits, self._shard)

    def _step_once_beam(self, cell, st):
        """One beam-search step of every slot's K rows (``decode.beam_search``'s
        body), then the harvest view (toks/steps: the best beam cut at its
        first eos) of the active slots. A slot finishes when all K beams
        emitted eos."""
        k, l, active = self.beam_size, self.spec.max_len, st["active"]
        g, dev = active.shape[0], active.device
        rows_idx = torch.arange(g * k, device=dev)
        dec, logits = cell(st["dec"], st["last"], st)
        logp = torch.log_softmax(self._full_vocab(logits).float(), dim=-1)
        vocab = torch.arange(logp.shape[-1], device=dev)
        eos_only = torch.where(vocab == self.eos_id, 0.0, NEG_INF)[None].to(torch.float32)
        cont = torch.where(st["bfin"][:, None], eos_only, logp)
        s1, i1 = _top_k(st["scores"][:, None] + cont, k)
        top_scores, top_idx = _top_k(s1.reshape(g, k * k), k)        # (G, K)
        beam_idx = torch.div(top_idx, k, rounding_mode="floor")
        word_idx = i1.reshape(g, k * k).gather(1, top_idx).to(torch.int32)
        flat_src = (torch.arange(g, device=dev)[:, None] * k + beam_idx).reshape(-1)
        if self._base == "transformer":
            # lineage: only the ancestry moves, never the caches
            dec = dict(dec, anc=dec["anc"][flat_src])
        elif self._base == "s2vt":
            dec = {name: x[flat_src] for name, x in dec.items()}
        else:
            # pk/eo are the video's, the same in a slot's K rows: only h moves
            dec = dict(dec, h=dec["h"][flat_src])
        btoks, bfin = st["btoks"][flat_src], st["bfin"][flat_src]
        words = word_idx.reshape(-1)
        btoks[rows_idx, st["gstep"].clamp(max=l - 1).long().repeat_interleave(k)] = words
        bfin = bfin | (words == self.eos_id)
        # dead slots: every bookkeeping leaf stays as it was
        act_r = active.repeat_interleave(k)
        btoks = torch.where(act_r[:, None], btoks, st["btoks"])
        bfin = torch.where(act_r, bfin, st["bfin"])
        gstep = st["gstep"] + active.to(torch.int32)
        b0 = btoks.reshape(g, k, l)[:, 0]
        iseos = b0 == self.eos_id
        hsteps = torch.where(iseos.any(dim=1), iseos.to(torch.int32).argmax(dim=1) + 1,
                             gstep).to(torch.int32)
        return dict(st, dec=dec, btoks=btoks, bfin=bfin, gstep=gstep,
                    scores=torch.where(act_r, top_scores.reshape(-1), st["scores"]),
                    last=torch.where(act_r, words, st["last"]),
                    active=active & ~bfin.reshape(g, k).all(dim=1) & (gstep < l),
                    toks=torch.where(active[:, None], b0, st["toks"]),
                    steps=torch.where(active, hsteps, st["steps"]))

    # ----------------------------------------------- scheduler ops protocol
    #
    # Each public operation goes through _command: under a mesh rank 0 sends
    # it to the other ranks first; every rank then runs it in _run.

    def _command(self, name: str, *arrays):
        if self.mesh is None:
            return self._run(name, arrays)
        if self.mesh.rank != 0:
            raise RuntimeError("rank 0 drives a sharded pool; the other ranks run "
                               "serving_continuous.follow(channel)")
        with self.channel.lock:
            self.channel.send(name, arrays, self._pool_index)
            return self._run(name, arrays)

    def _run(self, name: str, arrays):
        with torch.inference_mode():
            if name == "admit":
                return self._encode_admit(*arrays)
            if name == "tick":
                with vocab_scope(self._shard):
                    self.state = self.step(self._step_params, self.state)
                return None
            if name == "poll":
                return self._gather(self.state["active"][:self._local].to(torch.int32)
                                    ).astype(bool)
            if name == "read":
                both = torch.cat([self.state["toks"][:self._local],
                                  self.state["steps"][:self._local, None]], dim=1)
                both = self._gather(both)
                return both[:, :-1], both[:, -1]
            if name == "release":
                ids = torch.as_tensor(arrays[0].astype(np.int64), device=self.device)
                local = ids - self._offset
                local = local[(local >= 0) & (local < self._local)]
                self.state["active"][local] = False
                return None
        raise ValueError(f"unknown pool command {name!r}")

    def _gather(self, local: torch.Tensor) -> np.ndarray:
        """This process's rows -> every slot's, in slot order (over dp, on
        the host)."""
        local = local.cpu().numpy()
        return local if self.channel is None else self.channel.gather_rows(local)

    def _request_opts(self, opts, a: int):
        """Each chunk row's sampling filters (temp, top_k, top_p), (A,) each,
        from its request's opts and the pool's defaults."""
        t0, k0, p0 = self._row_defaults
        temp = np.full((a,), t0, np.float32)
        topk = np.full((a,), k0, np.int32)
        topp = np.full((a,), p0, np.float32)
        # a request that carries opts starts from the pool's sampling
        # config, or neutral (T=1, no top_k/top_p) when the pool is greedy
        # by default: not from the argmax trick (1, 1, 0), which would keep
        # ?temperature=5 greedy
        bt, bk, bp = ((self.sample_temperature, self.sample_top_k, self.sample_top_p)
                      if self.sample_temperature > 0 else (1.0, 0, 0.0))
        for j, o in enumerate(opts or []):
            if not o:
                continue
            # sanitized here too: an exception on the scheduler thread ends
            # the daemon. top_k clamped into int32; a non-finite or
            # non-positive temperature (NaN fails every comparison) is greedy
            t = float(o.get("temperature", bt))
            topk[j] = min(max(int(o.get("top_k", bk)), 0), 2**31 - 1)
            p = float(o.get("top_p", bp))
            temp[j] = t if np.isfinite(t) else 0.0
            topp[j] = p if 0.0 <= p <= 1.0 else 0.0
            if not (temp[j] > 0):  # "temperature 0" = greedy
                temp[j], topk[j], topp[j] = 1.0, 1, 0.0
        return temp, topk, topp

    def encode_admit(self, feats: np.ndarray, ids: np.ndarray, valid: np.ndarray,
                     opts=None) -> None:
        row_opts = self._request_opts(opts, ids.shape[0]) if self._sample else ()
        valid = np.asarray(valid, bool)
        # only the valid rows go out (to the card, and under a mesh to the
        # other ranks); the chunk's other rows are zeros, as on the host
        self._command("admit", np.asarray(feats, np.float32)[valid],
                      np.asarray(ids, np.int32), valid, *row_opts)

    def _encode_admit(self, rows: np.ndarray, ids: np.ndarray, valid: np.ndarray,
                      *row_opts) -> None:
        """Encode the whole chunk (``rows``: its valid rows) and admit the
        rows of this process's slots; ``row_opts`` (temp, top_k, top_p)
        when the pool samples."""
        self._admit_count += 1
        admit = self._admit_count
        dev = self.device
        x = torch.zeros((ids.shape[0], *rows.shape[1:]), dtype=torch.float32, device=dev)
        x[torch.as_tensor(np.flatnonzero(valid), device=dev)] = torch.as_tensor(rows,
                                                                             device=dev)
        noise = (self._select_noise_for(admit, (*x.shape[:2], 2))
                 if self.spec.arch == "rationale" else None)
        new_dec = self.encode(self._step_params, x, noise)
        local = ids.astype(np.int64) - self._offset
        mine = valid & (local >= 0) & (local < self._local)
        ids_t = torch.as_tensor(local, dtype=torch.long, device=dev)
        valid_t = torch.as_tensor(mine, dtype=torch.bool, device=dev)
        if not self._sample:
            self.state = self.admit(self.state, new_dec, ids_t, valid_t)
            return
        row_noise = torch.stack([
            self._sample_noise_for(admit, j) if mine[j] else
            torch.zeros((self.spec.max_len, self.spec.padded_vocab_size), device=dev)
            for j in range(ids.shape[0])])
        opts_t = tuple(torch.as_tensor(v, device=dev) for v in row_opts)
        self.state = self.admit(self.state, new_dec, ids_t, valid_t, opts_t, row_noise)

    def tick(self) -> None:
        self._command("tick")

    def poll_active(self) -> np.ndarray:
        return self._command("poll")

    def read_tokens(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._command("read")

    def check_feat_shape(self, shape) -> Optional[str]:
        """None if a request of this feature shape is admissible, else the
        reason. The HTTP front end refuses other shapes with a 400 before
        they reach the scheduler thread."""
        spec = self.spec
        if spec.arch == "spatial":
            if (len(shape) == 4 and shape[0] == spec.num_frames
                    and shape[1] == spec.vid_feat_size
                    and shape[2] == shape[3] and shape[2] >= 1):
                return None
            return (f"expected ({spec.num_frames}, {spec.vid_feat_size}, K, K) spatial "
                    f"grid features, got {tuple(shape)}")
        if tuple(shape) == (spec.num_frames, spec.vid_feat_size):
            return None
        return (f"expected ({spec.num_frames}, {spec.vid_feat_size}) features, "
                f"got {tuple(shape)}")

    def release_slots(self, ids: np.ndarray) -> None:
        """Deactivate the slots of cancelled requests: their rows become dead
        weight until the next admission instead of decoding to max_len."""
        self._command("release", np.asarray(ids, np.int32))

    def follow(self) -> None:
        """Ranks > 0: run rank 0's commands until it stops the followers
        (:func:`follow`; it serves every sharded pool of this process)."""
        follow(self.channel)

    def stop(self) -> None:
        """Rank 0: end the followers' :meth:`follow` (:func:`stop_followers`).
        Nothing without a mesh."""
        if self.channel is not None:
            stop_followers(self.channel)

    # ------------------------------------------------------------ host loop

    def caption_stream(self, requests: Iterable[Tuple[object, np.ndarray]],
                       poll_cancelled=None) -> Iterator[Tuple[object, np.ndarray]]:
        """Drive the pool over a request stream (:func:`run_slot_scheduler`:
        poll markers, completion order, cancellation). ``self.stats``
        accumulates across calls; useful_steps / slot_steps is the share of
        slot-steps that produced a kept token."""
        return run_slot_scheduler(self, requests, poll_cancelled=poll_cancelled)

    def caption_all(self, feats_by_key: Dict[object, np.ndarray]
                    ) -> Dict[object, np.ndarray]:
        """Run a whole dict of requests to completion."""
        return dict(self.caption_stream(feats_by_key.items()))
