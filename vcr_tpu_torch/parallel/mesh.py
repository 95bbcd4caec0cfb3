"""A (dp, mp) layout of the processes of one ``torch.distributed`` group, and
the vocab-parallel pieces of the captioners' training.

Counterpart of ``vcr_tpu/parallel/mesh.py``. Each process holds one device.
Whoever starts the processes initialises the process group
(``torch.distributed.init_process_group`` with a ``tcp://`` address, the
world size and the rank), as the JAX package's caller runs
``jax.distributed.initialize``; :func:`backend_for` names the backend
(``parallel/launch.py`` does all of it for the command line).

* **dp** (data parallel): each dp index reads its own rows of the global
  batch, and the gradients are averaged over dp, weighted by valid rows.
* **mp** (model parallel over the vocabulary): each captioner's vocab
  projection (``linear`` / ``pred_linear``: ``w`` (H, V) and ``b`` (V,)) is
  split by column over mp and the embedding ``table`` (V, E) by row; every
  other parameter is replicated. The logits stay split: the masked CE takes
  the max, the sum of exponentials and the target logit each as a sum or
  max over mp, the argmax compares each rank's best, and the full-vocab
  logits are never gathered in a step.

Ranks are laid out row-major, like ``mesh_utils.create_device_mesh``: rank
= dp_index * mp + mp_index. The ranks of one dp index form an mp group; the
ranks of one mp index form a dp group.

Serving (``serving_continuous.ContinuousCaptioner(mesh=...)``): dp index d
owns the slots :func:`slot_block` gives it, mp splits the vocab projection
and embedding as in training, and :func:`gather_vocab` gives the full
logits where a decode needs them (the beam's top-k, the sampling filters).
Rank 0 leads: it sends each operation of a pool as a command
(:func:`send_command`, :func:`recv_command`) before it runs it, and the
other ranks run what they receive; the pools' channel keeps its own state
(``serving_continuous.CommandChannel``).

Every collective here is an ``all_reduce`` (a gather is an all-reduce of a
zero buffer in which each rank fills its own block: each element is one
rank's value plus zeros, so it is exact) or a ``broadcast``: gloo carries
both for CUDA tensors, so two processes can share one card over gloo, and
NCCL carries them for one card per process. A command is sent as CPU
tensors, over a gloo group (:func:`host_group`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# parameter leaves whose parent module is a vocab-sized projection
VOCAB_PROJ_MODULES = ("linear", "pred_linear")


def backend_for(device, world_size: int) -> str:
    """"nccl" where every process of the group has a card of its own,
    else "gloo" (the CPU, or several processes on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def device_for(device, rank: int) -> torch.device:
    """The device of ``rank``: its own card where there are enough, else
    card ``rank % count``; the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


@dataclass
class Mesh:
    """The (dp, mp) layout of this process; ``dp_group`` joins the ranks of
    its mp index, ``mp_group`` the ranks of its dp index."""

    dp: int
    mp: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = field(default=None, repr=False)
    mp_group: Optional[object] = field(default=None, repr=False)

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp


def make_mesh(dp: int, mp: int = 1, device="cpu") -> Mesh:
    """The (dp, mp) layout of the initialised process group, which must hold
    dp * mp processes. Every rank creates every subgroup, in one order, as
    ``new_group`` requires."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {dp} x {mp} needs a process group of {dp * mp} processes: "
            "call torch.distributed.init_process_group (python -m "
            "vcr_tpu_torch.parallel.launch does) before training")
    world = dist.get_world_size()
    if dp * mp != world:
        raise ValueError(f"mesh {dp} x {mp} must span all {world} processes of the "
                         "group, one device each")
    rank = dist.get_rank()
    mesh = Mesh(dp, mp, rank, torch.device(device))
    for d in range(dp):
        group = dist.new_group([d * mp + m for m in range(mp)])
        if d == mesh.dp_index:
            mesh.mp_group = group
    for m in range(mp):
        group = dist.new_group([d * mp + m for d in range(dp)])
        if m == mesh.mp_index:
            mesh.dp_group = group
    return mesh


# --------------------------------------------------------- parameter layout

def param_spec(path: Sequence[str], leaf: torch.Tensor, vocab_size: int,
               mp: int = 1) -> Optional[str]:
    """The split of one parameter leaf: "col" (the last axis over mp),
    "row" (the first axis over mp) or None (replicated). A vocab that mp
    does not divide is replicated."""
    if mp <= 1 or vocab_size % mp:
        return None
    if len(path) >= 2 and path[-2] in VOCAB_PROJ_MODULES:
        if path[-1] == "w" and leaf.dim() == 2 and leaf.shape[-1] == vocab_size:
            return "col"
        if path[-1] == "b" and leaf.dim() == 1 and leaf.shape[0] == vocab_size:
            return "col"
    if path and path[-1] == "table" and leaf.dim() == 2 and leaf.shape[0] == vocab_size:
        return "row"
    return None


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, vocab_size: int, mp: int) -> dict:
    """The tree of :func:`param_spec` of every leaf of the full ``params``."""
    if mp > 1 and vocab_size % mp:
        warnings.warn(
            f"padded vocab {vocab_size} is not divisible by mesh_mp={mp}: the vocab "
            "projection and embedding fall back to replication (no mp sharding, no "
            "memory saving). Set vocab_pad_to to a multiple of mesh_mp to shard.",
            stacklevel=2)
    return _map(lambda path, leaf: param_spec(path, leaf, vocab_size, mp), params)


def spec_at(specs, path: Sequence[str]) -> Optional[str]:
    """The spec of the leaf at ``path``."""
    for k in path:
        specs = specs[k]
    return specs


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _axis(spec: Optional[str], leaf: torch.Tensor) -> Optional[int]:
    return None if spec is None else (leaf.dim() - 1 if spec == "col" else 0)


def shard_leaf(leaf: torch.Tensor, spec: Optional[str], mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full leaf (a new contiguous tensor)."""
    axis = _axis(spec, leaf)
    if axis is None:
        return leaf
    return leaf.chunk(mesh.mp, dim=axis)[mesh.mp_index].contiguous()


def shard_params(params, mesh: Mesh, specs) -> dict:
    """This rank's blocks of the full ``params``, by ``specs``
    (:func:`param_specs`)."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return shard_leaf(p, s, mesh)
    return walk(params, specs)


def gather_leaf(local: torch.Tensor, spec: Optional[str], mesh: Mesh) -> torch.Tensor:
    """The full leaf from every mp rank's block (collective over mp)."""
    axis = _axis(spec, local)
    if axis is None:
        return local
    return all_gather(local, mesh.mp, mesh.mp_index, mesh.mp_group, axis)


def unshard_params(params, mesh: Mesh, specs) -> dict:
    """The full parameters from every rank's blocks (collective over mp;
    every rank of a dp index calls it, in one order)."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return gather_leaf(p.detach(), s, mesh)
    return walk(params, specs)


def replicate(tree, mesh: Mesh, src: int = 0):
    """Broadcast every leaf of ``tree`` from rank ``src`` to all ranks, in
    place, so that every process starts from the same tensors."""
    with torch.no_grad():
        for leaf in _leaves(tree):
            dist.broadcast(leaf, src)
    return tree


# --------------------------------------------------------------- collectives

def all_gather(x: torch.Tensor, size: int, index: int, group, axis: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated along ``axis`` in
    rank order within ``group``, on every rank: an all-reduce of a zero
    buffer that holds this rank's block."""
    if size == 1:
        return x
    shape = list(x.shape)
    shape[axis] *= size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(axis, index * x.shape[axis], x.shape[axis]).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


def local_rows(x) -> np.ndarray:
    """This process's rows of a dp-sharded batch tensor, on the host. Each
    process holds only its own rows, so this is a copy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gather_global_rows(local: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """Each dp index's ``local`` rows (one shape on all) concatenated in dp
    order, returned on the host to every rank (collective over dp). Without
    a mesh, ``local`` itself."""
    if mesh is None or mesh.dp == 1:
        return np.asarray(local)
    x = torch.as_tensor(np.ascontiguousarray(local), device=mesh.device)
    return all_gather(x, mesh.dp, mesh.dp_index, mesh.dp_group).cpu().numpy()


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This dp index's contiguous block of the rows of a global batch's
    arrays (the global batch divides by dp); host lists are sliced the
    same way."""
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % mesh.dp:
            raise ValueError(f"batch field {k!r}: {n} rows do not divide by dp={mesh.dp}")
        b = n // mesh.dp
        out[k] = v[mesh.dp_index * b:(mesh.dp_index + 1) * b]
    return out


def global_any(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank if ``flag`` is true on any (an all-reduce MAX over
    the whole group); the flag itself without a mesh."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def weighted_mean(values: List[torch.Tensor], weight: torch.Tensor, mesh: Mesh
                  ) -> List[torch.Tensor]:
    """sum_r weight_r * values_r / sum_r weight_r over the dp group, for a
    list of tensors at once (one all-reduce of one flat buffer)."""
    if mesh.dp == 1:
        return values
    w = weight.float().reshape(1)
    flat = torch.cat([w] + [(v.float() * w).reshape(-1) for v in values])
    dist.all_reduce(flat, group=mesh.dp_group)
    total = flat[0].clamp(min=1.0)
    out, i = [], 1
    for v in values:
        out.append((flat[i:i + v.numel()] / total).reshape(v.shape).to(v.dtype))
        i += v.numel()
    return out


# ------------------------------------------------------- the vocab-parallel forms

@dataclass
class VocabShard:
    """The mp split of the vocabulary inside one step: this rank holds the
    logits and embedding rows [offset, offset + local) of ``padded``. The
    ids of the split parameter tensors tell :func:`nn.layers.dense` and
    :func:`nn.layers.embed` which products are the vocab's; the step sets
    it with :func:`nn.layers.vocab_scope`."""

    group: object
    size: int
    index: int
    padded: int
    col_ids: frozenset
    row_ids: frozenset

    @property
    def local(self) -> int:
        return self.padded // self.size

    @property
    def offset(self) -> int:
        return self.index * self.local


def vocab_shard_for(params, specs, mesh: Mesh, padded: int) -> Optional[VocabShard]:
    """The VocabShard of this rank's ``params`` (split by ``specs``), or
    None where nothing is split."""
    cols, rows = [], []

    def walk(p, s):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k])
        elif s == "col":
            cols.append(id(p))
        elif s == "row":
            rows.append(id(p))

    walk(params, specs)
    if not (cols or rows):
        return None
    return VocabShard(mesh.mp_group, mesh.mp, mesh.mp_index, padded, frozenset(cols),
                      frozenset(rows))


class _CopyToMp(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over mp (the input
    of a column-split product feeds every rank's block)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromMp(torch.autograd.Function):
    """Sum over mp forward (each rank contributes its rows of a lookup);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    return _CopyToMp.apply(x, shard.group)


def embed_rows(table: torch.Tensor, ids: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The embedding of ``ids`` from row-split tables: each rank looks up
    the ids in its rows, zeros elsewhere, and the sum over mp is the full
    lookup."""
    local = ids.long() - shard.offset
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)] * hit[..., None].to(table.dtype)
    return _ReduceFromMp.apply(rows, shard.group)


def mask_pad_columns(logits: torch.Tensor, vocab_size: int, shard: VocabShard
                     ) -> torch.Tensor:
    """Force this rank's padded columns (global index >= vocab_size) to
    -1e9."""
    if shard.offset + logits.shape[-1] <= vocab_size:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device) + shard.offset
    return logits.masked_fill(cols >= vocab_size, -1e9)


def sharded_argmax(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """The argmax over the full vocab of split logits, the first index on a
    tie as ``argmax`` gives: each rank's best value and global index,
    gathered over mp (no logits are gathered)."""
    idx = logits.argmax(dim=-1, keepdim=True)
    val = logits.gather(-1, idx).float()
    idx = idx + shard.offset
    vals = all_gather(val, shard.size, shard.index, shard.group, axis=-1)
    idxs = all_gather(idx, shard.size, shard.index, shard.group, axis=-1)
    first = (vals == vals.max(dim=-1, keepdim=True).values).int().argmax(dim=-1,
                                                                         keepdim=True)
    return idxs.gather(-1, first)[..., 0]


class _VocabParallelNll(torch.autograd.Function):
    """-log softmax(logits)[target] from split logits: the max, the sum of
    exponentials and the target's logit each reduced over mp. The gradient
    for this rank's columns is softmax - one_hot(target), times the
    incoming gradient."""

    @staticmethod
    def forward(ctx, logits, target, group, offset):
        logits = logits.float()
        m = logits.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - m[..., None]
        exp = shifted.exp()
        total = exp.sum(dim=-1)
        dist.all_reduce(total, group=group)
        local = target.long() - offset
        hit = (local >= 0) & (local < logits.shape[-1])
        local = local.clamp(0, logits.shape[-1] - 1)
        tgt = shifted.gather(-1, local[..., None])[..., 0] * hit
        dist.all_reduce(tgt, group=group)
        ctx.save_for_backward(exp / total[..., None], local, hit)
        return total.log() - tgt

    @staticmethod
    def backward(ctx, g):
        probs, local, hit = ctx.saved_tensors
        grad = probs.clone()
        grad.scatter_add_(-1, local[..., None], -hit[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, target: torch.Tensor, shard: VocabShard
                       ) -> torch.Tensor:
    """(..., V/mp) split logits and (...) targets -> (...) token NLL."""
    return _VocabParallelNll.apply(logits, target, shard.group, shard.offset)


def clip_sum_of_squares(grads: Sequence[torch.Tensor], split: Sequence[bool],
                        group) -> torch.Tensor:
    """The squared global norm of gradients of which ``split`` ones are
    mp-split: their sums of squares are summed over mp, and each replicated
    gradient, which every mp rank holds whole, counts once."""
    dev = grads[0].device
    rep = torch.zeros((), device=dev)
    shd = torch.zeros((), device=dev)
    for g, s in zip(grads, split):
        sq = g.float().pow(2).sum()
        if s:
            shd = shd + sq
        else:
            rep = rep + sq
    if any(split):
        dist.all_reduce(shd, group=group)
    return rep + shd


# ------------------------------------------------------------------ serving

def slot_block(mesh: Mesh, slots: int) -> Tuple[int, int]:
    """[start, stop) of the slots that this rank's dp index owns: block d
    of ``slots`` / dp contiguous slots. A count dp does not divide raises."""
    if slots % mesh.dp:
        raise ValueError(f"slots={slots} not divisible by dp={mesh.dp}")
    n = slots // mesh.dp
    return mesh.dp_index * n, (mesh.dp_index + 1) * n


def gather_vocab(logits: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    """(rows, V/mp) split logits -> the full (rows, V) on every rank of the
    split: an all-reduce of a zero buffer, so every value is exact."""
    return all_gather(logits.contiguous(), shard.size, shard.index, shard.group,
                      axis=-1)


class _SumOverGroup(torch.autograd.Function):
    """The sum over a group, forward; the backward sums the gradient over
    the group too, since every rank's result feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over_dp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every dp index's ``x`` (one shape on all), differentiable:
    the gradient of each rank's ``x`` is the sum of the gradients of every
    rank's result. With losses seeded by their share of the global batch
    (``train.step``), that is the gradient of one process's loss."""
    if mesh.dp == 1:
        return x
    return _SumOverGroup.apply(x, mesh.dp_group)


def sum_grads_over_dp(values: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Every dp index's gradients summed, for a list of tensors at once (one
    all-reduce of one flat buffer)."""
    if mesh.dp == 1:
        return values
    flat = torch.cat([v.float().reshape(-1) for v in values])
    dist.all_reduce(flat, group=mesh.dp_group)
    out, i = [], 0
    for v in values:
        out.append(flat[i:i + v.numel()].reshape(v.shape).to(v.dtype))
        i += v.numel()
    return out


def host_group():
    """A group of every rank that carries CPU tensors: the default group
    where it is gloo's (None), else a new gloo group. Collective: every rank
    calls it, in one order with its other groups."""
    return None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")


# A command: rank 0 broadcasts a header of int64s, then each array as a CPU
# tensor, over a group that carries CPU tensors (host_group). Header: [op,
# pool, number of arrays] and, per array, its dtype's index in _WIRE_DTYPES,
# its rank and its dims.
_WIRE_DTYPES = (np.float32, np.int32, np.bool_, np.int64, np.float64, np.uint8)
_MAX_ARRAYS, _MAX_DIMS = 8, 6
_HEADER = 3 + _MAX_ARRAYS * (2 + _MAX_DIMS)


def send_command(group, op: int, arrays: Sequence[np.ndarray] = (), pool: int = 0
                 ) -> None:
    """Rank 0: broadcast command ``op`` of pool ``pool`` with its host
    ``arrays`` to every rank of ``group`` (each rank > 0 takes it with
    :func:`recv_command`)."""
    if len(arrays) > _MAX_ARRAYS:
        raise ValueError(f"a command carries at most {_MAX_ARRAYS} arrays")
    header = torch.zeros(_HEADER, dtype=torch.int64)
    header[:3] = torch.tensor([op, pool, len(arrays)])
    arrays = [np.ascontiguousarray(a) for a in arrays]
    for i, a in enumerate(arrays):
        if a.ndim > _MAX_DIMS:
            raise ValueError(f"a command's array has at most {_MAX_DIMS} dims")
        kind = [np.dtype(t) for t in _WIRE_DTYPES].index(a.dtype)
        at = 3 + i * (2 + _MAX_DIMS)
        header[at:at + 2 + a.ndim] = torch.tensor([kind, a.ndim, *a.shape])
    dist.broadcast(header, 0, group=group)
    for a in arrays:
        if a.size:
            # bool travels as uint8, which every backend carries
            dist.broadcast(torch.from_numpy(a.view(np.uint8) if a.dtype == np.bool_
                                            else a), 0, group=group)


def recv_command(group) -> Tuple[int, int, List[np.ndarray]]:
    """Ranks > 0: the next command of rank 0 over ``group`` -> (op, pool,
    host arrays)."""
    header = torch.zeros(_HEADER, dtype=torch.int64)
    dist.broadcast(header, 0, group=group)
    h = header.tolist()
    arrays = []
    for i in range(h[2]):
        at = 3 + i * (2 + _MAX_DIMS)
        dtype = np.dtype(_WIRE_DTYPES[h[at]])
        shape = tuple(h[at + 2:at + 2 + h[at + 1]])
        a = np.zeros(shape, np.uint8 if dtype == np.bool_ else dtype)
        if a.size:
            dist.broadcast(torch.from_numpy(a), 0, group=group)
        arrays.append(a.view(np.bool_) if dtype == np.bool_ else a)
    return h[0], h[1], arrays
