"""Deployable serving artifacts: the whole-batch serving graph, exported.

The counterpart of ``vcr_tpu/export_serving.py``. An artifact is a
directory that a serving host loads and runs with none of the package's
model code:

    serving_fn.pt2   torch.export program of
                     caption(weight_leaves, frames, noise) -> tokens
    weights.npz      the weight leaves in call order (keys w00000, w00001,
                     ...; bfloat16 stored as float32, cast back per meta)
    meta.json        spec fields, eos_id, decode mode, input signature,
                     leaf dtypes, the draw plan, the kernel sources' digests,
                     torch version

The leaves are the parameter tree flattened in sorted-key order, as
``jax.tree_util`` flattens a dict, so a port artifact's ``weights.npz``
holds the JAX package's leaves for the same parameters. With a fused
featurizer the tree is (captioner weights, featurizer weights), the
backbone in the program: raw frames in, tokens out; a Darknet's cfg
structure is fixed at export, its ``None`` layers hold no leaf.

The program is traced by ``torch.export`` from ``serving.make_caption_fn``
on the device the caller names, and moved to the serving device at load.
It holds kernels B1-B4 as the ``vcr_tpu_torch`` custom ops
(``ops/library.py``): on the card they launch the hand-written kernels, on
the CPU they run the plain versions. The models' bf16 products are held as
the library's device-neutral product ops, so the form each device takes is
chosen when the program runs. A serving host therefore imports torch, numpy
and ``vcr_tpu_torch.ops.library``; the kernels are built from the package's
sources at first use, and an artifact records the digests of the sources it
was exported against, which the loader checks.

Random draws (RationaleNet's frame selection, the sampling noise) cannot be
traced into the program with a symbolic batch. They are inputs instead, and
``meta["draws"]`` records their plan (``serving.draw_plan``) and seed; the
loader draws them on its device from ``torch.Generator(device)`` seeded
with that seed, in the order the live ``serving.build_captioner`` draws, so
the artifact's tokens are the live call's on the same device.

A float32 convolution (SpatialNet's trunk in float32) runs with cuDNN's
TF32 off in the live call, by a scope that the program cannot hold; the
loader turns TF32 off around the call where ``meta["float32_conv"]`` says
the program holds one.

The batch dimension is symbolic (``torch.export.Dim("b")``) unless
``batch_size`` pins it.

A data-parallel artifact (``dp > 1``, the JAX package's multi-chip one:
the batch split dp ways, the weights replicated) holds the dp=1 program;
its meta says dp. The loader places the program and the weights on each of
dp devices once, and a call runs slice i of the rows on device i, one
process for all of them. Its draws are drawn for the whole batch and
sliced by rows, so its tokens are the dp=1 artifact's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
GRAPH_FILE = "serving_fn.pt2"
WEIGHTS_FILE = "weights.npz"
META_FILE = "meta.json"
RUNTIME = "torch"

# dtypes np.savez cannot round-trip; stored as float32 and cast back on load
_NONPORTABLE_DTYPES = ("bfloat16",)
# the CUDA source of each kernel op (ops/csrc/<name>.cu)
_OP_SOURCES = {"gru_recurrence": "gru_seq", "gru_recurrence_bt": "gru_seq",
               "gru_recurrence_dma": "gru_seq_dma", "lstm_recurrence": "lstm_seq",
               "beam_pick": "beam_pick"}


def default_input_shape(spec, featurizer: str = "none",
                        image_size: int = 224) -> Tuple[int, ...]:
    """Per-item input shape (without the batch) the serving graph expects:
    precomputed features, (N, V), or SpatialNet's grid (N, F, K, K); raw
    normalized frames (N, 3, S, S) when a backbone is fused in."""
    if featurizer != "none":
        return (spec.num_frames, 3, image_size, image_size)
    if spec.arch == "spatial":
        return (spec.num_frames, spec.vid_feat_size, spec.grid_size, spec.grid_size)
    return (spec.num_frames, spec.vid_feat_size)


# ------------------------------------------------------------- leaf trees

def flatten_tree(tree) -> Tuple[list, list]:
    """A nest of dicts, tuples and lists -> (leaves, paths), depth first, a
    dict in sorted-key order and a sequence in its order, ``None`` a node
    without leaves: ``jax.tree_util``'s order. A path is the tuple of keys
    and indices that leads to its leaf."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, x in enumerate(node):
                walk(x, path + (i,))
        elif node is not None:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def tree_skeleton(tree):
    """``tree``'s nest with each leaf replaced by True (``None`` stays):
    what :func:`fill_tree` rebuilds it from, without the weights."""
    if isinstance(tree, dict):
        return {k: tree_skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_skeleton(v) for v in tree)
    return None if tree is None else True


def fill_tree(skeleton, leaves):
    """The tree of ``skeleton`` with its leaves taken in
    :func:`flatten_tree`'s order from the list ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(skeleton)


def path_name(path) -> str:
    """A leaf path as one string, ``rnn1/w_ih`` or ``dec/c0/1``."""
    return "/".join(str(k) for k in path)


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``"float32"``, ``"bfloat16"``, ...)."""
    return str(dtype).removeprefix("torch.")


def _save_leaves(path: str, leaves, prefix: str = "w") -> None:
    """npz with zero-padded ordinal keys (sorted(files) is call order);
    bfloat16 stored as float32."""
    arrays = {}
    for i, leaf in enumerate(leaves):
        t = leaf.detach().cpu()
        if dtype_name(t.dtype) in _NONPORTABLE_DTYPES:
            t = t.float()
        arrays[f"{prefix}{i:05d}"] = t.numpy()
    np.savez(path, **arrays)


def _load_leaves(path: str, leaf_dtypes, device) -> list:
    """The leaves of an npz in key order, each cast to its dtype of
    ``leaf_dtypes`` and moved to ``device`` once."""
    with np.load(path) as w:
        keys = sorted(w.files)
        if len(keys) != len(leaf_dtypes):
            raise ValueError(f"{os.path.basename(path)} has {len(keys)} leaves, "
                             f"meta says {len(leaf_dtypes)}")
        return [torch.from_numpy(w[k]).to(device=device, dtype=getattr(torch, dt))
                for k, dt in zip(keys, leaf_dtypes)]


# --------------------------------------------------------- program facts

def _kernel_sources(programs) -> dict:
    """{source name: digest} of every CUDA source whose op the programs
    hold."""
    from vcr_tpu_torch.ops import _build

    names = set()
    for ep in programs:
        for node in ep.graph.nodes:
            target = str(node.target)
            for op, source in _OP_SOURCES.items():
                if target.startswith(f"vcr_tpu_torch.{op}."):
                    names.add(source)
    return {n: _build.source_digest(_build.CSRC / f"{n}.cu") for n in sorted(names)}


def _holds_float32_conv(programs) -> bool:
    """Whether a program holds an aten convolution on float32 operands."""
    for ep in programs:
        for node in ep.graph.nodes:
            if node.op == "call_function" and "conv" in str(node.target) \
                    and str(node.target).startswith("aten."):
                val = node.args[0].meta.get("val")
                if val is not None and val.dtype == torch.float32:
                    return True
    return False


def check_kernel_sources(meta: dict) -> None:
    """Raise where this package's kernel sources are not those the
    artifact was exported against."""
    from vcr_tpu_torch.ops import _build

    for name, digest in meta.get("kernel_sources", {}).items():
        have = _build.source_digest(_build.CSRC / f"{name}.cu")
        if have != digest:
            raise ValueError(
                f"the artifact was exported against ops/csrc/{name}.cu {digest}; this "
                f"package's source is {have}: re-export the artifact with this package")


def read_meta(artifact_dir: str, kind: str) -> dict:
    """meta.json of an artifact of this package of ``kind`` ("serving" or
    "continuous"); raises for the JAX package's artifacts (their meta names
    no torch runtime), another kind or format."""
    with open(os.path.join(artifact_dir, META_FILE)) as f:
        meta = json.load(f)
    if meta.get("runtime") != RUNTIME:
        raise ValueError(f"{artifact_dir} is not an artifact of this package "
                         f"(runtime {meta.get('runtime')!r}, want {RUNTIME!r}); the JAX "
                         "package (vcr_tpu) loads the artifacts it exports")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format_version="
                         f"{meta.get('format_version')} (this loader understands "
                         f"{FORMAT_VERSION})")
    got = meta.get("kind", "serving")
    if got != kind:
        loader = "export_continuous.load_continuous" if got == "continuous" \
            else "export_serving.load_artifact"
        raise ValueError(f"{artifact_dir} is a {got} artifact, not a {kind} one: "
                         f"load it with {loader}")
    return meta


def _drop_no_op_nodes(program) -> None:
    """Remove what tracing adds to the graph and the call need not run: the
    metadata assertions beside each ``.to(dtype)``, and each ``.to(dtype)``
    whose input already has that dtype (it returns its input) and that is
    not an output. The program computes the same tensors with fewer ops."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs and getattr(node.args[0].meta.get("val"), "dtype",
                                              None) == node.args[1]
              and all(user.op != "output" for user in node.users)):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def save_program(program, path: str) -> None:
    """Save an exported program lean: without its no-op nodes, and without
    its example inputs, which torch.export would store beside it (the
    weight leaves a second time)."""
    _drop_no_op_nodes(program)
    program.example_inputs = None
    torch.export.save(program, path)


def load_program(path: str, device: torch.device):
    """A saved program, moved to ``device``: its callable module. The op
    library is imported first: the program holds its ops."""
    from torch.export.passes import move_to_device_pass

    from vcr_tpu_torch.ops import library  # noqa: F401  (registers the ops)

    return move_to_device_pass(torch.export.load(path), device).module()


def tf32_scope(meta: dict, device: torch.device):
    """The scope a call of the artifact runs in: cuDNN's TF32 off on the
    card where the program holds a float32 convolution, as the live call's
    ``nn.layers._Conv2dF32`` holds it; else nothing."""
    from vcr_tpu_torch.nn.layers import cudnn_tf32_off

    if meta.get("float32_conv") and device.type == "cuda":
        return cudnn_tf32_off
    return contextlib.nullcontext


def draw_noise(plan, seed: int, batch: int, device) -> list:
    """The tensors of a draw plan (``serving.draw_plan``) for ``batch``
    rows, drawn in order from one generator on ``device`` seeded with
    ``seed``: the Gumbel draws of ``nn.gumbel.sample_gumbel``."""
    from vcr_tpu_torch.nn.gumbel import sample_gumbel

    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for entry in plan:
        shape = [batch if d == "b" else int(d) for d in entry["shape"]]
        if "steps" in entry:
            out.append(torch.stack([sample_gumbel(shape, gen, device)
                                    for _ in range(entry["steps"])]))
        else:
            out.append(sample_gumbel(shape, gen, device))
    return out


def _batch_axis(entry) -> int:
    """The batch axis of a draw plan entry's tensor: a stack of per-step
    draws puts the steps first."""
    return entry["shape"].index("b") + (1 if "steps" in entry else 0)


def noise_rows(plan, noise, start: int, stop: int, device=None) -> list:
    """Rows [start, stop) of the batch of each of a plan's drawn tensors
    (:func:`draw_noise`), on ``device`` (None: where they are)."""
    return [x.narrow(_batch_axis(e), start, stop - start).to(device or x.device)
            for e, x in zip(plan, noise)]


# ---------------------------------------------------------------- export

def _plan_dims(plan, batch_dim):
    """dynamic_shapes of the noise inputs: the batch axis of each."""
    return [{_batch_axis(e): batch_dim} if batch_dim is not None else None for e in plan]


class _Caption(torch.nn.Module):
    """caption(weight_leaves, frames, noise) over a flat leaf list; ``noise``
    the list of the draw plan's tensors. With a fused featurizer the leaves
    are those of (params, feat_params)."""

    def __init__(self, caption, skeleton, plan, fused: bool):
        super().__init__()
        self._caption, self._skeleton, self._fused = caption, skeleton, fused
        self._names = [entry["input"] for entry in plan]

    def forward(self, weight_leaves, frames, noise):
        tree = fill_tree(self._skeleton, weight_leaves)
        noise = dict(zip(self._names, noise))
        if self._fused:
            return self._caption(tree[0], frames, noise, feat_params=tree[1])
        return self._caption(tree, frames, noise)


def export_captioner(params, spec, out_dir: str,
                     featurizer: str = "none",
                     feat_params=None,
                     beam_size: int = 1,
                     eos_id: Optional[int] = None,
                     vocab=None,
                     rng: Optional[int] = None,
                     sample_temperature: float = 0.0,
                     sample_top_k: int = 0,
                     sample_top_p: float = 0.0,
                     batch_size: Optional[int] = None,
                     input_shape: Optional[Sequence[int]] = None,
                     image_size: int = 224,
                     dp: int = 1,
                     kv_cache: Optional[str] = None,
                     decode_weights: Optional[str] = None,
                     device=None) -> str:
    """Export the serving captioner for (params, spec) into ``out_dir``.

    The arguments are ``serving.build_captioner``'s, in the JAX package's
    order, then ``device``: where the program is traced (the card unless
    given; ``"cpu"`` traces it on the CPU). The program runs on either
    device. ``rng`` is the int seed of the call's draws (None: 0).
    ``batch_size=None`` exports a symbolic batch dimension; ``input_shape``
    overrides the per-item input shape (:func:`default_input_shape`). A fused
    ``featurizer`` ("vgg16", "resnet", "yolo" with its ``feat_params``, as
    ``serving.build_captioner`` takes them) puts the backbone in the program,
    which then takes frames (N, 3, ``image_size``, ``image_size``). ``dp >
    1`` exports a data-parallel artifact (see the module docstring): its
    loader needs dp devices, and a symbolic batch means any multiple of dp;
    a fixed ``batch_size`` that dp does not divide raises ValueError.
    Returns ``out_dir``."""
    from vcr_tpu_torch import decode, serving
    from vcr_tpu_torch.device import params_to, resolve_device
    from vcr_tpu_torch.models import base as model_base

    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if batch_size is not None and int(batch_size) % dp:
        raise ValueError(f"batch_size={batch_size} not divisible by dp={dp}")
    darknet, feat_params = serving.split_feat_params(featurizer, feat_params)
    device = resolve_device(device)
    eos_id = serving.resolve_eos_id(spec, eos_id, vocab)
    seed = 0 if rng is None else int(rng)
    caption = serving.make_caption_fn(spec, featurizer, beam_size, eos_id,
                                      sample_temperature, sample_top_k, sample_top_p,
                                      seed, kv_cache=kv_cache,
                                      decode_weights=decode_weights, darknet=darknet)
    plan = serving.draw_plan(spec, beam_size, sample_temperature)
    params = params_to(params, device)
    if model_base.check_serving_modes(kv_cache, decode_weights)[1] == "int8":
        # the tree build_captioner serves: quantized once, the codes leaves
        params = decode.augment_decode_weights(params, spec)
    fused = featurizer != "none"
    tree = (params, params_to(feat_params, device)) if fused else params
    leaves, paths = flatten_tree(tree)
    item_shape = (tuple(int(d) for d in input_shape) if input_shape is not None
                  else default_input_shape(spec, featurizer, image_size))
    # the program is the dp=1 program at one device's share of the batch
    example_b = 2 if batch_size is None else int(batch_size) // dp
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn((example_b, *item_shape), generator=gen).to(device)
    noise = draw_noise(plan, seed, example_b, device)
    b = torch.export.Dim("b") if batch_size is None else None
    dynamic = ([None] * len(leaves), {0: b} if b is not None else None,
               _plan_dims(plan, b))
    module = _Caption(caption, tree_skeleton(tree), plan, fused)
    try:
        with torch.no_grad():
            program = torch.export.export(module, (leaves, frames, noise),
                                          dynamic_shapes=dynamic)
    except Exception as e:
        if batch_size is None:
            raise RuntimeError(
                "symbolic-batch export failed for this decode path; retry with an "
                f"explicit batch_size (underlying error: {e})") from e
        raise

    os.makedirs(out_dir, exist_ok=True)
    save_program(program, os.path.join(out_dir, GRAPH_FILE))
    _save_leaves(os.path.join(out_dir, WEIGHTS_FILE), leaves)
    meta = {
        "format_version": FORMAT_VERSION,
        "runtime": RUNTIME,
        "kind": "serving",
        "spec": dataclasses.asdict(spec),
        "featurizer": featurizer,
        "image_size": int(image_size) if fused else None,
        "eos_id": int(eos_id),
        "beam_size": int(beam_size),
        "sample_temperature": float(sample_temperature),
        "sample_top_k": int(sample_top_k),
        "sample_top_p": float(sample_top_p),
        "kv_cache": kv_cache or "bf16",
        "decode_weights": decode_weights or "bf16",
        "input_item_shape": list(item_shape),
        "batch": "symbolic" if batch_size is None else int(batch_size),
        "num_weight_leaves": len(leaves),
        "leaf_dtypes": [dtype_name(t.dtype) for t in leaves],
        "leaf_paths": [path_name(p) for p in paths],
        "draws": {"seed": seed, "plan": plan},
        "float32_conv": _holds_float32_conv([program]),
        "kernel_sources": _kernel_sources([program]),
        "dp": int(dp),
        "nr_devices": int(dp),
        "exported_on": device.type,
        "platforms": ["cpu", "cuda"],
        "torch_version": torch.__version__,
        "output": "tokens (B, max_len) int32",
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


# ------------------------------------------------------------------ load

class ServingArtifact:
    """A loaded artifact: ``caption(frames) -> tokens (B, max_len) int32``,
    a tensor on the artifact's (first) device. Only torch, numpy and the op
    library run: the program replays the exported graph. ``replicas``: the
    (module, leaves) of each of a dp artifact's devices after the first."""

    def __init__(self, module, leaves, meta, device: torch.device,
                 devices: Optional[Sequence[torch.device]] = None, replicas=()):
        self.meta = meta
        self.device = device
        self.devices = list(devices) if devices is not None else [device]
        self._replicas = [(module, leaves)] + list(replicas)

    @property
    def _module(self):
        """The program on the (first) device."""
        return self._replicas[0][0]

    @property
    def leaves(self):
        """The weight leaves in call order, on the (first) device."""
        return self._replicas[0][1]

    def noise(self, batch: int) -> list:
        """The draws of a call of ``batch`` rows (empty where the decode
        draws nothing)."""
        draws = self.meta["draws"]
        return draw_noise(draws["plan"], draws["seed"], batch, self.device)

    def caption(self, frames) -> torch.Tensor:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        want = self.meta["input_item_shape"]
        if list(frames.shape[1:]) != want:
            raise ValueError(
                f"frames shape {tuple(frames.shape)} does not match the artifact's "
                f"per-item signature {want}")
        b = self.meta["batch"]
        if b != "symbolic" and frames.shape[0] != b:
            raise ValueError(
                f"artifact was exported at fixed batch {b}, got {frames.shape[0]}")
        dp = len(self._replicas)
        if frames.shape[0] % dp:
            raise ValueError(f"a dp={dp} artifact needs batch % dp == 0, got "
                             f"{frames.shape[0]}")
        noise = self.noise(frames.shape[0])
        # slice i of the rows runs on device i; every slice is launched before
        # any result is read
        n = frames.shape[0] // dp
        outs = []
        for i, ((module, leaves), dev) in enumerate(zip(self._replicas, self.devices)):
            part = frames[i * n:(i + 1) * n].to(dev)
            with torch.no_grad(), tf32_scope(self.meta, dev)():
                outs.append(module(leaves, part, noise_rows(
                    self.meta["draws"]["plan"], noise, i * n, (i + 1) * n, dev)))
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    __call__ = caption


def load_artifact(artifact_dir: str, device=None, devices=None) -> ServingArtifact:
    """Load an artifact directory onto ``device`` (the card unless given;
    none raises). The program is moved there and the leaves copied there
    once. A dp artifact (``meta["dp"] > 1``) takes its first dp devices
    from ``devices`` (default: cards 0..dp-1), fewer raise ValueError; a
    device may repeat, and each distinct one gets the program and the
    weights once. A JAX artifact, a continuous one, or one exported against
    other kernel sources raises ValueError."""
    from vcr_tpu_torch.device import resolve_device

    meta = read_meta(artifact_dir, "serving")
    check_kernel_sources(meta)
    dp = int(meta.get("dp", 1))
    if devices is None:
        devices = ([device] if dp == 1 else
                   [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    devices = list(devices)
    if len(devices) < dp:
        raise ValueError(f"a dp={dp} artifact needs {dp} devices, got {len(devices)}")
    devices = [resolve_device(d) for d in devices[:dp]]
    placed = {}
    for dev in devices:
        if dev not in placed:
            placed[dev] = (load_program(os.path.join(artifact_dir, GRAPH_FILE), dev),
                           _load_leaves(os.path.join(artifact_dir, WEIGHTS_FILE),
                                        meta["leaf_dtypes"], dev))
    module, leaves = placed[devices[0]]
    return ServingArtifact(module, leaves, meta, devices[0], devices,
                           [placed[d] for d in devices[1:]])
