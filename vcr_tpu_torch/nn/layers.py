"""Core functional layers: the mixed-precision products, dense, embedding,
dropout, the Transformer's Norm, SpatialNet's conv and BatchNorm, and the
backbones' strided conv and max pools.

Every product runs through :func:`vdot` (or, batched, :func:`bmm_f32`):
operands rounded to the compute dtype, float32 accumulation and a float32
result. Parameters are stored float32.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vcr_tpu_torch.nn import init as vinit

# The mp split of the vocabulary that the vocab products run under
# (``parallel.mesh.VocabShard``; None: unsplit). The split's collectives
# live in ``parallel.mesh``, imported only where a split is set, so that a
# serving host, which never sets one, imports none of it.
_VOCAB_SHARD: contextvars.ContextVar = contextvars.ContextVar("vocab_shard",
                                                             default=None)


def current_vocab_shard():
    return _VOCAB_SHARD.get()


@contextlib.contextmanager
def vocab_scope(shard):
    """Run the models' vocab products under ``shard`` (None: unsplit)."""
    token = _VOCAB_SHARD.set(shard)
    try:
        yield
    finally:
        _VOCAB_SHARD.reset(token)


# The dp layout (``parallel.mesh.Mesh``) whose global batch BatchNorm's train
# statistics run over (None: this process's batch).
_DP_MESH: contextvars.ContextVar = contextvars.ContextVar("dp_mesh", default=None)


@contextlib.contextmanager
def dp_scope(mesh):
    """Run BatchNorm's train statistics over ``mesh``'s dp (None: local)."""
    token = _DP_MESH.set(mesh if mesh is not None and mesh.dp > 1 else None)
    try:
        yield
    finally:
        _DP_MESH.reset(token)


class _MatmulF32(torch.autograd.Function):
    """x (M, K) @ w (K, N) on the card, both operands in the compute dtype,
    with a float32 result from cuBLAS.

    ``torch.mm(..., out_dtype=)`` has no derivative of its own. The backward
    is the CPU branch's autograd, which is also what JAX gives for
    ``vcr_tpu.nn.layers.vdot``: dX = g @ w^T and dW = x^T @ g as float32
    products of the float32 gradient and the rounded operands, each rounded
    to its operand's dtype. These float32 products follow torch's matmul
    precision: full float32 unless the caller turns TF32 on.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = (g @ w.float().t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        gw = (x.float().t() @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def vdot(x: torch.Tensor, w: torch.Tensor,
         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w (K, N) with operands cast to ``compute_dtype``, float32
    accumulation and a float32 result. Differentiable on both devices.

    A plain bf16 ``matmul`` would round its result to bf16 a second time. On
    the card the product asks cuBLAS for a float32 output
    (:class:`_MatmulF32`); on the CPU, which has no such kernel, the
    bf16-rounded operands are up-cast to float32, which gives the same exact
    products. While ``torch.export`` traces, the product is the op
    ``vcr_tpu_torch::mm_f32`` (``ops/library.py``), whose implementation on
    each device is that device's form here, so a program exported on one
    device runs the other's form on the other.
    """
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    if compute_dtype == torch.float32:
        return xc @ wc
    if torch.compiler.is_exporting():
        # the device is chosen when the exported program runs, not here
        return torch.ops.vcr_tpu_torch.mm_f32(xc, wc)
    if xc.is_cuda:
        y = _MatmulF32.apply(xc.reshape(-1, xc.shape[-1]), wc)
        return y.reshape(*xc.shape[:-1], wc.shape[-1])
    return xc.float() @ wc.float()


class _BmmF32(torch.autograd.Function):
    """a (G, M, K) @ b (G, K, N) on the card, both operands in the compute
    dtype, with a float32 result from cuBLAS (``torch.bmm(...,
    out_dtype=)``, which has no derivative of its own). The backward is
    :class:`_MatmulF32`'s, batched: float32 products of the float32 gradient
    and the rounded operands, each rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) over matching leading dims, operands
    cast to ``compute_dtype``, float32 accumulation and a float32 result:
    the JAX package's ``einsum(..., preferred_element_type=float32)``.

    A bf16 ``torch.matmul`` would round its result to bf16. On the card the
    product asks cuBLAS for a float32 output (:class:`_BmmF32`); on the
    CPU the bf16-rounded operands are up-cast to float32, which gives the
    same exact products, as :func:`vdot` does (and, as there, an exported
    program holds the op ``vcr_tpu_torch::bmm_f32``)."""
    ac, bc = a.to(compute_dtype), b.to(compute_dtype)
    if compute_dtype == torch.float32:
        return ac @ bc
    if torch.compiler.is_exporting():
        return torch.ops.vcr_tpu_torch.bmm_f32(ac, bc)
    if not ac.is_cuda:
        return ac.float() @ bc.float()
    lead = ac.shape[:-2]
    y = _BmmF32.apply(ac.reshape(-1, *ac.shape[-2:]), bc.reshape(-1, *bc.shape[-2:]))
    return y.reshape(*lead, *y.shape[-2:])


# ---------------- dense ----------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               use_bias: bool = True) -> dict:
    return vinit.dense_init(gen, in_dim, out_dim, use_bias)


def dense(params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ w + b. Under a vocab split (``parallel.mesh.vocab_scope``) a
    column-split vocab projection gives this rank's columns, and the
    gradient of ``x`` is summed over the ranks of the split."""
    shard = current_vocab_shard()
    if shard is not None and id(params["w"]) in shard.col_ids:
        from vcr_tpu_torch.parallel import mesh

        x = mesh.copy_to_mp(x, shard)
    y = vdot(x, params["w"], compute_dtype)
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------- embedding ----------------

def embedding_init(vectors, padded_size: Optional[int] = None) -> dict:
    """GloVe-initialised embedding table, optionally zero-padded on the vocab
    axis to ``padded_size``."""
    table = torch.as_tensor(vectors, dtype=torch.float32)
    if padded_size is not None and padded_size > table.shape[0]:
        pad = torch.zeros((padded_size - table.shape[0], table.shape[1]),
                          dtype=torch.float32)
        table = torch.cat([table, pad], dim=0)
    return {"table": table}


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``ids`` of the table; under a vocab split, of the row-split
    table, summed over the ranks of the split."""
    shard = current_vocab_shard()
    if shard is not None and id(params["table"]) in shard.row_ids:
        from vcr_tpu_torch.parallel import mesh

        return mesh.embed_rows(params["table"], ids, shard)
    return params["table"][ids]


def mask_vocab_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Force padded vocab columns to -1e9 so they never win argmax. Under a
    vocab split the logits are this rank's columns."""
    shard = current_vocab_shard()
    if shard is not None:
        from vcr_tpu_torch.parallel import mesh

        return mesh.mask_pad_columns(logits, vocab_size, shard)
    if logits.shape[-1] == vocab_size:
        return logits
    invalid = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    return logits.masked_fill(invalid, -1e9)


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy tokens (..., ) int32 of vocab logits; under a vocab split,
    of this rank's columns and the other ranks' (no logits are gathered)."""
    shard = current_vocab_shard()
    if shard is not None:
        from vcr_tpu_torch.parallel import mesh

        return mesh.sharded_argmax(logits, shard).to(torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


# ---------------- dropout ----------------

def keep_mask(shape, rate: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A bool dropout mask of ``shape``: True keeps, with probability
    1 - ``rate``, drawn from ``generator``, which lives on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def apply_keep_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout through a drawn mask: kept values scaled by
    1/(1-p), the rest zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) at train time). The mask is drawn
    from ``generator``, which must live on ``x``'s device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout at train time needs an explicit generator")
    return apply_keep_mask(x, keep_mask(x.shape, rate, generator, x.device), rate)


# ---------------- the reference Transformer's Norm ----------------

def norm_init(dim: int) -> dict:
    return {"alpha": torch.ones((dim,)), "bias": torch.zeros((dim,))}


def torch_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference Transformer's hand-rolled Norm: alpha * (x - mean) /
    (std + eps) + bias, with the *unbiased* std and eps added to the std,
    not to the variance. The statistics are float32 whatever ``x``'s dtype,
    and the result is cast back to it, so a bf16 residual stream stays
    bf16."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
    out = params["alpha"] * (x32 - mean) / (var.sqrt() + eps) + params["bias"]
    return out.to(x.dtype)


# ---------------- conv2d (NCHW, torch layout) + batchnorm ----------------

# BatchNorm2d's defaults, the only values SpatialNet uses
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, ksize: int) -> dict:
    """Torch Conv2d layout (O, I, kH, kW) and a bias; xavier fans follow
    torch: fan_in = I*kH*kW, fan_out = O*kH*kW."""
    return {"w": vinit.xavier_normal(gen, (out_ch, in_ch, ksize, ksize),
                                     in_ch * ksize * ksize, out_ch * ksize * ksize),
            "b": vinit.const_bias(out_ch)}


def _same(w: torch.Tensor) -> Tuple[int, int]:
    """SAME padding of a stride-1 conv with an odd kernel."""
    return w.shape[2] // 2, w.shape[3] // 2


@contextlib.contextmanager
def cudnn_tf32_off():
    """cuDNN's TF32 off for the scope; its other flags stay the caller's
    (``torch.backends.cudnn.flags`` would reset them to its defaults)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _Conv2dF32(torch.autograd.Function):
    """A float32 SAME conv whose forward and backward both run with cuDNN's
    TF32 off, so a float32 conv is float32 whatever the caller's flags are
    (``torch.backends.cudnn.allow_tf32`` defaults to True, and autograd runs
    the backward outside any scope of the forward)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        with cudnn_tf32_off():
            return F.conv2d(x, w, padding=_same(w))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        with cudnn_tf32_off():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], list(_same(w)), [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw


def conv2d(params, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (B, C, H, W) NCHW, weights (O, I, kH, kW), stride 1, SAME padding
    -> (B, O, H, W) float32.

    As in the JAX package, the convolution's result is in the compute dtype
    (a bf16 conv's output is rounded to bf16), then up-cast to float32 and
    the bias added. On the card a bf16 conv is one cuDNN call on bf16
    operands (float32 accumulation, bf16 output), and a float32 conv is a
    cuDNN call with TF32 off, whatever ``torch.backends.cudnn.allow_tf32``
    says; on the CPU both operands are rounded to the compute dtype,
    convolved in float32 and the result rounded to the compute dtype (an
    exported program holds the bf16 conv as the op
    ``vcr_tpu_torch::conv2d_same``, which picks its form when it runs).
    Autograd gives JAX's gradient on both: the output's cotangent rounded
    to the compute dtype, each operand's gradient rounded to its dtype."""
    xc, wc = x.to(compute_dtype), params["w"].to(compute_dtype)
    if compute_dtype == torch.float32:
        y = _Conv2dF32.apply(xc, wc)
    elif torch.compiler.is_exporting():
        y = torch.ops.vcr_tpu_torch.conv2d_same(xc, wc)
    elif xc.is_cuda:
        y = F.conv2d(xc, wc, padding=_same(wc))
    else:
        y = F.conv2d(xc.float(), wc.float(), padding=_same(wc)).to(compute_dtype)
    return y.float() + params["b"][None, :, None, None]


def batchnorm_init(ch: int) -> dict:
    return {"scale": torch.ones((ch,)), "bias": torch.zeros((ch,)),
            "mean": torch.zeros((ch,)), "var": torch.ones((ch,))}


def batchnorm(params, x: torch.Tensor, train: bool, mesh=None) -> Tuple[torch.Tensor, dict]:
    """BatchNorm2d over NCHW -> (y, new params). The running statistics are
    returned, never updated in place: at train the batch's mean and biased
    variance normalize, and the new stats take the mean and the unbiased
    variance with momentum 0.1; at eval the stored stats normalize and the
    params come back unchanged. ``F.batch_norm`` would update its buffers in
    place, so a checkpointed forward's replay would apply the momentum
    twice.

    ``mesh`` (default: the :func:`dp_scope`'s): at train the statistics are
    the global batch's over its dp, as one process's over the whole batch:
    the sum of x over dp gives the mean, then the sum of squared deviations
    from it the variance (two passes, as ``jnp.mean`` and ``jnp.var``; not
    E[x^2] - E[x]^2, which loses digits in float32), each sum differentiable
    over dp (``parallel.mesh.sum_over_dp``). Every rank's batch has one
    shape, so the count is dp times this rank's."""
    mesh = _DP_MESH.get() if mesh is None else mesh
    if train and mesh is not None and mesh.dp > 1:
        from vcr_tpu_torch.parallel.mesh import sum_over_dp

        n = x.shape[0] * x.shape[2] * x.shape[3] * mesh.dp
        mean = sum_over_dp(x.sum(dim=(0, 2, 3)), mesh) / n
        var = sum_over_dp(((x - mean[None, :, None, None]) ** 2).sum(dim=(0, 2, 3)),
                          mesh) / n
    elif train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.shape[0] * x.shape[2] * x.shape[3]
    if train:
        new = dict(params)
        m = _BN_MOMENTUM
        new["mean"] = (1 - m) * params["mean"] + m * mean
        new["var"] = (1 - m) * params["var"] + m * (var * n / max(n - 1, 1))
    else:
        mean, var, new = params["mean"], params["var"], params
    inv = torch.rsqrt(var + _BN_EPS)
    y = (x - mean[None, :, None, None]) * (inv * params["scale"])[None, :, None, None]
    return y + params["bias"][None, :, None, None], new


# ---------------- the backbones' conv and pool (inference only) ----------------

def conv2d_f32(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (B, C, H, W) NCHW, w (O, I, kH, kW), ``stride`` and ``padding`` on
    both sides of both axes (torch's ``padding=``, the JAX package's explicit
    ``[(p, p), (p, p)]``) -> (B, O, H', W') float32, without a bias: the
    backbones' ``lax.conv_general_dilated(..., preferred_element_type=f32)``
    with both operands rounded to ``compute_dtype``.

    On the CPU it is a float32 conv of the rounded operands, whose result
    is kept unrounded, as JAX's. On the card a bf16 conv is one cuDNN call on
    bf16 operands with float32 accumulation, whose output cuDNN rounds to
    bf16 before it is up-cast: one rounding per layer more than JAX (the gap
    this gives the backbones' features is stated in ROADMAP §C). A float32
    conv runs with cuDNN's TF32 off. While ``torch.export`` traces, the bf16
    conv is the op ``vcr_tpu_torch::conv2d_f32out`` (``ops/library.py``),
    which picks its device's form when the program runs. Inference only:
    nothing differentiates the backbones."""
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    if compute_dtype == torch.float32:
        with cudnn_tf32_off():
            return F.conv2d(xc, wc, stride=stride, padding=padding)
    if torch.compiler.is_exporting():
        return torch.ops.vcr_tpu_torch.conv2d_f32out(xc, wc, [stride] * 2, [padding] * 2)
    if xc.is_cuda:
        return F.conv2d(xc, wc, stride=stride, padding=padding).float()
    return F.conv2d(xc.float(), wc.float(), stride=stride, padding=padding)


def max_pool2d_edge(x: torch.Tensor, size: int) -> torch.Tensor:
    """Darknet's stride-1 max pool: the map extended right and bottom by
    ``size - 1`` copies of its edge, then the max over every ``size`` x
    ``size`` window; the output keeps the input's size."""
    pad = size - 1
    return F.max_pool2d(F.pad(x, (0, pad, 0, pad), mode="replicate"), size, 1)
