"""Collectives of the sharded trainer: the compressed cross-pod gradient
hop (int8 + error feedback) and the autograd-aware collectives of the
tensor-parallel / FSDP layers.

**int8-EF.** The JAX package's math, ported as it is: each pod quantizes
its local gradient leaf (with the residual of its last quantization
added back), the int8 codes travel over the ``pod`` group by
``all_gather`` beside one f32 scale a leaf, and every rank rebuilds the
mean ``Σ_p scale_p · q_p / npods`` in f32. The JAX package packs the
codes four to an int32 word because some XLA backends cannot collect s8;
gloo and NCCL both gather int8, so the port sends the same bytes as
int8. Where a leaf is sharded inside the pod (FSDP over ``data``, TP
over ``model``), its scale is the JAX one of the whole leaf: the shards'
maxima meet in one MAX all-reduce over the pod's ranks first.

**Autograd-aware collectives** (Megatron's, as ``torch.autograd``
functions over one of the mesh's groups; a group of one rank is skipped):

  * :func:`copy_to` — into a tensor-parallel region: forward identity,
    backward SUM all-reduce (each rank's partial input gradient);
  * :func:`reduce_from` — out of a row-parallel product: forward SUM
    all-reduce, backward identity;
  * :func:`gather_from` / :func:`split_to` — a model-sharded activation
    made whole for replicated work (backward: this rank's slice), and its
    adjoint (also the cut of a replicated param that each rank uses on
    its own heads only: the backward gathers the ranks' slices of its
    gradient, each rank's own);
  * :func:`fsdp_gather` — parameters gathered on use: forward all-gather
    over the FSDP axes, backward reduce-scatter (SUM) of the gradients
    (also a model-sharded activation made whole for work that each rank
    does on its own share, whose gradient is a partial sum on each);
  * :func:`mean_over` — the loss's mean over the batch axes.

All-gathers are ``dist.all_gather_into_tensor`` into one buffer, and a
reduce-scatter is a SUM ``all_reduce`` of which each rank keeps its
slice, on every backend: gloo (on CPU tensors, and for ranks that share
one card, which NCCL refuses) and NCCL run both, so one composition
serves them all with the same bits. Every call packs its tensors into
one buffer: one collective a call. gloo runs a collective of CUDA
tensors on a host copy that the port makes (:func:`on_host`; an
all-reduce copies the result back in place, :func:`all_reduce_`), freed
after the call: gloo's own staging would keep pinned buffers the size of
the largest call cached, tens of GB a rank for a dbrx-132b layer's 9 GB
FSDP gather. (A gather into a list would cost another copy of the whole
output.)
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.models.stack import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# int8 quantizer with a per-leaf scale (the JAX package's, bit for bit)
# ---------------------------------------------------------------------------


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, or 1 where amax is 0. The divisor is a tensor: CUDA
    torch turns division by a Python scalar into a reciprocal multiply,
    which can differ from the CPU's (and XLA's) quotient in the last
    bit."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any float) -> (int8 codes, f32 scale). scale = amax / 127."""
    xf = x.float()
    scale = _scale_of(torch.amax(torch.abs(xf)))
    return _codes(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_quantize_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantize one leaf: (codes, scale, new_err) with
    new_err = (g + err) - deq(codes)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def zeros_error_state(grads: Any, npods: int) -> Any:
    """Per-pod f32 error-feedback accumulators: a leading pod axis of
    size ``npods`` on every leaf, the JAX package's layout (each rank
    holds its own pod's row, ``shard_tree`` under ``P("pod", ...)``)."""
    return tree_map(lambda g: torch.zeros((npods, *g.shape),
                                          dtype=torch.float32,
                                          device=g.device), grads)


def _others(mesh, axis: str) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != axis)


def crosspod_psum_int8(grads: Any, err: Any, mesh, axis: str = "pod"):
    """Compressed mean over ``axis``, called by every rank on its
    pod-local gradient shards ``grads`` and its pod's residuals ``err``
    (the same tree, local shapes). Returns (the mean gradient tree, the
    same on every pod; the new residual tree, this pod's). One MAX
    all-reduce of the leaves' maxima inside the pod (where the pod has
    more than one rank), one all-gather of every leaf's codes and one of
    the scales over ``axis``."""
    gs = tree_leaves(grads)
    es = tree_leaves(tree_map(lambda _, e: e, grads, err))
    corrected = [g.float() + e for g, e in zip(gs, es)]
    amax = torch.stack([torch.amax(torch.abs(c)) for c in corrected])
    inpod = _others(mesh, axis)
    if mesh.axes_size(inpod) > 1:
        all_reduce_(amax, mesh, inpod, op=dist.ReduceOp.MAX)
    scales = _scale_of(amax)
    codes = [_codes(c, scales[i]) for i, c in enumerate(corrected)]
    new_err = [c - dequantize_int8(q, scales[i])
               for i, (c, q) in enumerate(zip(corrected, codes))]
    npods = mesh.axes_size(axis)
    q_all = all_gather_flat(codes, mesh, axis)           # npods lists
    s_all = all_gather_flat([scales], mesh, axis)
    means = []
    for i, g in enumerate(gs):
        total = s_all[0][0][i] * q_all[0][i].float()
        for p in range(1, npods):
            total = total + s_all[p][0][i] * q_all[p][i].float()
        means.append((total / npods).to(g.dtype))
    it_g, it_e = iter(means), iter(new_err)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), err))


def crosspod_allreduce_int8(mesh, grads: Any, err: Any, *,
                            axis: str = "pod"):
    """:func:`crosspod_psum_int8` on boxed values: each rank passes its
    pod's row of the ``(npods, ...)`` encoding (a leading axis of size 1)
    and gets back the mean gradients and its new residuals, boxed the
    same way. Without ``axis`` in the mesh, returns its inputs."""
    if axis not in mesh.axis_names:
        return grads, err
    g, e = crosspod_psum_int8(tree_map(lambda a: a[0], grads),
                              tree_map(lambda a: a[0], err), mesh, axis)
    return tree_map(lambda a: a[None], g), tree_map(lambda a: a[None], e)


# ---------------------------------------------------------------------------
# Packed collectives (no autograd)
# ---------------------------------------------------------------------------


def on_host(mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor a collective of ``mesh`` runs on for ``x``: a host copy
    where the backend is gloo and ``x`` lies on the card, else ``x``."""
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def all_reduce_(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> None:
    """``x`` reduced with ``op`` over the group of ``axes``, in place."""
    buf = on_host(mesh, x)
    dist.all_reduce(buf, op=op, group=mesh.group(axes))
    if buf is not x:
        x.copy_(buf)


def all_gather_flat(xs: Sequence[torch.Tensor], mesh, axes) -> list:
    """Every rank's ``xs`` (one dtype) over the group of ``axes``, in
    group-rank order: a list (one entry a rank) of lists shaped like
    ``xs``. One ``all_gather`` of the packed tensors."""
    n = mesh.axes_size(axes)
    flat = torch.cat([x.reshape(-1) for x in xs])
    if n == 1:
        bufs = [flat]
    else:
        src = on_host(mesh, flat)
        out = src.new_empty(n * src.numel())
        dist.all_gather_into_tensor(out, src, group=mesh.group(axes))
        bufs = out.to(flat.device).view(n, -1).unbind(0)
    out = []
    for buf in bufs:
        parts, off = [], 0
        for x in xs:
            parts.append(buf[off:off + x.numel()].view(x.shape))
            off += x.numel()
        out.append(parts)
    return out


def all_reduce_flat(xs: Sequence[torch.Tensor], mesh, axes) -> list:
    """The SUM over the group of ``axes`` of each tensor of ``xs`` (one
    dtype), as new tensors: one ``all_reduce`` of the packed tensors."""
    if mesh.axes_size(axes) == 1:
        return [x.clone() for x in xs]
    flat = torch.cat([x.reshape(-1) for x in xs])
    all_reduce_(flat, mesh, axes)
    out, off = [], 0
    for x in xs:
        out.append(flat[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return out


def _gather_cat(xs, dims, mesh, axes) -> list:
    parts = all_gather_flat(xs, mesh, axes)
    return [torch.cat([p[i] for p in parts], dim=d)
            for i, d in enumerate(dims)]


def _slices(xs, dims, mesh, axes) -> list:
    n, r = mesh.axes_size(axes), mesh.axes_coord(axes)
    return [x.narrow(d, r * (x.shape[d] // n), x.shape[d] // n)
            for x, d in zip(xs, dims)]


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_flat([g], ctx.mesh, ctx.axes)[0], None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_flat([x], mesh, axes)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather ``xs`` along ``dims``; the backward pass either slices
    each gradient (the work after it is replicated, so every rank holds
    the whole gradient) or reduce-scatters it (each rank's gradient is a
    partial sum: FSDP)."""

    @staticmethod
    def forward(ctx, dims, mesh, axes, reduce, *xs):
        ctx.dims, ctx.mesh, ctx.axes, ctx.reduce = dims, mesh, axes, reduce
        return tuple(_gather_cat(xs, dims, mesh, axes))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        if ctx.reduce:
            gs = all_reduce_flat(gs, ctx.mesh, ctx.axes)
        return (None, None, None, None,
                *_slices(gs, ctx.dims, ctx.mesh, ctx.axes))


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _slices([x], [dim], mesh, axes)[0].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_cat([g], [ctx.dim], ctx.mesh, ctx.axes)[0], None, \
            None, None


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Forward identity; backward SUM all-reduce over ``axes``."""
    return x if mesh.axes_size(axes) == 1 else _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Forward SUM all-reduce over ``axes``; backward identity."""
    return x if mesh.axes_size(axes) == 1 else _ReduceFrom.apply(x, mesh,
                                                                 axes)


def gather_from(xs: Sequence[torch.Tensor], dim: int, mesh, axes) -> list:
    """Each of ``xs`` gathered along ``dim`` over ``axes`` (one
    all-gather); backward: this rank's slice of each gradient."""
    if mesh.axes_size(axes) == 1:
        return list(xs)
    dims = tuple(dim % x.dim() for x in xs)
    return list(_Gather.apply(dims, mesh, axes, False, *xs))


def split_to(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``; backward all-gathers the
    gradient."""
    if mesh.axes_size(axes) == 1:
        return x
    return _SplitTo.apply(x, dim % x.dim(), mesh, axes)


def fsdp_gather(xs: Sequence[torch.Tensor], dims: Sequence[int], mesh,
                axes) -> list:
    """Parameter shards gathered along their ``dims`` over ``axes`` (one
    all-gather); backward: the gradients reduce-scattered (one SUM
    all-reduce, each rank keeping its slice)."""
    if mesh.axes_size(axes) == 1:
        return list(xs)
    return list(_Gather.apply(tuple(dims), mesh, axes, True, *xs))


def max_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``, as a new
    tensor (no gradient)."""
    out = x.detach().clone()
    if mesh.axes_size(axes) > 1:
        all_reduce_(out, mesh, axes, op=dist.ReduceOp.MAX)
    return out


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axes`` (each rank's value
    weighted alike); backward: each rank's gradient divided by their
    number."""
    return reduce_from(x / mesh.axes_size(axes), mesh, axes)


# ---------------------------------------------------------------------------
# Softmax partial combines over a named axis (T1 at pod scale) —
# re-exported here so the distributed story lives in one package.
# ---------------------------------------------------------------------------

from repro_torch.core.softmax import (  # noqa: E402,F401
    combine_async_collective,
    combine_sync_collective,
)
