"""GPipe pipeline parallelism over the ``pod`` axis (the JAX package's
``distributed/pipeline.py``).

The ``pod`` axis can carry pipeline stages instead of replicas: each pod
holds a contiguous slice of the layers, and activations flow from pod to
pod while microbatches fill the pipeline (GPipe: all forward, then all
backward; bubble fraction (P - 1) / (M + P - 1)).

:func:`pipeline_forward` runs the JAX schedule tick for tick: P + M - 1
ticks, each one stage compute and one boundary permute ``i -> (i + 1) mod
P``; stage 0 ingests microbatch t while t < M, a stage is live while
``stage <= t < M + stage`` (the stage runs on every tick, its output is
kept only while live, as JAX's ``where`` keeps it), and the last stage
banks microbatch ``t - (P - 1)``. Its backward replays the schedule in
reverse, each permute's transpose sending the cotangents ``i -> i - 1``.

The schedule is one ``torch.autograd.Function``: its forward runs the
ticks without autograd and saves each tick's stage input; its backward
recomputes the stage at each live tick with grad enabled and takes its
vector-Jacobian product. Every rank issues every permute, in forward and
in backward, in the same order whether or not its stage is live, so no
rank waits on a send its neighbour never makes. Only the last stage's
copy of the outputs receives a cotangent (JAX returns ``boxed[-1]``):
summing every rank's copy would count the loss P times, and dropping
them per rank would leave earlier stages out of the permute chain.

A permute is a ``send`` / ``recv`` pair over the axis's group (the
``recv`` is what :class:`~repro_torch.analysis.cost.CostCounter` counts
as a ``collective-permute``). gloo sends and receives CPU tensors only:
where a gloo group carries CUDA tensors (ranks sharing one card, which
NCCL refuses) the permute and the outputs' broadcast go through a host
copy, as the trainer's collectives do there
(:func:`~repro_torch.distributed.collectives.on_host`).

The trainer does not call the pipeline, as in the JAX package (whose
docstring names a ``RunConfig.pipeline`` flag its config does not
define).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as C
from repro_torch.models.stack import tree_leaves, tree_map


def split_stages(layers_params: Any, num_stages: int) -> Any:
    """Reshape stacked-L layer params (L, ...) -> (P, L/P, ...)."""
    def leaf(a):
        n = a.shape[0]
        assert n % num_stages == 0, (n, num_stages)
        return a.reshape(num_stages, n // num_stages, *a.shape[1:])

    return tree_map(leaf, layers_params)


def merge_stages(staged: Any) -> Any:
    """(P, L/P, ...) -> (L, ...)."""
    return tree_map(lambda a: a.reshape(a.shape[0] * a.shape[1],
                                        *a.shape[2:]), staged)


def pipeline_forward(mesh, stage_params: Any, x_microbatches: torch.Tensor,
                     stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     *, axis: str = "pod") -> torch.Tensor:
    """GPipe forward over ``axis`` of ``mesh``; every rank of the axis
    calls it. ``stage_params`` is this rank's stage, boxed as
    ``shard_tree`` of the :func:`split_stages` tree under ``P(axis)``
    gives it (a leading axis of size 1, stripped here as JAX's ``a[0]``
    strips it); ``x_microbatches`` (M, mb, ...) is the same on every
    rank; ``stage_fn(params, x) -> x`` keeps x's shape. Returns the last
    stage's (M, mb, ...) outputs on every rank. Differentiable with
    respect to ``stage_params`` and ``x_microbatches``: this rank's
    stage gets its own gradients, every rank the whole gradient of the
    microbatches."""
    params = tree_map(lambda a: a[0], stage_params)
    leaves = tree_leaves(params)
    return _Pipeline.apply(mesh, axis, stage_fn, params,
                           x_microbatches, *leaves)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, stage_fn, structure, xs, *leaves):
        n, stage = mesh.size(axis), mesh.coord(axis)
        m = xs.shape[0]
        params = _rebuild(structure, leaves)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        inputs = []
        for t in range(m + n - 1):
            if stage == 0 and t < m:
                buf = xs[t]
            live = stage <= t < m + stage
            inputs.append(buf)
            y = stage_fn(params, buf)
            out = y if live else buf
            if stage == n - 1 and live:
                outs[t - (n - 1)] = out
            buf = _permute(out, mesh, axis, 1)
        _broadcast(outs, mesh, axis, n - 1)
        ctx.mesh, ctx.axis, ctx.stage_fn = mesh, axis, stage_fn
        ctx.structure, ctx.inputs, ctx.m = structure, inputs, m
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        mesh, axis, m = ctx.mesh, ctx.axis, ctx.m
        n, stage = mesh.size(axis), mesh.coord(axis)
        leaves = ctx.saved_tensors
        g_leaves = [torch.zeros_like(p) for p in leaves]
        g_xs = torch.zeros((m, *ctx.inputs[0].shape),
                           dtype=ctx.inputs[0].dtype,
                           device=ctx.inputs[0].device)
        g_buf = torch.zeros_like(ctx.inputs[0])
        for t in reversed(range(m + n - 1)):
            # the permute's transpose: this tick's output cotangent comes
            # back from the next stage
            g = _permute(g_buf, mesh, axis, -1)
            live = stage <= t < m + stage
            if stage == n - 1 and live and g_outs is not None:
                g = g + g_outs[t - (n - 1)]
            if live:
                with torch.enable_grad():
                    x = ctx.inputs[t].detach().requires_grad_(True)
                    ps = [p.detach().requires_grad_(True) for p in leaves]
                    y = ctx.stage_fn(_rebuild(ctx.structure, ps), x)
                    grads = torch.autograd.grad(y, [x, *ps], g,
                                                allow_unused=True)
                g = grads[0]
                for i, gp in enumerate(grads[1:]):
                    if gp is not None:
                        g_leaves[i] = g_leaves[i] + gp
            if stage == 0 and t < m:
                g_xs[t] = g
                g = torch.zeros_like(g)
            g_buf = g
        # the microbatches are the same on every rank: each holds their
        # whole gradient, stage 0's
        _broadcast(g_xs, mesh, axis, 0)
        return (None, None, None, None, g_xs, *g_leaves)


def _rebuild(structure: Any, leaves) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def _permute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """The ring permute ``i -> (i + shift) mod n`` over ``axis``: this
    rank's ``x`` goes to the next rank along the ring, the previous
    rank's comes back (one ``send`` and one ``recv``)."""
    n = mesh.size(axis)
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    me = mesh.coord(axis)
    src = C.on_host(mesh, x.detach().contiguous())   # gloo: CPU tensors
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device)


def _broadcast(x: torch.Tensor, mesh, axis: str, root: int) -> None:
    """``x`` of the rank at coordinate ``root`` on ``axis``, in place on
    every rank of the axis."""
    if mesh.size(axis) > 1:
        group = mesh.group(axis)
        buf = C.on_host(mesh, x)
        dist.broadcast(buf, dist.get_global_rank(group, root), group=group)
        if buf is not x:
            x.copy_(buf)
