"""TrainState + the train step factory.

``make_train_step`` builds the function the trainer runs: the forward
loss (family-dispatched), its backward pass, optional microbatch gradient
accumulation, the AdamW update; a function of (state, batch) -> (state,
metrics) that returns a new state.

The step runs on the plan's non-kernel backend: every hand-written
kernel is a forward kernel only (as in the JAX package, whose kernels
have no VJP), so a ``"cuda"`` GEMM, prefill-attention or fused-FFN
backend is refused, and each kernel wrapper refuses inputs that require
a gradient. The JAX package's int8 error-feedback gradient hop across
pods needs the sharded training layer (TP / FSDP params over the mesh,
the int8-EF hop), which the port does not have yet (ROADMAP.md, slice
8b); it is refused rather than trained uncompressed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.config import RunConfig
from repro_torch.models.api import ModelApi
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map
from repro_torch.training import optimizer as opt

# the plan entries whose "cuda" backend launches forward-only kernels
KERNEL_ENTRIES = ("matmul", "attention_prefill", "fused_ffn")

NO_MESH = ("needs the sharded training layer (TP / FSDP params over the "
           "mesh, the int8-EF pod hop), which the port does not have yet "
           "(ROADMAP.md, slice 8b)")


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor         # () int32
    params: Any
    m: Any
    v: Any

    @staticmethod
    def create(params: Any) -> "TrainState":
        m, v = opt.adamw_init(params)
        dev = tree_leaves(params)[0].device
        return TrainState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          params=params, m=m, v=v)


def adamw_config(run: RunConfig) -> opt.AdamWConfig:
    return opt.AdamWConfig(
        learning_rate=run.learning_rate,
        weight_decay=run.weight_decay,
        warmup_steps=run.warmup_steps,
        total_steps=run.total_steps,
    )


def check_trainable_plan(plan) -> None:
    """Refuse a plan that would launch a hand-written kernel in the
    forward pass: none has a backward."""
    cuda = [name for name in KERNEL_ENTRIES
            if getattr(plan, name).backend == "cuda"]
    if cuda:
        raise ValueError(
            f"the train step needs a plan without the 'cuda' backend (here "
            f"on {', '.join(cuda)}): the hand-written kernels have no "
            "backward; use plan.with_overrides(backend='torch')")


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """(loss, d loss / d params): a forward, a backward pass and each
    leaf's ``.grad``, taken on detached leaves (the state's tensors are
    not touched)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, leaves)


def make_train_step(api: ModelApi, ctx: LayerCtx, run: RunConfig, *,
                    mesh=None) -> Callable:
    """Build train_step(state, batch) -> (state, metrics)."""
    check_trainable_plan(ctx.plan)
    if mesh is not None:
        raise ValueError(f"a sharded train step {NO_MESH}")
    if run.grad_compression != "none":
        raise ValueError(f"{run.grad_compression} gradient compression "
                         f"{NO_MESH}")
    acfg = adamw_config(run)
    remat = run.remat != "none"

    def loss_fn(params, batch):
        return api.train_loss(ctx, params, batch, remat=remat)

    def compute_grads(params, batch):
        nmb = run.microbatch
        if not nmb or nmb <= 1:
            return value_and_grad(loss_fn, params, batch)
        # gradient accumulation: `nmb` slices of the batch on axis 0,
        # f32 gradients summed over them
        b = next(iter(batch.values())).shape[0]
        if any(x.shape[0] != b for x in batch.values()) or b % nmb:
            raise ValueError(f"batch {b} does not split into {nmb} "
                             "microbatches")
        mb = b // nmb
        tot_l = 0.0
        tot_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(nmb):
            part = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            loss, grads = value_and_grad(loss_fn, params, part)
            tot_g = tree_map(lambda a, g: a + g.float(), tot_g, grads)
            tot_l = tot_l + loss
        return tot_l / nmb, tree_map(lambda g: g / nmb, tot_g)

    def train_step(state: TrainState, batch: dict):
        loss, grads = compute_grads(state.params, batch)
        params, m, v, metrics = opt.adamw_update(
            acfg, state.params, grads, state.m, state.v, state.step)
        new_state = TrainState(step=state.step + 1, params=params, m=m,
                               v=v)
        return new_state, dict(metrics, loss=loss)

    return train_step
