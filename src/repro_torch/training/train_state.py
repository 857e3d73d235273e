"""TrainState + the train step factory.

``make_train_step`` builds the function the trainer runs: the forward
loss (family-dispatched), its backward pass, optional microbatch gradient
accumulation, the optional int8-EF cross-pod gradient hop, the AdamW
update; a function of (state, batch) -> (state, metrics) that returns a
new state.

The step runs on the plan's non-kernel backend: every hand-written
kernel is a forward kernel only (as in the JAX package, whose kernels
have no VJP), so a ``"cuda"`` GEMM, prefill-attention or fused-FFN
backend is refused, and each kernel wrapper refuses inputs that require
a gradient.

**Under a mesh** (``mesh=``, with ``ctx.mesh`` / ``ctx.rules`` the same
mesh and its rules) the state holds this rank's shards under
``Rules.param_spec`` (:func:`mesh_setup` builds the context, rules and
specs; :func:`initial_state` the shards) and the
batch is this rank's slice over the batch axes (:func:`local_batch`).
The step gathers the FSDP-sharded leaves on use (one all-gather; its
backward reduce-scatters their gradients over the FSDP axes), the layers
run tensor-parallel over ``model`` on what is left, the loss is the
global batch's mean, the gradients of leaves no FSDP axis cuts are
summed over the batch axes (one all-reduce), and AdamW updates the local
shards after a global norm that counts each element once.

**int8-EF** (``run.grad_compression == "int8_ef"`` on a mesh with a
``pod`` axis; rules with ``fsdp_over_pod = act_over_pod = False``, as in
the JAX package): the gradients are pod-local (FSDP and the batch mean
stay inside the pod), then ``collectives.crosspod_psum_int8`` takes the
mean across pods on int8 codes, each rank keeping its pod's
error-feedback residual (``TrainState.ef_err``, a leading pod axis: this
rank's row); the loss is the mean over pods. Without a ``pod`` axis
``int8_ef`` is the plain step, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.config import MeshConfig, RunConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (P, gather_fsdp, gather_tree,
                                              local_shard, make_rules,
                                              make_shard_fn, regroup,
                                              shard_tree)
from repro_torch.models.api import ModelApi
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map
from repro_torch.training import optimizer as opt

# the plan entries whose "cuda" backend launches forward-only kernels
KERNEL_ENTRIES = ("matmul", "attention_prefill", "fused_ffn")


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor         # () int32
    params: Any
    m: Any
    v: Any
    ef_err: Optional[Any] = None   # int8-EF residuals (grad compression)

    @staticmethod
    def create(params: Any, *, npods: int = 0,
               compression: str = "none") -> "TrainState":
        m, v = opt.adamw_init(params)
        dev = tree_leaves(params)[0].device
        ef = None
        if compression == "int8_ef" and npods > 1:
            ef = C.zeros_error_state(params, npods)
        return TrainState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          params=params, m=m, v=v, ef_err=ef)


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


# ---------------------------------------------------------------------------
# The sharded state and batch
# ---------------------------------------------------------------------------


def state_specs(rules, params: Any, ef_err: bool = False) -> TrainState:
    """The specs of a state built on ``params`` (global shapes; meta
    tensors will do): params, m and v under ``rules.param_spec``, the
    step replicated, ``ef_err`` (with ``ef_err=True``) a leading pod axis
    over ``pod`` before the param's spec."""
    pspec = rules.param_spec_tree(params)
    return TrainState(step=P(), params=pspec, m=pspec, v=pspec,
                      ef_err=tree_map(lambda s: P("pod", *s), pspec)
                      if ef_err else None)


def _state_map(fn, state: TrainState, specs: TrainState) -> TrainState:
    return TrainState(
        step=state.step,
        **{f: None if getattr(state, f) is None else
           fn(getattr(state, f), getattr(specs, f))
           for f in ("params", "m", "v", "ef_err")})


def shard_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """This rank's shards of a state of global tensors."""
    return _state_map(lambda t, s: shard_tree(t, s, mesh), state, specs)


def gather_state(state: TrainState, specs: TrainState, mesh) -> TrainState:
    """The global state from every rank's shards (collective)."""
    return _state_map(lambda t, s: gather_tree(t, s, mesh), state, specs)


def mesh_setup(api: ModelApi, mesh=None, compression: str = "none"):
    """(ctx, rules, specs) of the train step on ``mesh``, as the CLI
    builds them: a ``LayerCtx`` on the ``"torch"`` plan with the mesh,
    its rules (int8-EF: FSDP and activations kept inside the pod) and
    their ``make_shard_fn``, ``moe_groups`` the ``data`` size (the JAX
    CLI's); the rules; the state's specs (:func:`state_specs`, with
    ``ef_err`` where the state has one). Without a mesh: (the plain
    ``LayerCtx``, None, None)."""
    plan = DEFAULT_PLAN.with_overrides(backend="torch")
    if mesh is None:
        return LayerCtx(api.cfg, plan), None, None
    plain = compression == "none"
    rules = make_rules(MeshConfig(mesh.shape, mesh.axis_names),
                       fsdp_over_pod=plain, act_over_pod=plain)
    ctx = LayerCtx(api.cfg, plan,
                   moe_groups=max(mesh.axis_sizes.get("data", 1), 1),
                   shard=make_shard_fn(mesh, rules), mesh=mesh, rules=rules)
    ef = not plain and mesh.axis_sizes.get("pod", 0) > 1
    return ctx, rules, state_specs(rules, api.init_params(device="meta"), ef)


def initial_state(params: Any, run: RunConfig, mesh=None,
                  specs: Optional[TrainState] = None) -> TrainState:
    """``TrainState.create`` on global ``params`` (with the ``ef_err``
    of ``run``'s compression on a mesh with pods); under a mesh this
    rank's shards under ``specs``."""
    npods = 0 if mesh is None else mesh.axis_sizes.get("pod", 0)
    state = TrainState.create(params, npods=npods,
                              compression=run.grad_compression)
    return state if mesh is None else shard_state(state, specs, mesh)


def local_batch(batch: dict, rules, mesh) -> dict:
    """This rank's rows of a host batch: dim 0 cut over every batch axis
    (``pod`` and ``data``; in the int8-EF mode the pod cut is the one the
    JAX package's shard_map makes). Raises unless the batch divides."""
    axes = rules.batch_axes
    n = mesh.axes_size(axes)
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over the "
                             f"batch axes {axes} ({n} ranks)")
        out[k] = local_shard(x, P(axes), mesh).contiguous()
    return out


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """(loss, d loss / d params): a forward, a backward pass and each
    leaf's ``.grad``, taken on detached leaves (the state's tensors are
    not touched)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda p: p.grad, leaves)


def make_grad_fn(api: ModelApi, ctx: LayerCtx, run: RunConfig, *,
                 mesh=None) -> Callable:
    """Build grads(params, batch) -> (loss, grads): the train step's
    loss and gradients before the optimizer. Under a mesh, this rank's
    shards of the gradients summed over the batch axes; with int8-EF,
    the pod's (its loss the pod's mean), before the cross-pod hop."""
    check_trainable_plan(ctx.plan)
    remat = run.remat != "none"
    if mesh is not None:
        if ctx.mesh is not mesh or ctx.rules is None:
            raise ValueError("a sharded train step needs LayerCtx(mesh=mesh, "
                             "rules=..., shard=make_shard_fn(mesh, rules))")
        rules = ctx.rules
        specs = rules.param_spec_tree(api.init_params(device="meta"))

    def loss_fn(params, batch):
        if mesh is not None:
            # the FSDP dims gathered (one all-gather a dtype); the
            # backward pass reduce-scatters their gradients
            params = gather_fsdp(params, specs, mesh, rules)
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

    def grads_fn(params, batch):
        loss, grads = compute_grads(params, batch)
        if mesh is not None:
            # leaves no FSDP axis cuts: their gradients summed over the
            # batch axes (one all-reduce a dtype)
            grads = regroup(grads, specs, rules.model_axis,
                            lambda d: d is None,
                            lambda ts, _: C.all_reduce_flat(
                                ts, mesh, rules.act_batch_axes))
        return loss, grads

    return grads_fn


def make_train_step(api: ModelApi, ctx: LayerCtx, run: RunConfig, *,
                    mesh=None) -> Callable:
    """Build train_step(state, batch) -> (state, metrics)."""
    grads_fn = make_grad_fn(api, ctx, run, mesh=mesh)
    acfg = adamw_config(run)
    specs = None
    compressed = False
    if mesh is not None:
        specs = ctx.rules.param_spec_tree(api.init_params(device="meta"))
        compressed = (run.grad_compression == "int8_ef"
                      and "pod" in mesh.axis_names)
        if compressed and (ctx.rules.fsdp_over_pod
                           or ctx.rules.act_over_pod):
            raise ValueError("the int8-EF step keeps FSDP and activations "
                             "inside the pod: make_rules(..., fsdp_over_pod="
                             "False, act_over_pod=False)")

    def train_step(state: TrainState, batch: dict):
        loss, grads = grads_fn(state.params, batch)
        ef = state.ef_err
        if compressed:
            if ef is None:
                raise ValueError("an int8-EF state needs TrainState.create("
                                 "..., npods=, compression='int8_ef')")
            # this rank holds its pod's row of the (npods, ...) residuals
            grads, err = C.crosspod_psum_int8(
                grads, tree_map(lambda e: e[0], ef), mesh)
            ef = tree_map(lambda e: e[None], err)
            loss = C.mean_over(loss, mesh, "pod")
        params, m, v, metrics = opt.adamw_update(
            acfg, state.params, grads, state.m, state.v, state.step,
            specs=specs, mesh=mesh)
        new_state = TrainState(step=state.step + 1, params=params, m=m,
                               v=v, ef_err=ef)
        return new_state, dict(metrics, loss=loss)

    return train_step
