"""The dry run: every (arch x shape) cell traced on the meta device, on
one H100 or as one rank of the pod meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both

The port's counterpart of the JAX package's ``repro.launch.dryrun``.
Where the JAX dry run lowers and compiles each cell with XLA and reads
``cost_analysis()`` / ``memory_analysis()`` and the collective schedule,
this one runs the cell's step on the meta device, where every tensor has
a shape and a dtype and no storage, under
:class:`repro_torch.analysis.cost.CostCounter`.

**One card** (no ``--mesh``; mesh ``"1"``): the full-depth run is the
fit proof (the bytes of the arguments: params, optimizer state, cache,
batch; the peak bytes of the tensors the step creates; their sum
``per_device_bytes`` and ``fits`` against the card's ``hbm_bytes``); two
probes of one and three layers (the encoder's too) give the counted
FLOPs and bytes, which ``roofline.extrapolate`` takes to full depth;
``roofline.terms_from`` (``chips=1``) gives the terms.

**The pod meshes** (``--mesh single|multi|both``: ``SINGLE_POD`` (16, 16)
and ``MULTI_POD`` (2, 16, 16), records ``16x16`` / ``2x16x16``): the
process plays rank 0 of a world of 256 or 512 ranks under torch's fake
process group (``"fake"``: its collectives move nothing), builds the
mesh's groups, cuts the cell's params, cache and batch to rank 0's
shards and runs the rank's step, whose collectives the counter records by
kind and bytes. The layout is the JAX ``lower_cell``'s: train cells
through ``training.train_state.mesh_setup`` (TP over ``model``, FSDP
over the batch axes; int8-EF with ``--grad-compression int8_ef``, which
the serving cells, having no gradient, leave out of their layout),
serving cells through ``serving/sharded.py`` (TP params, FSDP as well
where the rank's TP shard passes :func:`serve_replicate_budget`, the KV
sequence over ``model``, the decode tick on the sequence-split
attention, ``moe_groups`` the batch axes' product). ``full`` holds the
rank's argument, temporary and output bytes, ``per_device_bytes``,
``flops_per_device`` / ``bytes_per_device`` and its collectives, beside
``flops_global`` / ``bytes_global`` from the one-card count (the JAX dry
run's unsharded lowering). Probes run on the single pod only, as in the
JAX dry run: ``multi`` is the fit and shard proof. The collective term
takes a rank's bytes times the chips (``benchmarks/roofline_report.py``'s
global bytes). The dry run refuses to start inside a process that
already has a default process group, and destroys its own when done.

What it counts is the plain program: the plan's ``"torch"`` backend with
``fallback=False``, as the JAX dry run forces ``"xla"``, so every kernel
is its plain PyTorch version. Its bytes are an unfused count, and its
peak temporaries are those of the plain program (for instance the f32
copies of the KV cache that plain decode attention makes, layer by
layer), which bound the kernel path's.

Records are JSON files under ``--out`` (one a cell,
``arch__shape__mesh.json``, the JAX keys: ``arch, shape, mesh, chips,
ok, full, probes``, plus ``terms`` and, for serving cells on a mesh,
``fsdp_params``); a cell that fails is recorded with its traceback and
the exit code is 1.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import configs, hardware
from repro_torch.analysis import roofline
from repro_torch.analysis.cost import CostCounter
from repro_torch.config import (MULTI_POD, SINGLE_POD, MeshConfig,
                                ModelConfig, RunConfig, ShapeConfig, SHAPES,
                                applicable_shapes)
from repro_torch.core import plan as plan_mod
from repro_torch.distributed.sharding import shard_tree
from repro_torch.kernels import quant
from repro_torch.launch.mesh import make_mesh_from_config
from repro_torch.models import api as model_api
from repro_torch.models import wquant
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map
from repro_torch.serving.sharded import (cache_specs, local_zeros,
                                         serve_rules, sharded_serve)
from repro_torch.training.train_state import (TrainState, initial_state,
                                              local_batch, make_train_step,
                                              mesh_setup)

META = torch.device("meta")
MESH = "1"
PROBES = (1, 3)
MESHES = {"single": SINGLE_POD, "multi": MULTI_POD}

# Serving keeps params replicated over the batch axes (TP over ``model``
# only) while a rank's bf16 TP shard fits what the card has left: HBM,
# less the cell's KV cache on the rank, less headroom for the step's
# activations; FSDP would all-gather the whole parameter set every decoded
# token (the JAX package's EXPERIMENTS.md, deepseek decode iteration 2).
# The JAX package's SERVE_REPLICATE_BUDGET_BYTES = 10e9 is that
# difference on a 16 GB TPU v5e; here it is computed per cell from
# hardware.H100_SXM.hbm_bytes (serve_replicate_budget). The headroom is an
# assumption, not a measurement: a fifth of the card, many times the
# largest peak of created bytes this dry run counts on a decode cell's
# rank (0.6 GB, phi3-mini-3.8b decode_32k at 16 x 16). No headroom covers
# the prefill cells' unfused plain program (up to 181 GB a rank,
# dbrx-132b prefill_32k), whose attention and MoE temporaries the
# kernels' path never creates. On this budget no cell of iter_cells()
# takes FSDP serving params; only the tests drive that branch.
SERVE_ACTIVATION_HEADROOM_BYTES = 16 * 10**9


# ---------------------------------------------------------------------------
# Step builders — one per shape kind; each returns (fn, args) on meta
# ---------------------------------------------------------------------------


def _plan(run: RunConfig) -> plan_mod.ExecutionPlan:
    base = run.plan if run.plan is not None else plan_mod.DEFAULT_PLAN
    return base.with_overrides(
        backend="torch",   # the plain program: no kernel runs on meta
        fallback=False,
        scheme="sync" if run.sync_softmax else None,
    )


def _ctx(cfg: ModelConfig, run: RunConfig) -> LayerCtx:
    return LayerCtx(cfg=cfg, plan=_plan(run))


def _meta(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=META), specs)


def _quantized(api, plan, params):
    """``params`` quantized as the engine quantizes them at load under the
    plan's ``weight_dtype`` (refused for MoE, as the engine refuses it)."""
    spec = quant.spec_for(plan.matmul.weight_dtype)
    if spec is None:
        return params
    if api.cfg.family == "moe":
        raise ValueError(f"weight_dtype {plan.matmul.weight_dtype!r} is not "
                         "served for the moe family (serving/engine.py)")
    return wquant.quantize_params(params, spec)


def _serve_params(api, plan):
    """The serving cells' params on one card."""
    return _quantized(api, plan, api.init_params(device=META))


def build_train(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig):
    api = model_api.get_model(cfg)
    step = make_train_step(api, _ctx(cfg, run), run)
    state = TrainState.create(api.init_params(device=META))
    batch = _meta(model_api.train_input_specs(cfg, shape))
    return step, (state, batch)


def build_decode(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig):
    """One decode step over the dense (B, S) cache, every row at S - 1."""
    api = model_api.get_model(cfg)
    ctx = _ctx(cfg, run)
    specs = model_api.serve_decode_input_specs(cfg, shape)

    def serve_step(params, tokens, cache, lengths):
        return api.decode_step(ctx, params, tokens, cache, lengths)

    lengths = torch.full(specs["lengths"].shape, shape.seq_len - 1,
                         dtype=specs["lengths"].dtype, device=META)
    return serve_step, (_serve_params(api, ctx.plan),
                        _meta(specs["tokens"]), _meta(specs["cache"]),
                        lengths)


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig):
    """Whole prompts into a dense cache the step allocates (an output, as
    in the JAX dry run, not an argument)."""
    api = model_api.get_model(cfg)
    ctx = _ctx(cfg, run)
    specs = model_api.serve_prefill_input_specs(cfg, shape)
    layout = DenseLayout(shape.global_batch, shape.seq_len)

    def prefill_step(params, tokens, lengths, extra):
        cache = api.init_cache(layout, device=META)
        return api.prefill(ctx, params, tokens, lengths, cache, **extra)

    extra = {k: v for k, v in specs.items() if k not in ("tokens", "lengths")}
    return prefill_step, (_serve_params(api, ctx.plan),
                          _meta(specs["tokens"]), _meta(specs["lengths"]),
                          _meta(extra))


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# ---------------------------------------------------------------------------
# Step builders on a mesh: rank 0's shards of each argument
# ---------------------------------------------------------------------------


def serve_replicate_budget(cfg: ModelConfig, shape: ShapeConfig,
                           mesh_cfg: MeshConfig,
                           spec: hardware.HardwareSpec = hardware.H100_SXM
                           ) -> float:
    """The bytes a rank may spend on its TP shard of the params before
    serving cuts them over the batch axes too: the card's HBM less the
    cell's dense KV cache on the rank (``Rules.cache_spec``'s cut) less
    SERVE_ACTIVATION_HEADROOM_BYTES."""
    rules = serve_rules(mesh_cfg)
    sizes = rules.axis_sizes
    cache = model_api.get_model(cfg).init_cache(
        DenseLayout(shape.global_batch, shape.seq_len), device=META)
    cache_bytes = 0
    for t in tree_leaves(cache):
        n = t.nbytes
        for entry in rules.cache_spec(tuple(t.shape)):
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                n //= sizes[a]
        cache_bytes += n
    return spec.hbm_bytes - cache_bytes - SERVE_ACTIVATION_HEADROOM_BYTES


def serve_fsdp_params(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_cfg: MeshConfig) -> bool:
    """Whether a serving cell cuts its params over the batch axes too: its
    bf16 TP shard (the JAX package's ``param_count() * 2 / model``) past
    :func:`serve_replicate_budget`."""
    model = dict(zip(mesh_cfg.axis_names, mesh_cfg.shape)).get("model", 1)
    return (cfg.param_count() * 2 / model
            > serve_replicate_budget(cfg, shape, mesh_cfg))


def build_train_mesh(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                     mesh):
    """The sharded train step as the CLI builds it (``mesh_setup``),
    ``moe_groups`` the batch axes' product (the JAX dry run's), on rank
    0's shards of the state and the batch."""
    api = model_api.get_model(cfg)
    ctx, rules, specs = mesh_setup(api, mesh, run.grad_compression)
    groups = 1
    for a in rules.batch_axes:
        groups *= mesh.size(a)
    ctx = dataclasses.replace(ctx, plan=_plan(run), moe_groups=groups)
    step = make_train_step(api, ctx, run, mesh=mesh)
    state = initial_state(api.init_params(device=META), run, mesh, specs)
    batch = local_batch(_meta(model_api.train_input_specs(cfg, shape)),
                        rules, mesh)
    return step, (state, batch), {}


def _mesh_serve(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh):
    """(the rank's ShardedServe, its params, the rules, the record's
    extra fields): the serving rules with FSDP params where the budget
    says so; quantized params cut first (a rank quantizes its own TP
    shard; refused with FSDP params)."""
    api = model_api.get_model(cfg)
    fsdp = serve_fsdp_params(cfg, shape, MeshConfig(mesh.shape,
                                                    mesh.axis_names))
    rules = serve_rules(mesh, fsdp_params=fsdp,
                        seq_shard_kv=run.seq_shard_attention)
    plan = _plan(run)
    if quant.spec_for(plan.matmul.weight_dtype) is not None and fsdp:
        raise ValueError("quantized serving weights with FSDP params are "
                         "not counted on a mesh")
    srv = sharded_serve(api, plan, mesh, rules)
    params = shard_tree(api.init_params(device=META), srv.param_specs, mesh)
    return srv, _quantized(api, plan, params), rules, {"fsdp_params": fsdp}


def _rows(spec, rules, mesh):
    """Rank 0's rows of a (B, ...) serving input spec, on meta."""
    return local_zeros(spec, rules.batch_spec(tuple(spec.shape)), mesh,
                       device=META)


def build_decode_mesh(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                      mesh):
    """One decode tick of rank 0: its rows and its slice of the dense (B,
    S) cache, every row at S - 1."""
    srv, params, rules, extra = _mesh_serve(cfg, shape, run, mesh)
    specs = model_api.serve_decode_input_specs(cfg, shape)
    cache = local_zeros(specs["cache"], cache_specs(specs["cache"], rules),
                        mesh, device=META)
    lengths = _rows(specs["lengths"], rules, mesh).fill_(shape.seq_len - 1)
    return srv.decode_step, (params, _rows(specs["tokens"], rules, mesh),
                             cache, lengths), extra


def build_prefill_mesh(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                       mesh):
    """Rank 0's prompts into its slice of a dense cache the step
    allocates."""
    srv, params, rules, extra = _mesh_serve(cfg, shape, run, mesh)
    specs = model_api.serve_prefill_input_specs(cfg, shape)
    whole = srv.api.init_cache(DenseLayout(shape.global_batch,
                                           shape.seq_len), device=META)
    cspecs = cache_specs(whole, rules)

    def prefill_step(params, tokens, lengths, inputs):
        cache = local_zeros(whole, cspecs, mesh)
        return srv.prefill(params, tokens, lengths, cache, **inputs)

    inputs = {k: _rows(v, rules, mesh) for k, v in specs.items()
              if k not in ("tokens", "lengths")}
    return prefill_step, (params, _rows(specs["tokens"], rules, mesh),
                          _rows(specs["lengths"], rules, mesh),
                          inputs), extra


MESH_BUILDERS = {"train": build_train_mesh, "prefill": build_prefill_mesh,
                 "decode": build_decode_mesh}


@contextlib.contextmanager
def fake_world(mesh_cfg: MeshConfig):
    """Rank 0 of a world of ``mesh_cfg.num_devices`` ranks under torch's
    fake process group, and its mesh; the group is destroyed on exit.
    Refuses to start where a default group already exists."""
    if dist.is_initialized():
        raise RuntimeError("the mesh dry run plays rank 0 of a fake world "
                           "and needs a process without a default process "
                           "group")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the mesh dry run needs torch's fake process "
                           "group (torch.testing._internal.distributed."
                           "fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_cfg.num_devices)
    try:
        yield make_mesh_from_config(mesh_cfg, backend="fake")
    finally:
        dist.destroy_process_group()


def mesh_name(mesh_cfg: MeshConfig) -> str:
    return "x".join(str(n) for n in mesh_cfg.shape)


# ---------------------------------------------------------------------------
# Count one cell
# ---------------------------------------------------------------------------


def _probe_cfg(cfg: ModelConfig, num_layers: int) -> ModelConfig:
    updates: dict[str, Any] = {"num_layers": num_layers}
    if cfg.encoder_layers:
        updates["encoder_layers"] = num_layers
    return dataclasses.replace(cfg, **updates)


def _leaves(x) -> list:
    """The tensors of a step's arguments or outputs: trees, tuples and a
    ``TrainState``'s fields."""
    if isinstance(x, TrainState):
        x = vars(x)
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _count(fn, args, spec: hardware.HardwareSpec) -> dict:
    """Run ``fn(*args)`` on meta under the counter: (FLOPs, bytes, the
    memory fields, the collectives)."""
    leaves = _leaves(args)
    arg_bytes = sum(t.nbytes for t in leaves)
    arg_ids = {id(t.untyped_storage()) for t in leaves}
    t0 = time.perf_counter()
    with CostCounter() as c:
        out = fn(*args)
        out_bytes = sum(t.nbytes for t in _leaves(out)
                        if id(t.untyped_storage()) not in arg_ids)
        del out
    coll = c.collectives
    per_device = arg_bytes + c.peak_bytes
    return {
        "flops": float(c.flops),
        "bytes": float(c.bytes_accessed),
        "argument_size_in_bytes": arg_bytes,
        "temp_size_in_bytes": c.peak_bytes,
        "output_size_in_bytes": out_bytes,
        "per_device_bytes": per_device,
        "hbm_bytes": spec.hbm_bytes,
        "fits": per_device <= spec.hbm_bytes,
        "collective_bytes": coll.total_bytes(),
        "collective_counts": coll.counts,
        "collective_by_kind": coll.by_kind(),
        "trace_s": round(time.perf_counter() - t0, 2),
    }


def _named(rec: dict, suffix: str) -> dict:
    rec[f"flops_{suffix}"] = rec.pop("flops")
    rec[f"bytes_{suffix}"] = rec.pop("bytes")
    return rec


def count(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
          spec: hardware.HardwareSpec = hardware.H100_SXM) -> dict:
    """Run one cell's step on one card, on meta, under the counter."""
    fn, args = BUILDERS[shape.kind](cfg, shape, run)
    return _named(_count(fn, args, spec), "global")


def count_mesh(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh,
               spec: hardware.HardwareSpec = hardware.H100_SXM) -> dict:
    """Run rank 0's step of one cell on ``mesh`` (a fake world's,
    :func:`fake_world`), on meta, under the counter: its FLOPs and bytes
    (``_per_device``), memory and collectives, and the cell's layout
    fields (``fsdp_params`` for serving)."""
    fn, args, extra = MESH_BUILDERS[shape.kind](cfg, shape, run, mesh)
    return dict(_named(_count(fn, args, spec), "per_device"), **extra)


def _global(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig) -> dict:
    """The one-card count's FLOPs and bytes: the cell's global totals."""
    rec = count(cfg, shape, run)
    return {k: rec[k] for k in ("flops_global", "bytes_global")}


def run_cell(
    arch: str,
    shape_name: str,
    run: RunConfig = RunConfig(),
    *,
    mesh_cfg: Optional[MeshConfig] = None,
    probes: tuple[int, ...] = PROBES,
    full: bool = True,
    sync_softmax: bool = False,
    plan: Optional[plan_mod.ExecutionPlan] = None,
    cfg: Optional[ModelConfig] = None,
) -> dict:
    """The record of one cell, on one card or (``mesh_cfg``) as rank 0 of
    that mesh in a fake world of its own; ``cfg`` overrides the arch's
    published config, e.g. a smoke config in the tests."""
    cfg = cfg or configs.get(arch)
    if plan is not None:
        run = dataclasses.replace(run, plan=plan)
    if sync_softmax:   # the pre-T1 baseline
        run = dataclasses.replace(run, sync_softmax=True)
    shape = SHAPES[shape_name]
    chips = 1 if mesh_cfg is None else mesh_cfg.num_devices
    record: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": ((MESH if mesh_cfg is None else mesh_name(mesh_cfg))
                 + ("-sync" if sync_softmax else "")),
        "chips": chips, "ok": False,
    }
    try:
        if mesh_cfg is None:
            if full:
                record["full"] = count(cfg, shape, run)
            record["probes"] = [
                dict(count(_probe_cfg(cfg, nl), shape, run), num_layers=nl)
                for nl in probes]
        else:
            with fake_world(mesh_cfg) as mesh:
                if full:
                    record["full"] = count_mesh(cfg, shape, run, mesh)
                    record["full"].update(_global(cfg, shape, run))
                record["probes"] = []
                for nl in probes:
                    pcfg = _probe_cfg(cfg, nl)
                    row = count_mesh(pcfg, shape, run, mesh)
                    row.update(_global(pcfg, shape, run), num_layers=nl)
                    record["probes"].append(row)
            first = record.get("full") or (record["probes"] or [{}])[0]
            if "fsdp_params" in first:
                record["fsdp_params"] = first["fsdp_params"]
        if len(probes) >= 2:
            # a rank's collective bytes x chips: the global wire bytes
            cost = roofline.extrapolate(
                [roofline.ProbeCost(p["num_layers"], p["flops_global"],
                                    p["bytes_global"],
                                    p["collective_bytes"] * chips)
                 for p in record["probes"]], cfg.num_layers)
            record["terms"] = roofline.terms_from(
                arch=arch, shape=shape_name, mesh=record["mesh"],
                chips=chips, cost=cost,
                model_flops=roofline.model_flops_for(cfg, shape),
                per_device_bytes=(record.get("full") or {}).get(
                    "per_device_bytes")).to_dict()
        record["ok"] = True
    except Exception:  # noqa: BLE001 - a cell's failure is its record
        record["error"] = traceback.format_exc(limit=20)
    return record


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def iter_cells(arch_filter=None, shape_filter=None):
    for arch in configs.ASSIGNED:
        if arch_filter and arch != arch_filter:
            continue
        for shape in applicable_shapes(configs.get(arch)):
            if shape_filter and shape.name != shape_filter:
                continue
            yield arch, shape.name


def markdown_table(records: list[dict]) -> str:
    """One row a counted cell: the mesh, per_device_bytes (GB), fits, the
    counted FLOPs and bytes at full depth, model FLOPs, their ratio, the
    compute, memory and collective terms (ms) and the bottleneck."""
    lines = ["| arch | shape | mesh | GB/dev | fits | FLOPs | bytes "
             "| model FLOPs | useful | compute ms | memory ms "
             "| collective ms | bound |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
             "| --- | --- | --- |"]
    for r in records:
        t, full = r["terms"], r.get("full") or {}
        gb = full.get("per_device_bytes")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {'-' if gb is None else f'{gb / 1e9:.2f}'} "
            f"| {'-' if gb is None else ('yes' if full['fits'] else 'no')} "
            f"| {t['hlo_flops']:.3e} | {t['hlo_bytes']:.3e} "
            f"| {t['model_flops']:.3e} | {t['useful_ratio']:.2f} "
            f"| {1e3 * t['compute_s']:.4g} | {1e3 * t['memory_s']:.4g} "
            f"| {1e3 * t['collective_s']:.4g} | {t['bottleneck']} |")
    return "\n".join(lines)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default=None,
                    help="count rank 0 of the pod meshes (16 x 16, 2 x 16 "
                    "x 16) in a fake world instead of one card; probes on "
                    "the single pod only")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-probes", action="store_true",
                    help="full-depth run only (the fit proof)")
    ap.add_argument("--no-full", action="store_true",
                    help="probes only (roofline terms)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"],
                    help="int8-EF over the pod axis in the train cells "
                    "(needs --mesh; a no-op without a pod, as in the JAX "
                    "package; serving cells keep the plain layout)")
    ap.add_argument("--sync-softmax", action="store_true",
                    help="pre-T1 baseline: every attention op on the "
                    "synchronized scheme")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="ExecutionPlan JSON to dispatch by (requires "
                    "--arch: a plan's provenance pins one config)")
    ap.add_argument("--tune", action="store_true",
                    help="tune a fresh plan per arch (analytical) before "
                    "counting; the backend is still forced to torch")
    ap.add_argument("--decode-fusion", choices=["split", "fused", "looped"],
                    default=None,
                    help="override the plan's decode-layer granularity "
                    "(on torch the fused stages run their oracles)")
    ap.add_argument("--weight-dtype", choices=["bf16", "int8", "fp8"],
                    default=None,
                    help="override the plan's GEMM weight dtype; the "
                    "serving cells count quantized params")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.grad_compression != "none" and args.mesh is None:
        raise ValueError(f"--grad-compression {args.grad_compression} "
                         "compresses the gradient hop between pods: one "
                         "card has none; add --mesh multi")
    if args.plan and not args.arch:
        ap.error("--plan requires --arch (plan provenance pins one config)")

    os.makedirs(args.out, exist_ok=True)
    plans: dict[str, plan_mod.ExecutionPlan] = {}

    def plan_for(arch: str) -> Optional[plan_mod.ExecutionPlan]:
        if not (args.tune or args.plan or args.decode_fusion
                or args.weight_dtype):
            return None
        if arch not in plans:
            cfg = configs.get(arch)
            if args.tune:
                base = plan_mod.tune(cfg)
                if args.plan:   # serve.py semantics: tune + save to --plan
                    base.save(args.plan)
            elif args.plan:
                base = plan_mod.ExecutionPlan.load(args.plan, cfg=cfg)
            else:
                base = plan_mod.DEFAULT_PLAN
            if args.decode_fusion is not None:
                base = dataclasses.replace(
                    base, decode_fusion=dataclasses.replace(
                        base.decode_fusion, granularity=args.decode_fusion))
            if args.weight_dtype is not None:
                base = dataclasses.replace(
                    base, matmul=dataclasses.replace(
                        base.matmul, weight_dtype=args.weight_dtype))
            plans[arch] = base
        return plans[arch]

    run = RunConfig(grad_compression=args.grad_compression)
    meshes = [None] if args.mesh is None else [
        MESHES[m] for m in ("single", "multi") if args.mesh in (m, "both")]
    failures = 0
    counted = []
    for mesh_cfg in meshes:
        # probes (roofline) on one card and the single pod; the multi pod
        # is the fit and shard proof, as in the JAX dry run
        probes = () if args.no_probes or mesh_cfg is MULTI_POD else PROBES
        for arch, shape_name in iter_cells(args.arch, args.shape):
            t0 = time.time()
            rec = run_cell(arch, shape_name, run, mesh_cfg=mesh_cfg,
                           probes=probes, full=not args.no_full,
                           sync_softmax=args.sync_softmax,
                           plan=plan_for(arch))
            dt = time.time() - t0
            tag = "OK " if rec["ok"] else "FAIL"
            print(f"[{tag}] {rec['mesh']:<9} {arch:<16} {shape_name:<12} "
                  f"({dt:.1f}s)", flush=True)
            if not rec["ok"]:
                failures += 1
                print(rec["error"].splitlines()[-1])
            elif "terms" in rec:
                counted.append(rec)
            fname = f"{arch}__{shape_name}__{rec['mesh']}.json"
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(rec, f, indent=2)
    if counted:
        print(roofline.format_table([r["terms"] for r in counted]))
        print(markdown_table(counted))
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
