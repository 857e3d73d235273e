"""Single-card dry run: every (arch x shape) cell traced on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b

The port's counterpart of the JAX package's ``repro.launch.dryrun``,
for one H100 (mesh ``"1"``). Where the JAX dry run lowers and compiles
each cell with XLA and reads ``cost_analysis()`` / ``memory_analysis()``,
this one runs the cell's step on the meta device, where every tensor has
a shape and a dtype and no storage, under
:class:`repro_torch.analysis.cost.CostCounter`. Per cell:

  * the full-depth run is the fit proof: the bytes of the arguments
    (params, optimizer state, cache, batch), the peak bytes of the
    tensors the step creates (its temporaries and outputs), their sum
    ``per_device_bytes`` and ``fits`` against the card's ``hbm_bytes``;
  * two probes of one and three layers (the encoder's too) give the
    counted FLOPs and bytes, which ``roofline.extrapolate`` takes to full
    depth; ``roofline.terms_from`` (``chips=1``) gives the terms.

What it counts is the plain program: the plan's ``"torch"`` backend with
``fallback=False``, as the JAX dry run forces ``"xla"``, so every kernel
is its plain PyTorch version. Its bytes are an unfused count, and its
peak temporaries are those of the plain program (for instance the f32
copies of the KV cache that plain decode attention makes, layer by
layer), which bound the kernel path's.

Records are JSON files under ``--out`` (one a cell, the JAX keys:
``arch, shape, mesh, chips, ok, full, probes``, plus ``terms``); a cell
that fails is recorded with its traceback and the exit code is 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Optional

import torch

from repro_torch import configs, hardware
from repro_torch.analysis import roofline
from repro_torch.analysis.cost import CostCounter
from repro_torch.config import (ModelConfig, RunConfig, ShapeConfig, SHAPES,
                                applicable_shapes)
from repro_torch.core import plan as plan_mod
from repro_torch.kernels import quant
from repro_torch.models import api as model_api
from repro_torch.models import wquant
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map
from repro_torch.training.train_state import (TrainState,
                                              make_train_step)

META = torch.device("meta")
MESH = "1"
PROBES = (1, 3)


# ---------------------------------------------------------------------------
# Step builders — one per shape kind; each returns (fn, args) on meta
# ---------------------------------------------------------------------------


def _ctx(cfg: ModelConfig, run: RunConfig) -> LayerCtx:
    base = run.plan if run.plan is not None else plan_mod.DEFAULT_PLAN
    plan = base.with_overrides(
        backend="torch",   # the plain program: no kernel runs on meta
        fallback=False,
        scheme="sync" if run.sync_softmax else None,
    )
    return LayerCtx(cfg=cfg, plan=plan)


def _meta(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=META), specs)


def _serve_params(api, plan):
    """The serving cells' params, quantized as the engine quantizes them
    at load under the plan's ``weight_dtype`` (refused for MoE, as the
    engine refuses it)."""
    params = api.init_params(device=META)
    spec = quant.spec_for(plan.matmul.weight_dtype)
    if spec is None:
        return params
    if api.cfg.family == "moe":
        raise ValueError(f"weight_dtype {plan.matmul.weight_dtype!r} is not "
                         "served for the moe family (serving/engine.py)")
    return wquant.quantize_params(params, spec)


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


def count(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
          spec: hardware.HardwareSpec = hardware.H100_SXM) -> dict:
    """Run one cell's step on meta under the counter."""
    fn, args = BUILDERS[shape.kind](cfg, shape, run)
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
        "flops_global": float(c.flops),
        "bytes_global": float(c.bytes_accessed),
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


def run_cell(
    arch: str,
    shape_name: str,
    run: RunConfig = RunConfig(),
    *,
    probes: tuple[int, ...] = PROBES,
    full: bool = True,
    sync_softmax: bool = False,
    plan: Optional[plan_mod.ExecutionPlan] = None,
    cfg: Optional[ModelConfig] = None,
) -> dict:
    """The record of one cell (``cfg`` overrides the arch's published
    config, e.g. a smoke config in the tests)."""
    cfg = cfg or configs.get(arch)
    if plan is not None:
        run = dataclasses.replace(run, plan=plan)
    if sync_softmax:   # the pre-T1 baseline
        run = dataclasses.replace(run, sync_softmax=True)
    shape = SHAPES[shape_name]
    record: dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": MESH + ("-sync" if sync_softmax else ""),
        "chips": 1, "ok": False,
    }
    try:
        if full:
            record["full"] = count(cfg, shape, run)
        record["probes"] = [
            dict(count(_probe_cfg(cfg, nl), shape, run), num_layers=nl)
            for nl in probes]
        if len(probes) >= 2:
            cost = roofline.extrapolate(
                [roofline.ProbeCost(p["num_layers"], p["flops_global"],
                                    p["bytes_global"], p["collective_bytes"])
                 for p in record["probes"]], cfg.num_layers)
            record["terms"] = roofline.terms_from(
                arch=arch, shape=shape_name, mesh=record["mesh"], chips=1,
                cost=cost, model_flops=roofline.model_flops_for(cfg, shape),
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
    """One row a counted cell: per_device_bytes (GB), fits, the counted
    FLOPs and bytes at full depth, model FLOPs, their ratio, the compute
    and memory terms (ms) and the bottleneck."""
    lines = ["| arch | shape | GB/dev | fits | FLOPs | bytes | model FLOPs "
             "| useful | compute ms | memory ms | bound |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- "
             "| --- |"]
    for r in records:
        t, full = r["terms"], r.get("full") or {}
        gb = full.get("per_device_bytes")
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {'-' if gb is None else f'{gb / 1e9:.2f}'} "
            f"| {'-' if gb is None else ('yes' if full['fits'] else 'no')} "
            f"| {t['hlo_flops']:.3e} | {t['hlo_bytes']:.3e} "
            f"| {t['model_flops']:.3e} | {t['useful_ratio']:.2f} "
            f"| {1e3 * t['compute_s']:.4g} | {1e3 * t['memory_s']:.4g} "
            f"| {t['bottleneck']} |")
    return "\n".join(lines)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default=None,
                    help="the JAX dry run's pod meshes (not yet ported: "
                    "raises)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-probes", action="store_true",
                    help="full-depth run only (the fit proof)")
    ap.add_argument("--no-full", action="store_true",
                    help="probes only (roofline terms)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
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


# the dry run counts one card: its pod meshes and their collective term
# are still to come
NO_MESH = ("needs the dry run's mesh (pod meshes, the collective term), "
           "which the port does not have yet (ROADMAP.md, slice 8b-3b)")


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise ValueError(f"--mesh {args.mesh}: a multi-card dry run {NO_MESH}")
    if args.grad_compression != "none":
        raise ValueError(f"--grad-compression {args.grad_compression} "
                         f"{NO_MESH}")
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

    failures = 0
    counted = []
    for arch, shape_name in iter_cells(args.arch, args.shape):
        t0 = time.time()
        rec = run_cell(arch, shape_name,
                       probes=() if args.no_probes else PROBES,
                       full=not args.no_full,
                       sync_softmax=args.sync_softmax, plan=plan_for(arch))
        dt = time.time() - t0
        tag = "OK " if rec["ok"] else "FAIL"
        print(f"[{tag}] {rec['mesh']:<7} {arch:<16} {shape_name:<12} "
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
