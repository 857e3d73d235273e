"""Runs a task of ``tests/test_torch_distributed.py`` on W gloo ranks of the
port, each in a process of its own (``python -c``, a ``FileStore`` in the
test's ``tmp_path``, started by ``launch.mesh.run_ranks``), and returns
each rank's result.

The ranks import neither JAX nor the JAX package: the test computes the
reference in its own process and hands the ranks numpy inputs. Each rank
joins a world of ``W`` on the CPU, builds the mesh (``mesh=(shape,
names)``; by default (data=1, model=W)) and runs one task of
:data:`TASKS`. The parent polls the ranks: a rank that
fails, or a run that passes its ``timeout``, kills every rank and fails
the test; the process group's own timeout is shorter than the test's, so
a rank left waiting in a collective raises instead of hanging.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys
from pathlib import Path

from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]


# The sharded train step's collectives, derived from the code (the smoke
# qwen2-0.5b, remat on, 2 layers, 8 loss chunks): forward: the FSDP
# all-gather, the embedding's all-reduce, two a layer (wo, w_down), two a
# loss chunk (max; exponent sum with the label's logit), the loss's batch
# mean; recomputed in the backward pass: each layer's attention
# all-reduce (the recompute stops at the last saved tensor: the MLP's
# all-reduce feeds none), each chunk's two; backward: two a layer (the
# copies into the TP region), one a chunk (the head's copy), the FSDP
# reduce-scatter; then the replicated leaves' batch sum and the global
# norm. Without model: the FSDP pair, the loss mean, the batch sum and the
# norm. Held against the gloo runs (tests/test_torch_sharded_train.py) and
# against the dry run's meta count of one rank
# (tests/test_torch_mesh_dryrun.py).
TRAIN_COLLECTIVES = {(2, 2): {"all-reduce": 55, "all-gather": 1},
                     (1, 2): {"all-reduce": 52},
                     (2, 1): {"all-reduce": 4, "all-gather": 1}}


def run(task: str, world: int, tmp_path, payload, timeout: float = 120.0,
        mesh=None):
    """``TASKS[task](mesh, payload)`` on ranks 0 .. world - 1 of the mesh
    ``mesh = (shape, axis names)`` (default ((1, world), ("data",
    "model"))); returns their results in rank order."""
    shape, names = mesh or ((1, world), ("data", "model"))
    tag = "x".join(map(str, shape))
    tmp = Path(tmp_path) / f"{task}_w{world}_{tag}"
    tmp.mkdir(parents=True)
    (tmp / "payload.pkl").write_bytes(pickle.dumps(payload))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    try:
        codes = run_ranks(
            [[sys.executable, "-c",
              f"import _torch_dist as d; d.child({task!r}, {r}, {world}, "
              f"{str(tmp)!r}, {tuple(shape)!r}, {tuple(names)!r})"]
             for r in range(world)],
            env=env, cwd=str(ROOT), timeout=timeout, outputs=logs)
    finally:
        for log in logs:
            log.close()
    if codes != [0] * world:
        tails = "\n".join(
            f"--- rank {r} (exit {c}):\n"
            + (tmp / f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f"{task} on {world} gloo ranks failed or "
                             f"passed {timeout}s:\n{tails}")
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def child(task: str, rank: int, world: int, tmp: str, shape=None,
          names=("data", "model")) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config

    torch.set_num_threads(1)
    tmp = Path(tmp)
    payload = pickle.loads((tmp / "payload.pkl").read_bytes())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh_from_config(MeshConfig(shape or (1, world), names),
                                     device="cpu")
        out = TASKS[task](mesh, payload)
    finally:
        dist.destroy_process_group()
    (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _allreduces(counter) -> int:
    return counter.collectives.counts.get("all-reduce", 0)


def task_combine(mesh, p):
    """This rank's JAX partials through the collective combines."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.core import softmax as smx

    rank = mesh.coord("model")
    group = mesh.group("model")
    a = smx.AsyncPartial(*map(torch.from_numpy, p["async"][rank]))
    s = smx.SyncPartial(*map(torch.from_numpy, p["sync"][rank]))
    with CostCounter() as c_async:
        out_a, mc = smx.combine_async_collective(a, group, stat=True)
    with CostCounter() as c_sync:
        out_s = smx.combine_sync_collective(s, group)
    return dict(async_out=out_a.numpy(), mc=mc.numpy(),
                sync_out=out_s.numpy(), n_async=_allreduces(c_async),
                n_sync=_allreduces(c_sync))


def task_attention(mesh, p):
    """decode_attention_sharded over this rank's slice of the global
    cache, both schemes on both backends, with the all-reduces counted."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import SoftmaxPhiConfig
    from repro_torch.core.attention import decode_attention_sharded

    w, rank = mesh.size("model"), mesh.coord("model")
    q, k, v, lengths = map(torch.from_numpy,
                           (p["q"], p["k"], p["v"], p["lengths"]))
    s_loc = k.shape[1] // w
    k_loc = k[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    v_loc = v[:, rank * s_loc:(rank + 1) * s_loc].contiguous()
    out = {}
    for scheme, phi_cfg in (("unified_max", SoftmaxPhiConfig(phi=0.0)),
                            ("sync", SoftmaxPhiConfig(enabled=False))):
        for backend in ("cuda", "torch"):
            with CostCounter() as c:
                o = decode_attention_sharded(mesh, q, k_loc, v_loc, lengths,
                                             phi_cfg=phi_cfg, scheme=scheme,
                                             backend=backend)
            out[scheme, backend] = (o.numpy(), _allreduces(c))
    return out


def task_decode(mesh, p):
    """Greedy decode steps of the smoke model, its cache split over the
    ranks: every step's logits and tokens, this rank's final cache slice,
    and the all-reduces of one step."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.core.attention import make_decode_attention_fn
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import local_shard, make_rules
    from repro_torch.models.api import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx

    cfg = p["cfg"]
    api = get_model(cfg)
    params = params_from_numpy(p["params"], device="cpu")
    rules = make_rules(MeshConfig(mesh.shape, mesh.axis_names))
    b, s = p["tokens"].shape[0], p["cache"]["k"].shape[2]
    out = {}
    for plan_backend, scheme in (("cuda", "unified_max"), ("torch", "sync")):
        plan = make_plan(plan_backend, scheme=scheme, fused_ffn=False,
                         decode_fusion=p["fusion"])
        fn = make_decode_attention_fn(mesh, rules, cfg.softmax_phi,
                                      scheme=scheme, backend=plan_backend)
        ctx = LayerCtx(cfg=cfg, plan=plan, decode_attention_fn=fn)
        cache = api.init_cache(DenseLayout(b, s // mesh.size("model")),
                               device="cpu")
        for name, leaf in cache.items():
            glob = torch.from_numpy(p["cache"][name])
            leaf.copy_(local_shard(glob, rules.cache_spec(glob.shape), mesh))
        tokens = torch.from_numpy(p["tokens"])
        lengths = torch.from_numpy(p["lengths"])
        logits, toks, counts = [], [], []
        with torch.no_grad():
            for _ in range(p["steps"]):
                with CostCounter() as c:
                    lg, cache = api.decode_step(ctx, params, tokens, cache,
                                                lengths)
                counts.append(_allreduces(c))
                logits.append(lg.numpy().copy())
                tokens = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                toks.append(tokens.numpy().copy())
                lengths = lengths + 1
        out[scheme] = dict(logits=logits, tokens=toks, counts=counts,
                           cache={k: v.numpy() for k, v in cache.items()})
    return out


# ---------------------------------------------------------------------------
# The sharded trainer (tests/test_torch_sharded_train.py)
# ---------------------------------------------------------------------------


def _train_setup(mesh, p):
    """(api, ctx, rules, specs) of the model ``p["cfg"]`` on ``mesh``,
    as the CLI builds them (``train_state.mesh_setup``, with
    ``p["compression"]``)."""
    from repro_torch.models.api import get_model
    from repro_torch.training.train_state import mesh_setup

    api = get_model(p["cfg"])
    return (api, *mesh_setup(api, mesh, p.get("compression", "none")))


def _numpy(tree):
    from repro_torch.models.stack import tree_map
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def task_train(mesh, p):
    """``p["steps"]`` sharded train steps from the global params on this
    rank's batch rows: the losses and grad norms, the collectives of the
    second step, the gathered params after (rank 0), and with int8-EF
    the first step's pod gradients, the cross-pod mean and the residuals
    (gathered inside the pod) and the gathered ef_err after."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import RunConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import gather_tree
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.stack import tree_map
    from repro_torch.training.data import device_batch
    from repro_torch.training.train_state import (gather_state,
                                                  initial_state, local_batch,
                                                  make_grad_fn,
                                                  make_train_step)

    api, ctx, rules, specs = _train_setup(mesh, p)
    run = RunConfig(grad_compression=p.get("compression", "none"),
                    **p["run"])
    state = initial_state(params_from_numpy(p["params"], device="cpu"), run,
                          mesh, specs)
    batches = [local_batch(device_batch(b, "cpu"), rules, mesh)
               for b in p["batches"]]
    out = {}
    if specs.ef_err is not None:
        grads_fn = make_grad_fn(api, ctx, run, mesh=mesh)
        loss, g = grads_fn(state.params, batches[0])
        err = tree_map(lambda e: e[0], state.ef_err)
        mean, new_err = C.crosspod_psum_int8(g, err, mesh)
        out["int8"] = dict(
            loss=float(loss), grads=_numpy(gather_tree(g, specs.params, mesh)),
            mean=_numpy(gather_tree(mean, specs.params, mesh)),
            err=_numpy(gather_tree(new_err, specs.params, mesh)))
    step = make_train_step(api, ctx, run, mesh=mesh)
    losses, norms = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            with CostCounter() as cc:
                state, met = step(state, batch)
            out["collectives"] = cc.collectives.counts
        else:
            state, met = step(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    whole = gather_state(state, specs, mesh)
    out.update(losses=losses, norms=norms)
    if mesh.axes_coord(mesh.axis_names) == 0:
        out["params"] = _numpy(whole.params)
        if whole.ef_err is not None:
            out["ef_err"] = _numpy(whole.ef_err)
    return out


def layer_fn(name: str):
    """``fn(ctx, params, inputs) -> output`` of one train layer, on the
    params of the whole smoke model (layer 0's where it is a block's).
    The recurrent layers take the rows' whole-head states (``state`` /
    ``ssm_state``), run on the heads this rank holds, and return (B, -1):
    the output and each row's final state per head against a fixed
    probe, gathered over the heads."""
    import torch

    from repro_torch.models import hybrid, ssm
    from repro_torch.models import layers as L
    from repro_torch.models.stack import tree_map

    def first(params, part):
        return {k: v[0] for k, v in params["layers"][part].items()}

    def layer0(params):
        return tree_map(lambda t: t[0], params["layers"])

    def probe(ctx, state, h):
        w = torch.linspace(-1.0, 1.0, state[0, 0].numel()).reshape(
            state.shape[2:])
        z = (state * w).flatten(2).sum(-1)
        if z.shape[1] != h:
            z = L.gather_cut(ctx, [z], [True])[0]
        return z

    def rows(*ys):
        return torch.cat([y.flatten(1) for y in ys], 1)

    def own(state, heads):
        lo, n = heads
        return state[:, lo:lo + n]

    def time_mix(ctx, p, i):
        tm = first(p, "tm")
        out, s_end, _ = ssm.time_mix_chunked(
            ctx, tm, i["x"], own(i["state"], ssm.state_heads(ctx, tm)),
            return_state=True, valid=i["valid"])
        return rows(out, probe(ctx, s_end, i["state"].shape[1]))

    def time_mix_step(ctx, p, i):
        tm = first(p, "tm")
        out, new, _ = ssm.time_mix_step(
            ctx, tm, i["x"][:, 0],
            own(i["state"], ssm.state_heads(ctx, tm)), i["x"][:, 1])
        return rows(out, probe(ctx, new, i["state"].shape[1]))

    def ssm_chunked(ctx, p, i):
        sp = first(p, "ssm")
        out, s_end = hybrid.ssm_chunked(
            ctx, sp, i["x"],
            own(i["ssm_state"], hybrid.state_heads(ctx, sp)),
            return_state=True, valid=i["valid"])
        return rows(out, probe(ctx, s_end, i["ssm_state"].shape[1]))

    def ssm_step(ctx, p, i):
        sp = first(p, "ssm")
        out, new = hybrid.ssm_step(
            ctx, sp, i["x"][:, 0],
            own(i["ssm_state"], hybrid.state_heads(ctx, sp)))
        return rows(out, probe(ctx, new, i["ssm_state"].shape[1]))

    return {
        "attention": lambda ctx, p, i: L.attention_block(
            ctx, first(p, "attn"), i["x"], i["positions"]),
        "mlp": lambda ctx, p, i: L.mlp_block(ctx, first(p, "mlp"), i["x"]),
        "embed": lambda ctx, p, i: L.embed(ctx, p, i["tokens"]),
        "loss": lambda ctx, p, i: L.cross_entropy_loss(
            ctx, p, i["x"], i["labels"]),
        "time_mix": time_mix,
        "time_mix_step": time_mix_step,
        "channel_mix": lambda ctx, p, i: rows(ssm.channel_mix(
            ctx, first(p, "cm"), i["x"])),
        "channel_mix_step": lambda ctx, p, i: ssm.channel_mix(
            ctx, first(p, "cm"), i["x"][:, 0], last_x=i["x"][:, 1]),
        "rwkv_block": lambda ctx, p, i: rows(ssm.block(
            ctx, layer0(p), i["x"])[0]),
        "ssm_chunked": ssm_chunked,
        "ssm_step": ssm_step,
        "hybrid_block": lambda ctx, p, i: rows(hybrid.block(
            ctx, layer0(p), i["x"], i["positions"])[0]),
    }[name]


def task_layer(mesh, p):
    """Each train layer of ``p["layers"]`` on this rank's param shards
    (the FSDP dims gathered on use) and batch rows: its output, and the
    input and param gradients of ``sum(output * p["ct"])`` (the loss: of
    the loss), each gathered to its global shape (rank 0)."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import gather_tree, local_shard, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.stack import tree_map
    from repro_torch.distributed.sharding import fsdp_dim as _fsdp_dim

    api, ctx, rules, specs = _train_setup(mesh, p)
    axes = rules.act_batch_axes
    rows_spec = P_rows(axes)
    out = {}
    for name in p["layers"]:
        params = shard_tree(params_from_numpy(p["params"], device="cpu"),
                            specs.params, mesh)
        params = tree_map(lambda t: t.requires_grad_(True), params)
        rows = {k: local_shard(torch.from_numpy(v), rows_spec, mesh)
                for k, v in p["inputs"].items()}
        rows["x"] = rows["x"].clone().requires_grad_(True)
        whole = tree_map(
            lambda t, s: t if _fsdp_dim(s, "model") is None
            else C.fsdp_gather([t], [_fsdp_dim(s, "model")], mesh,
                               rules.fsdp_axes)[0], params, specs.params)
        y = layer_fn(name)(ctx, whole, rows)
        if name == "loss":
            y = T.global_mean(ctx, y)
            y.backward()
        else:
            ct = p["ct"][name] if isinstance(p["ct"], dict) else p["ct"]
            ct = local_shard(torch.from_numpy(ct), rows_spec, mesh)
            (y * ct).sum().backward()
        grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                         else t.grad, params)
        # leaves no FSDP axis cuts: each rank holds its rows' part
        grads = tree_map(
            lambda g, s: C.all_reduce_flat([g], mesh, axes)[0]
            if _fsdp_dim(s, "model") is None else g, grads, specs.params)
        dx = rows["x"].grad
        out[name] = dict(
            grads=_numpy(gather_tree(grads, specs.params, mesh)),
            out=(y.detach().numpy() if y.dim() == 0 else gather_tree(
                y.detach(), rows_spec, mesh).numpy()),
            dx=None if dx is None else gather_tree(dx, rows_spec,
                                                   mesh).numpy())
    return out if mesh.axes_coord(mesh.axis_names) == 0 else None


def P_rows(axes):
    """Dim 0 over the batch axes."""
    from repro_torch.distributed import P
    return P(axes)


def task_int8(mesh, p):
    """``crosspod_psum_int8`` on this rank's shards (``p["specs"]``) of
    its pod's gradient and residual leaves: the mean and the new
    residuals, gathered inside the pod; and whether the boxed form
    (``crosspod_allreduce_int8``, a leading pod axis of size 1) gives
    the same bits."""
    import torch

    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import gather_tree, shard_tree

    pod = mesh.coord("pod")
    grads, errs = (shard_tree({k: torch.from_numpy(v) for k, v in
                               p[name][pod].items()}, p["specs"], mesh)
                   for name in ("grads", "errs"))
    mean, err = C.crosspod_psum_int8(grads, errs, mesh)
    box = {k: v[None] for k, v in grads.items()}
    bmean, berr = C.crosspod_allreduce_int8(
        mesh, box, {k: v[None] for k, v in errs.items()})
    boxed = all(torch.equal(bmean[k][0], mean[k])
                and torch.equal(berr[k][0], err[k]) for k in grads)
    return dict(mean=_numpy(gather_tree(mean, p["specs"], mesh)),
                err=_numpy(gather_tree(err, p["specs"], mesh)), boxed=boxed)


def task_ckpt(mesh, p):
    """The training loop under a mesh with checkpoints in ``p["dir"]``:
    ``"run"`` trains to ``p["steps"]`` (preempted after
    ``p["preempt_after"]`` steps, when given, then resumed in a second
    loop); ``"restore"`` only loads the latest step. Returns the global
    state (rank 0) and the loops' results."""
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.loop import train_loop
    from repro_torch.training.train_state import (gather_state,
                                                  initial_state,
                                                  make_train_step)

    api, ctx, rules, specs = _train_setup(mesh, p)
    run = RunConfig(checkpoint_dir=p["dir"], checkpoint_every=2,
                    total_steps=p["steps"], **p["run"])

    def init_state():
        return initial_state(params_from_numpy(p["params"], device="cpu"),
                             run, mesh, specs)

    results = []
    if p["mode"] == "restore":
        ckpt = CheckpointManager(p["dir"], mesh=mesh, specs=specs)
        state = ckpt.load_state(ckpt.latest_step(), init_state())
    else:
        step = make_train_step(api, ctx, run, mesh=mesh)
        kw = dict(model_cfg=p["cfg"], shape=ShapeConfig("t", 32, 8, "train"),
                  run=run, train_step=step, device="cpu", mesh=mesh,
                  rules=rules, specs=specs, install_signals=False,
                  log_every=0)
        res = train_loop(init_state=init_state,
                         preempt_after=p.get("preempt_after"), **kw)
        results.append((res.final_step, res.preempted, res.restored_from,
                        res.losses))
        if res.preempted:
            res = train_loop(init_state=init_state, **kw)
            results.append((res.final_step, res.preempted,
                            res.restored_from, res.losses))
        ckpt = CheckpointManager(p["dir"], mesh=mesh, specs=specs)
        state = ckpt.load_state(ckpt.latest_step(), init_state())
    whole = gather_state(state, specs, mesh)
    if mesh.axes_coord(mesh.axis_names) != 0:
        return None
    return dict(results=results, step=int(whole.step),
                state={f: _numpy(getattr(whole, f))
                       for f in ("params", "m", "v")})


# ---------------------------------------------------------------------------
# The pipeline and the MoE / encoder-decoder meshes (tests/test_torch_
# pipeline.py, tests/test_torch_moe_mesh.py)
# ---------------------------------------------------------------------------


def task_pipeline(mesh, p):
    """``pipeline_forward`` over ``pod``: JAX's toy stack (4 layers adding
    their weight) and the smoke model's dense blocks, each rank holding
    its stage's slice of the :func:`split_stages` tree; the outputs,
    this rank's stage gradients of ``sum(out * ct)`` and the gradient of
    the microbatches, and the collectives of the call (forward and
    backward)."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.distributed import P, shard_tree
    from repro_torch.distributed import pipeline as PP
    from repro_torch.models import stack
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import LayerCtx
    from repro_torch.models.stack import tree_map

    def run(layers, xs, stage_fn, ct):
        staged = PP.split_stages(layers, mesh.size("pod"))
        local = shard_tree(staged, tree_map(lambda _: P("pod"), staged),
                           mesh)
        local = tree_map(lambda t: t.requires_grad_(True), local)
        xs = xs.clone().requires_grad_(True)
        with CostCounter() as cc:
            out = PP.pipeline_forward(mesh, local, xs, stage_fn)
            (out * ct).sum().backward()
        return dict(out=out.detach().numpy(), xs_grad=xs.grad.numpy(),
                    grads=_numpy(tree_map(lambda t: t.grad[0], local)),
                    collectives=cc.collectives.counts)

    def toy_stage(sp, x):
        for i in range(sp["w"].shape[0]):
            x = x + sp["w"][i]
        return x

    toy = {"w": torch.arange(4, dtype=torch.float32).reshape(4, 1) + 1.0}
    out = {"toy": run(toy, torch.zeros(4, 2, 1), toy_stage,
                      torch.ones(4, 2, 1))}
    ctx = LayerCtx(p["cfg"], DEFAULT_PLAN.with_overrides(backend="torch"))
    params = params_from_numpy(p["params"], device="cpu")
    xs = torch.from_numpy(p["xs"])
    positions = torch.arange(xs.shape[2])[None].expand(xs.shape[1], -1)

    def dense_stage(sp, x):
        return stack.run_stack(sp, x, lambda p_i, xx: T.block(
            ctx, p_i, xx, positions)[0])

    out["dense"] = run(params["layers"], xs, dense_stage,
                       torch.from_numpy(p["ct"]))
    return out


@contextlib.contextmanager
def routes_recorded():
    """The MoE routing choices (each ``moe.route`` call's experts, as
    numpy) made inside, in call order."""
    from repro_torch.models import moe

    routes, route = [], moe.route

    def recording(*a, **kw):
        res = route(*a, **kw)
        routes.append(res[2].numpy().copy())
        return res

    moe.route = recording
    try:
        yield routes
    finally:
        moe.route = route


def task_jobs(mesh, p):
    """Each job of ``p["jobs"]`` on a mesh of its own over this world:
    ``"grads"``, one loss and its gradients through the sharded train
    step's ``make_grad_fn`` (the gradients gathered, rank 0), the MoE
    routing choices of the forward pass (each rank's, layer by layer) and
    the collectives (CostCounter); ``"train"``, :func:`task_train`;
    ``"layer"``, :func:`task_layer`."""
    import dataclasses

    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig, RunConfig
    from repro_torch.distributed import gather_tree, shard_tree
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training.data import device_batch
    from repro_torch.training.train_state import local_batch, make_grad_fn

    out = []
    for job in p["jobs"]:
        shape, names = job["mesh"]
        jmesh = make_mesh_from_config(MeshConfig(shape, names),
                                      device="cpu")
        if job["kind"] in ("train", "layer"):
            out.append(TASKS[job["kind"]](jmesh, job))
            continue
        api, ctx, rules, specs = _train_setup(jmesh, job)
        if job.get("moe_groups"):
            ctx = dataclasses.replace(ctx, moe_groups=job["moe_groups"])
        grads_fn = make_grad_fn(api, ctx, RunConfig(**job["run"]),
                                mesh=jmesh)
        params = shard_tree(params_from_numpy(job["params"], device="cpu"),
                            specs.params, jmesh)
        batch = local_batch(device_batch(job["batch"], "cpu"), rules, jmesh)
        with routes_recorded() as routes, CostCounter() as cc:
            loss, grads = grads_fn(params, batch)
        whole = gather_tree(grads, specs.params, jmesh)
        n = api.cfg.num_layers
        first = mesh.axes_coord(mesh.axis_names) == 0
        out.append(dict(loss=float(loss), routes=routes[:n],
                        collectives=cc.collectives.counts,
                        grads=_numpy(whole) if first else None))
    return out


# ---------------------------------------------------------------------------
# Serving on a mesh (tests/test_torch_mesh_dryrun.py)
# ---------------------------------------------------------------------------


def task_serve(mesh, p):
    """Each job of ``p["jobs"]``: the smoke model on a mesh of its own over
    this world, ``serving/sharded.py``'s prefill of this rank's rows into
    its slice of a zero cache, then teacher-forced decode ticks (the
    job's ``decode_tokens``); returns (rank 0) every step's logits and
    the cache after the last, gathered whole, and (every rank) the
    collectives of the prefill and of each tick."""
    import torch

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import P, gather_tree, local_shard, shard_tree
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.api import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.serving.sharded import (cache_specs, local_zeros,
                                             serve_rules, sharded_serve)

    out = []
    for job in p["jobs"]:
        shape, names = job["mesh"]
        jmesh = make_mesh_from_config(MeshConfig(shape, names), device="cpu")
        api = get_model(job["cfg"])
        rules = serve_rules(jmesh, fsdp_params=job.get("fsdp", False))
        srv = sharded_serve(api, make_plan("torch", fused_ffn=False,
                                           decode_fusion=job["fusion"]),
                            jmesh, rules)
        params = shard_tree(params_from_numpy(job["params"], device="cpu"),
                            srv.param_specs, jmesh)
        b = job["tokens"].shape[0]
        whole = api.init_cache(DenseLayout(b, job["max_seq"]), device="meta")
        cspecs = cache_specs(whole, rules)
        cache = local_zeros(whole, cspecs, jmesh, device="cpu")
        rows = P(rules.batch_axes)

        def mine(x):
            return local_shard(torch.from_numpy(x), rows, jmesh).contiguous()

        def gathered(x):
            return gather_tree(x, rows, jmesh).numpy()

        lengths = mine(job["lengths"])
        counts, logits = [], []
        with torch.no_grad():
            with CostCounter() as cc:
                lg, cache = srv.prefill(params, mine(job["tokens"]), lengths,
                                        cache, **{k: mine(v) for k, v in
                                                  job["extra"].items()})
            counts.append(cc.collectives.counts)
            logits.append(gathered(lg))
            for toks in job["decode_tokens"]:
                with CostCounter() as cc:
                    lg, cache = srv.decode_step(params, mine(toks), cache,
                                                lengths)
                counts.append(cc.collectives.counts)
                logits.append(gathered(lg))
                lengths = lengths + 1
        glob = gather_tree(cache, cspecs, jmesh)
        first = jmesh.axes_coord(jmesh.axis_names) == 0
        out.append(dict(counts=counts, logits=logits if first else None,
                        cache=_numpy(glob) if first else None))
    return out


TASKS = {"combine": task_combine, "attention": task_attention,
         "decode": task_decode, "train": task_train, "layer": task_layer,
         "ckpt": task_ckpt, "int8": task_int8,
         "pipeline": task_pipeline, "jobs": task_jobs, "serve": task_serve}
