"""Runs a task of ``tests/test_torch_distributed.py`` on W gloo ranks of the
port, each in a process of its own (``python -c``, a ``FileStore`` in the
test's ``tmp_path``), and returns each rank's result.

The ranks import neither JAX nor the JAX package: the test computes the
reference in its own process and hands the ranks numpy inputs. Each rank
joins a world of ``W`` on the CPU, builds the (data=1, model=W) mesh and
runs one task of :data:`TASKS`. The parent polls the ranks: a rank that
fails, or a run that passes its ``timeout``, kills every rank and fails
the test; the process group's own timeout is shorter than the test's, so
a rank left waiting in a collective raises instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(task: str, world: int, tmp_path, payload, timeout: float = 120.0):
    """``TASKS[task](mesh, payload)`` on ranks 0 .. world - 1; returns
    their results in rank order."""
    tmp = Path(tmp_path) / f"{task}_w{world}"
    tmp.mkdir(parents=True)
    (tmp / "payload.pkl").write_bytes(pickle.dumps(payload))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            code = (f"import _torch_dist as d; d.child({task!r}, {r}, "
                    f"{world}, {str(tmp)!r})")
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          env=env, cwd=str(ROOT),
                                          stdout=log, stderr=log))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(
            f"--- rank {r} (exit {c}):\n"
            + (tmp / f"rank{r}.log").read_text()[-3000:]
            for r, c in enumerate(codes))
        raise AssertionError(f"{task} on {world} gloo ranks failed or "
                             f"passed {timeout}s:\n{tails}")
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def child(task: str, rank: int, world: int, tmp: str) -> None:
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
        mesh = make_mesh_from_config(MeshConfig((1, world),
                                                ("data", "model")),
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


TASKS = {"combine": task_combine, "attention": task_attention,
         "decode": task_decode}
