"""The MoE, encoder-decoder and VLM families on a mesh (the sharded
trainer's TP and data paths for them), against the port on one rank and
the JAX package on the CPU.

Two gloo ranks (``tests/_torch_dist.py``, one spawn for every job) run
the smoke dbrx-132b, whisper-tiny and internvl2-76b in f32 with the JAX package's
``init_params(PRNGKey(0))`` and ``make_synthetic_batch`` batches:

  * MoE at (data, model) = (2, 1) with ``moe_groups`` 2 (each rank routes
    its own group: the JAX package's ``_moe_block_manual``) and 1 (the
    group spans both ranks' rows: the JAX package's GSPMD fallback), and
    at (1, 2), the experts' F over ``model``: one loss and its gradients
    through the sharded step's ``make_grad_fn``;
  * whisper-tiny at (1, 2) (self- and cross-attention and the MLPs
    tensor-parallel) the same way, and at (pod, data, model) = (2, 1, 1)
    with int8-EF, 3 train steps;
  * internvl2-76b (the VLM family: the dense blocks behind its stub
    vision tokens) at (1, 2), one loss and its gradients.

Tolerances (the JAX package's own for its manual dispatch test,
``tests/test_distributed.py::test_manual_moe_dispatch_matches_gspmd``):
losses rtol 2e-3, each gradient leaf rtol 5e-2 / atol 5e-3, against the
port's one-rank run and the JAX package's single-device ``value_and_
grad`` at the same ``moe_groups``, and, where the mesh routes the same
groups as one rank (the fallback, TP), each leaf within 1e-5 of its
largest element (the manual path's aux is the mean of the ranks' own,
as the JAX package's ``pmean`` takes it: it is held that tightly to the
JAX package's own manual path instead); int8-EF losses as
``test_torch_sharded_train.py`` holds them (the first 1e-6 of the
one-rank step's, the later 3e-2). Routing choices that differ from the
one-rank run (a tie flipped by another rounding) are counted and
printed. The manual path is also held to the JAX package's own
``_moe_block_manual`` on a (2, 1) mesh of two host devices (a
subprocess, as the JAX package's tests run it).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro import configs as jconfigs
from repro.config import ShapeConfig as JShapeConfig
from repro.models.api import get_model as jget_model
from repro.models.api import make_synthetic_batch
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs
from repro_torch.config import RunConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map
from repro_torch.training.data import device_batch
from repro_torch.training.train_state import TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32")
RUN = dict(learning_rate=1e-3, warmup_steps=1)
DM = ("data", "model")
PDM = ("pod", "data", "model")
LEAF = dict(rtol=5e-2, atol=5e-3)
# (seq, batch); internvl2's seq counts its seq / 4 stub vision tokens
SHAPE = {"dbrx-132b": (64, 4), "whisper-tiny": (32, 8),
         "internvl2-76b": (32, 4)}

# job name -> (arch, mesh, moe_groups)
GRAD_JOBS = {
    "moe_manual": ("dbrx-132b", ((2, 1), DM), 2),
    "moe_fallback": ("dbrx-132b", ((2, 1), DM), 1),
    "moe_tp": ("dbrx-132b", ((1, 2), DM), 1),
    "encdec_tp": ("whisper-tiny", ((1, 2), DM), 1),
    "vlm_tp": ("internvl2-76b", ((1, 2), DM), 1),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **F32),
            dataclasses.replace(configs.smoke(configs.get(arch)), **F32))


def _inputs(arch):
    """(JAX params, the batch) as numpy: the JAX package's init and its
    synthetic batch."""
    if arch not in _CACHE:
        jcfg, _ = _cfgs(arch)
        jp = jax.jit(jget_model(jcfg).init_params)(jax.random.PRNGKey(0))
        seq, b = SHAPE[arch]
        batch = make_synthetic_batch(jcfg, JShapeConfig("t", seq, b, "train"),
                                     jax.random.PRNGKey(1))
        _CACHE[arch] = (jax.tree.map(np.asarray, jax.device_get(jp)),
                        {k: np.array(v) if k in ("tokens", "labels")
                         else np.asarray(v, np.float32)   # bf16 frames
                         for k, v in batch.items()})
    return _CACHE[arch]


def _ranks(tmp_path_factory):
    if "ranks" not in _CACHE:
        jobs = []
        for arch, mesh, groups in GRAD_JOBS.values():
            params, batch = _inputs(arch)
            jobs.append(dict(kind="grads", cfg=_cfgs(arch)[1], params=params,
                             batch=batch, mesh=mesh, moe_groups=groups,
                             run=RUN))
        params, batch = _inputs("whisper-tiny")
        jobs.append(dict(kind="train", cfg=_cfgs("whisper-tiny")[1],
                         params=params, batches=[batch] * 3, run=RUN,
                         compression="int8_ef", mesh=((2, 1, 1), PDM)))
        res = _torch_dist.run("jobs", 2, tmp_path_factory.mktemp("jobs"),
                              dict(jobs=jobs), timeout=240)
        _CACHE["ranks"] = {name: [r[i] for r in res]
                           for i, name in enumerate([*GRAD_JOBS, "int8"])}
    return _CACHE["ranks"]


def _port_one_rank(arch, groups):
    """The port's unsharded loss, gradients and routing choices."""
    key = ("port", arch, groups)
    if key not in _CACHE:
        params, batch = _inputs(arch)
        cfg = _cfgs(arch)[1]
        ctx = LayerCtx(cfg, DEFAULT_PLAN.with_overrides(backend="torch"),
                       moe_groups=groups)
        leaves = tree_map(lambda t: t.requires_grad_(True),
                          params_from_numpy(params, device="cpu"))
        with _torch_dist.routes_recorded() as routes:
            loss = get_model(cfg).train_loss(ctx, leaves,
                                             device_batch(batch, "cpu"))
        loss.backward()
        _CACHE[key] = (float(loss.detach()), tree_map(lambda t: t.grad.numpy(),
                                             leaves),
                       routes[:cfg.num_layers])
    return _CACHE[key]


def _jax_one_device(arch, groups):
    """The JAX package's single-device loss and gradients."""
    key = ("jax", arch, groups)
    if key not in _CACHE:
        params, batch = _inputs(arch)
        jcfg = _cfgs(arch)[0]
        api = jget_model(jcfg)
        ctx = JLayerCtx(cfg=jcfg, moe_groups=groups)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.train_loss(ctx, p, b)))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
        _CACHE[key] = (float(loss), jax.tree.map(np.asarray, grads))
    return _CACHE[key]


def _leaves_close(got, want):
    for (path, g), w in zip(_flat(got), _walk(want, got)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **LEAF,
                                   err_msg="/".join(path))


def _leaves_rel(got, want, rel):
    """Each leaf within ``rel`` of the largest element of ``want``'s."""
    for (path, g), w in zip(_flat(got), _walk(want, got)):
        w = np.asarray(w, np.float32)
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), ("/".join(path),
                                                          err)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _walk(ref, like):
    """``ref``'s leaves at ``like``'s paths, in ``like``'s order."""
    for path, _ in _flat(like):
        leaf = ref
        for k in path:
            leaf = leaf[k]
        yield leaf


def _routes(job, res):
    """The ranks' routing choices layer by layer, as the one-rank run
    lays them out: the manual path's groups are the ranks' own (rank
    order), every other run routes every group on every rank."""
    if job == "moe_manual":
        return [np.concatenate([r["routes"][i] for r in res])
                for i in range(len(res[0]["routes"]))]
    return res[0]["routes"]


@pytest.mark.parametrize("job", list(GRAD_JOBS))
def test_mesh_grads_match_one_rank_and_jax(job, tmp_path_factory):
    """One loss and its gradients on the mesh: every rank's loss alike
    and within rtol 2e-3 of the port's one-rank loss and the JAX
    package's, each gathered gradient leaf within the JAX test's leaf
    tolerance of both; the routing choices that differ from the one-rank
    run counted (and none on the tensor-parallel rank pair that would
    disagree with its partner)."""
    arch, _, groups = GRAD_JOBS[job]
    res = _ranks(tmp_path_factory)[job]
    loss, grads, routes = _port_one_rank(arch, groups)
    jloss, jgrads = _jax_one_device(arch, groups)
    assert res[0]["loss"] == res[1]["loss"]
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=2e-3)
    np.testing.assert_allclose(res[0]["loss"], jloss, rtol=2e-3)
    _leaves_close(res[0]["grads"], grads)
    _leaves_close(res[0]["grads"], jgrads)
    if job != "moe_manual":
        # the same routing groups as one rank: only the f32 sums' order
        # differs (the manual path's aux is the mean of the ranks' own,
        # the JAX package's pmean, not the one-rank aux: held tightly to
        # the JAX package's _moe_block_manual below)
        _leaves_rel(res[0]["grads"], grads, 1e-5)
        _leaves_rel(res[0]["grads"], jgrads, 1e-5)
    if routes:
        got = _routes(job, res)
        flips = sum(int(np.sum(g != w)) for g, w in zip(got, routes))
        total = sum(w.size for w in routes)
        print(f"{job}: {flips} of {total} routing choices differ from the "
              "one-rank run")
        assert flips <= total // 100
        if job == "moe_tp":
            for a, b in zip(res[0]["routes"], res[1]["routes"]):
                np.testing.assert_array_equal(a, b)


# the collectives of one loss and its gradients (make_grad_fn; remat on,
# 2 layers, 8 loss chunks, f32 params: one dtype group), derived from the
# code. (2, 1): the FSDP all-gather and its reduce-scatter (an
# all-reduce), the loss's batch mean, the replicated leaves' batch sum;
# the fallback adds each layer's activation gather (forward, again in the
# remat recompute) and its reduce-scatter. (1, 2): the embedding's
# all-reduce; per layer forward wo's and the experts' combine's
# all-reduce, backward the attention's copy, the slots' copy and the
# routing weights' copy, recomputed wo's (the recompute stops at the last
# saved tensor: the combine's all-reduce feeds none); per loss chunk two
# forward, two recomputed, one backward. Whisper (1, 2): the encoder's
# layers (no remat) 4 each (wo, w_down forward, two copies backward),
# the decoder's self-attention 3 and MLP 2 as the dense family's, its
# cross-attention 3 (wo forward and recomputed, the copy of the queries'
# input backward) plus the copy of the encoder output into each layer's
# cross keys and values (backward). InternVL2 (1, 2), the dense
# family's blocks behind the stub vision tokens: the embedding's
# all-reduce, per layer 5 (wo and w_down forward, the two copies
# backward, wo recomputed), per loss chunk 5.
COLLECTIVES = {
    "moe_manual": {"all-gather": 1, "all-reduce": 3},
    "moe_fallback": {"all-gather": 1 + 2 * 2, "all-reduce": 3 + 2},
    "moe_tp": {"all-reduce": 1 + 6 * 2 + 5 * 8},
    "encdec_tp": {"all-reduce": 1 + 4 * 2 + 9 * 2 + 5 * 8},
    "vlm_tp": {"all-reduce": 1 + 5 * 2 + 5 * 8},
}


@pytest.mark.parametrize("job", list(GRAD_JOBS))
def test_mesh_collectives_as_counted(job, tmp_path_factory):
    res = _ranks(tmp_path_factory)[job]
    for r in res:
        assert r["collectives"] == COLLECTIVES[job], r["collectives"]


def test_manual_dispatch_matches_jax_moe_block_manual(tmp_path,
                                                      tmp_path_factory):
    """The port's (2, 1) manual run against the JAX package's own
    ``_moe_block_manual`` (``shard_map`` over ``data`` on two host
    devices, ``moe_groups`` 2): loss rtol 2e-3, leaves the JAX test's
    tolerance and within 1e-5 of each leaf's largest element (the same
    aux: the mean of the ranks' own)."""
    params, batch = _inputs("dbrx-132b")
    np.savez(tmp_path / "in.npz", **{"/".join(k): v for k, v in
                                     _flat({"p": params, "b": batch})})
    code = textwrap.dedent(f"""
        import dataclasses, jax, jax.numpy as jnp, numpy as np
        from repro import configs
        from repro.config import MeshConfig
        from repro.distributed.sharding import make_rules, make_shard_fn
        from repro.models import moe
        from repro.models.api import get_model
        from repro.models.layers import LayerCtx
        cfg = dataclasses.replace(configs.smoke(configs.get("dbrx-132b")),
                                  param_dtype="float32",
                                  activation_dtype="float32")
        flat = dict(np.load({str(tmp_path / 'in.npz')!r}))
        tree = {{}}
        for k, v in flat.items():
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {{}})
            node[last] = jnp.asarray(v)
        calls = []
        real = moe._moe_block_manual
        def spy(*a, **kw):
            out = real(*a, **kw)
            calls.append(out is not None)
            return out
        moe._moe_block_manual = spy
        mesh_cfg = MeshConfig((2, 1), ("data", "model"))
        # the classic Mesh: Auto axes, which with_sharding_constraint
        # needs (jax.make_mesh now makes Explicit ones)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                                 ("data", "model"))
        rules = make_rules(mesh_cfg)
        ctx = LayerCtx(cfg=cfg, shard=make_shard_fn(mesh, rules), mesh=mesh,
                       rules=rules, moe_groups=2)
        api = get_model(cfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: api.train_loss(ctx, p, b)))(tree["p"], tree["b"])
        assert calls and all(calls), calls
        out = {{"loss": np.asarray(loss)}}
        for path, leaf in jax.tree_util.tree_leaves_with_path(grads):
            out["/".join(k.key for k in path)] = np.asarray(leaf)
        np.savez({str(tmp_path / 'out.npz')!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = dict(np.load(tmp_path / "out.npz"))
    res = _ranks(tmp_path_factory)["moe_manual"]
    np.testing.assert_allclose(res[0]["loss"], float(got.pop("loss")),
                               rtol=2e-3)
    flat = {"/".join(k): v for k, v in _flat(res[0]["grads"])}
    assert set(flat) == set(got)
    for k, v in flat.items():
        np.testing.assert_allclose(v, got[k], **LEAF, err_msg=k)
    _leaves_rel(flat, got, 1e-5)


def test_encdec_int8_ef_steps(tmp_path_factory):
    """whisper-tiny at (pod, data, model) = (2, 1, 1) with int8-EF, 3
    steps: the first loss 1e-6 of the port's one-rank step (the first
    update has lr 0) and within 2e-3 of the JAX package's loss, the
    later ones 3e-2, every rank's alike; ef_err has the JAX layout."""
    res = _ranks(tmp_path_factory)["int8"]
    params, batch = _inputs("whisper-tiny")
    cfg = _cfgs("whisper-tiny")[1]
    step = make_train_step(get_model(cfg), LayerCtx(
        cfg, DEFAULT_PLAN.with_overrides(backend="torch")), RunConfig(**RUN))
    state, losses = TrainState.create(params_from_numpy(params,
                                                        device="cpu")), []
    for _ in range(3):
        state, m = step(state, device_batch(batch, "cpu"))
        losses.append(float(m["loss"]))
    jloss, _ = _jax_one_device("whisper-tiny", 1)
    for r in res:
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["losses"][0], losses[0], rtol=1e-6)
        np.testing.assert_allclose(r["losses"][0], jloss, rtol=2e-3)
        np.testing.assert_allclose(r["losses"], losses, rtol=3e-2)
    for (k, e), (_, p) in zip(_flat(res[0]["ef_err"]),
                              _flat(res[0]["params"])):
        assert e.shape == (2, *p.shape), k


def test_cli_trains_moe_on_a_data_mesh(tmp_path):
    """``launch/train.py --devices 2 --mesh 2x1`` on the smoke dbrx-132b:
    the ranks route their own groups (moe_groups = the data size) and
    log 3 finite losses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--arch", "dbrx-132b", "--device", "cpu", "--devices", "2",
         "--mesh", "2x1", "--steps", "3", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--checkpoint-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(line.split()[3]) for line in res.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all(), res.stdout
    assert res.stdout.strip().splitlines()[-1].startswith(
        "finished at step 3 (restored_from=None, preempted=False)")


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_every_family_passes_the_mesh_setup(compression, tmp_path):
    """At (pod, data, model) = (2, 2, 2) every family's train step is set
    up as the CLI sets it up (``mesh_setup``, ``make_train_step``; a
    rank's mesh record, no process group: nothing is collective before
    the first step), with specs for every param leaf; no family is
    refused on a mesh any more. The dry run counts a cell on the pod
    meshes with either compression; int8-EF without a mesh is refused,
    naming the mesh it needs."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.stack import tree_leaves
    from repro_torch.training.train_state import mesh_setup

    mesh = Mesh((2, 2, 2), PDM, (0, 1, 0), groups={}, backend="gloo")
    families = {}
    for arch in configs.REGISTRY:
        cfg = configs.smoke(configs.get(arch))
        if cfg.family in families:
            continue
        families[cfg.family] = arch
        api = get_model(cfg)
        ctx, rules, specs = mesh_setup(api, mesh, compression)
        make_train_step(api, ctx, RunConfig(grad_compression=compression),
                        mesh=mesh)
        meta = api.init_params(device="meta")
        assert len(tree_leaves(specs.params)) == len(tree_leaves(meta))
        assert (specs.ef_err is not None) == (compression == "int8_ef")
    assert set(families) == {"dense", "moe", "encdec", "vlm", "ssm",
                             "hybrid"}, families
    cell = ["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--no-probes",
            "--out", str(tmp_path)]
    if compression == "none":
        assert dryrun.main(cell + ["--mesh", "single"]) == 0
    else:
        with pytest.raises(ValueError, match="--mesh multi"):
            dryrun.main(cell + ["--grad-compression", compression])
        assert dryrun.main(cell + ["--mesh", "multi", "--grad-compression",
                                   compression]) == 0
