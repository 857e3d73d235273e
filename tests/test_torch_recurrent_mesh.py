"""The recurrent families (RWKV6: ``ssm``, Hymba: ``hybrid``) on a mesh:
tensor parallelism over ``model`` and the int8-EF pod hop of the sharded
trainer, against the port on one rank and the JAX package on the CPU.

One spawn of two gloo ranks (``tests/_torch_dist.py``, task ``jobs``)
runs every job, in f32:

  * each layer at (data, model) = (1, 2) (one job at (1, 3), a spawn
    of three ranks) against the unsharded port:
    RWKV6's chunked time mix (a carried state, a ragged ``valid`` mask,
    T padded to the chunk), its recurrence step, the channel mix (a
    sequence and one token) and the block; Hymba's chunked SSM, its
    step and the block (windowed attention, the SSM, the MLP). The smoke
    configs hold whole heads a rank; rwkv6 at d 192 (3 heads of 64) and
    hymba at d 160 (5 / 5 attention heads, 5 SSM heads) cut a head at
    model 2, so their projections are gathered and the recurrence runs
    whole on every rank; hymba at d 192 on three model ranks holds whole
    heads a rank while its w_bc (2 x 16 columns) stays whole;
  * three train steps of each family at (1, 2) and at (pod, data,
    model) = (2, 1, 1) with int8-EF, from the JAX package's
    ``init_params(PRNGKey(0))`` on its ``make_synthetic_batch`` batch.

Tolerances: each layer's output, input gradient and every param's
gradient within LAYER_REL (1e-5) of the largest element of the unsharded
port's (f32 sums in another order; a_log's A_LOG_REL, 5e-5, as its
gradient cancels), the replicated leaves each rank cuts to its heads
(decay_B, decay_base, bonus_u, ln_out, a_log, d_skip) and the shared
w_bc among them; the (1, 2) steps' losses within STEP_RTOL
(2e-3, the JAX package's bound for its sharded step) of the JAX
single-device step and of the port's one-rank step, the params within
``conftest.TOL["float32"]`` of both; int8-EF as
``test_torch_sharded_train.py`` holds it: the first loss within 1e-6 of
the one-rank step's, the later ones 3e-2, the applied mean gradient the
JAX math's on the two pods' gradients to f32 rounding (1e-6 of each
leaf's largest) and each pod's residual bitwise.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from test_torch_sharded_train import (_flat, _jax_crosspod, _mean_close,
                                      _params_close)
from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.models.api import get_model as jget_model
from repro.models.api import make_synthetic_batch
from repro.models.layers import LayerCtx as JLayerCtx
from repro.training.train_state import TrainState as JTrainState
from repro.training.train_state import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.config import RunConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.models import hybrid, ssm
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map
from repro_torch.training.data import device_batch
from repro_torch.training.train_state import TrainState, make_train_step

F32 = dict(param_dtype="float32", activation_dtype="float32")
RUN = dict(learning_rate=1e-3, warmup_steps=1)
DM = ("data", "model")
PDM = ("pod", "data", "model")
LAYER_REL = 1e-5
# a_log's gradient sums terms of both signs up to ~1e3 times its
# smallest element (the chunked scan's exps): f32 products over half the
# heads reorder it by 1.3e-5 of its largest element (read at d 128)
A_LOG_REL = 5e-5
STEP_RTOL = 2e-3
EF_FIRST_RTOL = 1e-6
EF_RTOL = 3e-2
ARCHS = ("rwkv6-1.6b", "hymba-1.5b")

# layer jobs: name -> (arch, config changes, layers)
RWKV_LAYERS = ["time_mix", "time_mix_step", "channel_mix",
               "channel_mix_step", "rwkv_block"]
HYMBA_LAYERS = ["ssm_chunked", "ssm_step", "hybrid_block"]
LAYER_JOBS = {
    "rwkv6": ("rwkv6-1.6b", {}, RWKV_LAYERS),
    "rwkv6_d192": ("rwkv6-1.6b", dict(d_model=192), RWKV_LAYERS),
    "hymba": ("hymba-1.5b", {}, HYMBA_LAYERS),
    "hymba_d160": ("hymba-1.5b", dict(d_model=160, num_heads=5,
                                      num_kv_heads=5, head_dim=32),
                   HYMBA_LAYERS),
    # at model 3: whole heads a rank (6 / 3 attention, 6 SSM), but w_bc's
    # 2 x 16 columns do not divide, so it stays whole
    "hymba_d192_m3": ("hymba-1.5b", dict(d_model=192, num_heads=6,
                                         num_kv_heads=3, head_dim=32),
                      HYMBA_LAYERS),
}
LAYER_MESH = {"hymba_d192_m3": (1, 3)}
# the replicated leaves each rank uses on its own heads, and w_bc
CUT_LEAVES = {"rwkv6-1.6b": [("tm", "decay_A"), ("tm", "decay_B"),
                             ("tm", "decay_base"), ("tm", "bonus_u"),
                             ("tm", "ln_out"), ("tm", "mu_w")],
              "hymba-1.5b": [("ssm", "a_log"), ("ssm", "d_skip"),
                             ("ssm", "w_bc")]}
# train jobs: (arch, mesh, compression)
TRAIN_JOBS = [(arch, mesh, comp) for arch in ARCHS for mesh, comp in (
    (((1, 2), DM), "none"), (((2, 1, 1), PDM), "int8_ef"))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _layer_cfg(job):
    arch, changes, _ = LAYER_JOBS[job]
    return dataclasses.replace(configs.smoke(configs.get(arch)), **F32,
                               **changes)


def _layer_inputs(job):
    """(params, inputs, cotangents by layer) as numpy: the port's own
    init (seed 0), rows and states from a numpy seed."""
    if ("inputs", job) not in _CACHE:
        cfg = _layer_cfg(job)
        params = tree_map(lambda t: t.numpy(), get_model(cfg).init_params(
            torch.Generator().manual_seed(0), device="cpu"))
        rng = np.random.default_rng(7)
        b, t, d = 2, 80, cfg.d_model
        valid = np.ones((b, t), bool)
        valid[1, 70:] = False
        inputs = dict(
            x=rng.standard_normal((b, t, d)).astype(np.float32),
            positions=np.broadcast_to(np.arange(t), (b, t)).copy(),
            valid=valid)
        if cfg.family == "ssm":
            h, n = ssm._heads(cfg)
            inputs["state"] = (rng.standard_normal((b, h, n, n))
                               * 0.1).astype(np.float32)
        else:
            _, hm, n = hybrid._ssm_dims(cfg)
            inputs["ssm_state"] = (rng.standard_normal(
                (b, hm, hybrid.SSM_HEAD, n)) * 0.1).astype(np.float32)
        ct = {}
        for name in LAYER_JOBS[job][2]:
            y = _torch_dist.layer_fn(name)(
                LayerCtx(cfg, DEFAULT_PLAN.with_overrides(backend="torch")),
                params_from_numpy(params, device="cpu"),
                {k: torch.from_numpy(v) for k, v in inputs.items()})
            ct[name] = rng.standard_normal(tuple(y.shape)).astype(np.float32)
        _CACHE["inputs", job] = (params, inputs, ct)
    return _CACHE["inputs", job]


def _jcfg(arch):
    return dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **F32)


def _tcfg(arch):
    return dataclasses.replace(configs.smoke(configs.get(arch)), **F32)


def _jax_inputs(arch):
    """(the JAX package's params as numpy, its sharded-step test batch:
    8 x 32 from key 1)."""
    if ("jax", arch) not in _CACHE:
        jcfg = _jcfg(arch)
        jp = jax.jit(jget_model(jcfg).init_params)(jax.random.PRNGKey(0))
        batch = make_synthetic_batch(jcfg, JShapeConfig("t", 32, 8, "train"),
                                     jax.random.PRNGKey(1))
        _CACHE["jax", arch] = (jax.tree.map(np.asarray, jax.device_get(jp)),
                               {k: np.array(v) for k, v in batch.items()})
    return _CACHE["jax", arch]


def _layer_job(job):
    params, inputs, ct = _layer_inputs(job)
    return dict(kind="layer", cfg=_layer_cfg(job), params=params,
                inputs=inputs, ct=ct, layers=LAYER_JOBS[job][2],
                mesh=(LAYER_MESH.get(job, (1, 2)), DM))


def _ranks(tmp_path_factory):
    """Every job's results, rank by rank: one spawn of two ranks, one of
    three for the model-3 job."""
    if "ranks" not in _CACHE:
        names = [j for j in LAYER_JOBS if j not in LAYER_MESH]
        jobs = [_layer_job(j) for j in names]
        for arch, mesh, comp in TRAIN_JOBS:
            params, batch = _jax_inputs(arch)
            jobs.append(dict(kind="train", cfg=_tcfg(arch), params=params,
                             batches=[batch] * 3, run=RUN, compression=comp,
                             mesh=mesh))
            names.append((arch, mesh[0]))
        res = _torch_dist.run("jobs", 2, tmp_path_factory.mktemp("jobs"),
                              dict(jobs=jobs), timeout=240)
        out = {n: [r[i] for r in res] for i, n in enumerate(names)}
        for job, shape in LAYER_MESH.items():
            res = _torch_dist.run("jobs", shape[1],
                                  tmp_path_factory.mktemp("jobs"),
                                  dict(jobs=[_layer_job(job)]), timeout=240)
            out[job] = [r[0] for r in res]
        _CACHE["ranks"] = out
    return _CACHE["ranks"]


def _close_rel(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Each layer at (1, 2) against the unsharded port
# ---------------------------------------------------------------------------


def _layer_reference(job, name):
    """The unsharded port's output, input gradient and param gradients of
    ``sum(layer * ct)``."""
    params, inputs, ct = _layer_inputs(job)
    leaves = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(params, device="cpu"))
    rows = {k: torch.from_numpy(v) for k, v in inputs.items()}
    rows["x"] = rows["x"].clone().requires_grad_(True)
    y = _torch_dist.layer_fn(name)(
        LayerCtx(_layer_cfg(job), DEFAULT_PLAN.with_overrides(
            backend="torch")), leaves, rows)
    (y * torch.from_numpy(ct[name])).sum().backward()
    grads = tree_map(lambda t: np.zeros(t.shape, np.float32) if t.grad is None
                     else t.grad.numpy(), leaves)
    return y.detach().numpy(), rows["x"].grad.numpy(), grads


@pytest.mark.parametrize("job,layer", [(j, n) for j, (_, _, names) in
                                       LAYER_JOBS.items() for n in names])
def test_tp_layer_matches_unsharded(job, layer, tmp_path_factory):
    """The layer on two model ranks: its output, its input gradient and
    every param's gradient (gathered) within LAYER_REL of the largest
    element of the unsharded port's; the replicated leaves each rank cuts
    to its own heads (and Hymba's shared w_bc) are among them, and the
    ones the layer reads have a gradient that is not zero."""
    got = _ranks(tmp_path_factory)[job][0][layer]
    y, dx, grads = _layer_reference(job, layer)
    _close_rel(got["out"], y, LAYER_REL, "out")
    _close_rel(got["dx"], dx, LAYER_REL, "dx")
    for path, want in _flat(grads):
        rel = A_LOG_REL if path[-1] == "a_log" else LAYER_REL
        _close_rel(_at(got["grads"], path), want, rel, "/".join(path))
    arch = LAYER_JOBS[job][0]
    reads = {"time_mix": "tm", "time_mix_step": "tm", "rwkv_block": "tm",
             "ssm_chunked": "ssm", "ssm_step": "ssm", "hybrid_block": "ssm"}
    for part, leaf in CUT_LEAVES[arch]:
        if reads.get(layer) == part:
            assert np.abs(grads["layers"][part][leaf]).max() > 0, leaf


def test_heads_each_rank_holds():
    """Rank 1 of two model ranks holds its own half of the heads where
    every cut is on whole heads (the smoke configs), all of them where a
    cut splits a head (rwkv6 at d 192, hymba at d 160, whose w_dt is
    then whole); one device holds all of them."""
    mesh = SimpleNamespace(size=lambda axis: 2, coord=lambda axis: 1)
    rules = SimpleNamespace(model_axis="model")

    def layer(cfg, part, cut):
        tree = get_model(cfg).init_params(device="meta")["layers"][part]
        return {k: torch.empty(tuple(s // 2 if k in cut and i == 1 else s
                                     for i, s in enumerate(v.shape[1:])),
                               device="meta") for k, v in tree.items()}

    for job, want in (("rwkv6", (1, 1)), ("rwkv6_d192", (0, 3)),
                      ("hymba", (2, 2)), ("hymba_d160", (0, 5))):
        cfg = _layer_cfg(job)
        ctx = LayerCtx(cfg, mesh=mesh, rules=rules)
        if cfg.family == "ssm":
            tm = layer(cfg, "tm", ("w_r", "w_k", "w_v", "w_g"))
            assert ssm.state_heads(ctx, tm) == want
            assert ssm.state_heads(LayerCtx(cfg), tm) == (0, sum(want))
        else:
            _, hm, _ = hybrid._ssm_dims(cfg)
            sp = layer(cfg, "ssm", ("w_in", "w_gate", "w_bc")
                       + (("w_dt",) if hm % 2 == 0 else ()))
            assert hybrid.state_heads(ctx, sp) == want
            assert hybrid.state_heads(LayerCtx(cfg), sp) == (0, hm)


# ---------------------------------------------------------------------------
# Three train steps at (1, 2) and (2, 1, 1) int8-EF
# ---------------------------------------------------------------------------


def _reference_steps(arch):
    """3 steps of the JAX single-device step and of the port's unsharded
    step: (losses JAX, losses port, the port's final params, JAX's)."""
    if ("ref", arch) not in _CACHE:
        jparams, batch = _jax_inputs(arch)
        jcfg = _jcfg(arch)
        jstep = jax.jit(jmake_train_step(jget_model(jcfg),
                                         JLayerCtx(cfg=jcfg),
                                         JRunConfig(**RUN)))
        js = JTrainState.create(jax.tree.map(jnp.asarray, jparams))
        jl = []
        for _ in range(3):
            js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
            jl.append(float(m["loss"]))
        tcfg = _tcfg(arch)
        step = make_train_step(get_model(tcfg), LayerCtx(
            tcfg, DEFAULT_PLAN.with_overrides(backend="torch")),
            RunConfig(**RUN))
        ts = TrainState.create(params_from_numpy(jparams, device="cpu"))
        tl = []
        for _ in range(3):
            ts, m = step(ts, device_batch(batch, "cpu"))
            tl.append(float(m["loss"]))
        _CACHE["ref", arch] = (
            jl, tl, tree_map(lambda t: t.numpy(), ts.params),
            jax.tree.map(np.asarray, jax.device_get(js.params)))
    return _CACHE["ref", arch]


# collectives a step at the smoke configs (2 layers, 8 loss chunks; remat
# on), derived from the code: at (1, 2) the embedding's all-reduce, each
# loss chunk's five and the global norm, and a layer's 9 all-reduces and
# 3 all-gathers. RWKV6: w_o, the channel mix's w_v and its receptance's
# all-gather, each again in the recompute; backward the copies of the
# time mix's x, its mus and the decay LoRA's hidden, of the channel
# mix's x and mus, and the all-gather of the cut leaves' gradients.
# Hymba: attention 3 (wo, its copy, wo again), the MLP 2 (w_down, its
# copy), the SSM 4 + 3 (w_out and w_bc's all-gather, each again; the
# copy of x, w_bc's reduce-scatter; the all-gather of a_log / d_skip's
# gradients). At (2, 1, 1) int8-EF: the global norm, the loss's pod
# mean, the codes' and the scales' all-gathers.
COLLECTIVES = {(1, 2): {"all-reduce": 60, "all-gather": 6},
               (2, 1, 1): {"all-reduce": 2, "all-gather": 2}}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 1, 1)])
def test_mesh_collectives_as_counted(arch, shape, tmp_path_factory):
    """Each rank's collectives in a train step, by kind (CostCounter),
    equal the count derived from the code."""
    for r in _ranks(tmp_path_factory)[arch, shape]:
        assert r["collectives"] == COLLECTIVES[shape]


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_steps_match_single(arch, tmp_path_factory):
    """3 steps at (data, model) = (1, 2): the losses within STEP_RTOL of
    the JAX single-device step's and of the port's one-rank step's, the
    gathered params within TOL of both, both ranks' losses alike."""
    jl, tl, tparams, jparams = _reference_steps(arch)
    res = _ranks(tmp_path_factory)[arch, (1, 2)]
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=STEP_RTOL)
        np.testing.assert_allclose(r["losses"], tl, rtol=STEP_RTOL)
        assert r["losses"] == res[0]["losses"]
    _params_close(res[0]["params"], jparams)
    _params_close(res[0]["params"], tparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_ef_steps(arch, tmp_path_factory):
    """(pod, data, model) = (2, 1, 1) with int8-EF: the first loss the
    one-rank step's (within EF_FIRST_RTOL; the JAX step's within
    STEP_RTOL), the later ones within EF_RTOL; the mean gradient the step
    applies is the JAX math's on the two pods' gradients (to f32
    rounding), each pod's residual bitwise it; ef_err has the JAX layout
    (npods, ...)."""
    jl, tl, _, _ = _reference_steps(arch)
    res = _ranks(tmp_path_factory)[arch, (2, 1, 1)]
    flat = [{"/".join(k): v for k, v in _flat(r["int8"]["grads"])}
            for r in res]
    errs = [{k: np.zeros_like(v) for k, v in f.items()} for f in flat]
    mean, new = _jax_crosspod(flat, errs)
    for pod, r in enumerate(res):
        assert r["losses"] == res[0]["losses"]
        np.testing.assert_allclose(r["losses"][0], tl[0], rtol=EF_FIRST_RTOL)
        np.testing.assert_allclose(r["losses"][0], jl[0], rtol=STEP_RTOL)
        np.testing.assert_allclose(r["losses"], tl, rtol=EF_RTOL)
        for k, v in _flat(r["int8"]["mean"]):
            _mean_close(v, mean["/".join(k)])
        for k, v in _flat(r["int8"]["err"]):
            np.testing.assert_array_equal(v, new[pod]["/".join(k)])
    for (k, e), (_, p) in zip(_flat(res[0]["ef_err"]),
                              _flat(res[0]["params"])):
        assert e.shape == (2, *p.shape), k
