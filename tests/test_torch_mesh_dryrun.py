"""Slice 8b-3b of the port on the CPU: the dry run over the pod meshes and
tensor parallelism in every family's decode tick and prefill, against the
JAX package.

* Counts: one rank counted on the meta device under torch's fake process
  group (``launch/dryrun.count_mesh``) issues the collectives the gloo
  runs issue: the sharded train step at (data, model) = (2, 2), (1, 2),
  (2, 1) (``_torch_dist.TRAIN_COLLECTIVES``), and every family's TP
  prefill and decode tick at (1, 2) and (2, 2) (the gloo runs of the
  parity tests below; the smoke qwen2-0.5b's numbers also derived here).
* Specs: the port's param, cache and batch spec trees equal the JAX
  package's ``Rules`` trees leaf by leaf for every family's smoke config
  at (2, 2) and (2, 2, 2) (the JAX rules need no devices), and a rank's
  argument bytes in the dry run are each leaf's global bytes over its cut.
* Parity: every family's f32 smoke model prefills ragged prompts and
  decodes three teacher-forced ticks on gloo ranks at (1, 2) and (2, 2),
  params TP-cut (and FSDP-cut for the MoE family at (2, 2)), caches cut
  by ``Rules.cache_spec``: the logits within ``TOL["float32"]`` of the
  JAX package's unsharded ``prefill`` / ``decode_step``, the ranks' caches
  gathered within it of the JAX cache.
* The rules of the dry run: the serving budget, the fake world left
  behind by nobody.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist
from conftest import TOL
from repro import configs as jconfigs
from repro.config import MeshConfig as JMeshConfig
from repro.distributed.sharding import make_rules as jmake_rules
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs
from repro_torch.config import (MeshConfig, RunConfig, SHAPES, ShapeConfig,
                                SINGLE_POD)
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.serving.sharded import serve_rules

FAMILIES = ["qwen2-0.5b", "dbrx-132b", "rwkv6-1.6b", "hymba-1.5b",
            "whisper-tiny", "internvl2-76b"]
F32 = dict(param_dtype="float32", activation_dtype="float32")
DM = ("data", "model")
PDM = ("pod", "data", "model")
MESHES = {(1, 2): DM, (2, 2): DM}
# ragged prompts of up to 80 positions (Hymba's 64-slot smoke ring wraps;
# the VLM's 20 vision positions count in its lengths), 3 ticks after
B, PROMPT, MAX_SEQ, STEPS = 4, 80, 128, 3
LENGTHS = np.array([80, 33, 64, 27], np.int32)
RUN = dict(learning_rate=1e-3, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers a thread
    pool per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **F32),
            dataclasses.replace(configs.smoke(configs.get(arch)), **F32))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


_CACHE = {}


# ---------------------------------------------------------------------------
# The JAX package's unsharded prefill and decode ticks
# ---------------------------------------------------------------------------


def _reference(arch):
    """(the job's numpy inputs, the JAX logits of the prefill and of each
    tick, the JAX cache after them): params from ``init_params(PRNGKey
    (0))``, prompts and frames / vision prefix from numpy, greedy ticks."""
    if arch in _CACHE:
        return _CACHE[arch]
    jcfg, tcfg = _cfgs(arch)
    japi = jget_model(jcfg)
    jp = japi.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    extra, s = {}, PROMPT
    if jcfg.frontend == "vision":
        npfx = api.n_image_tokens(PROMPT)
        s = PROMPT - npfx
        extra["prefix_embeds"] = rng.standard_normal(
            (B, npfx, jcfg.d_model), dtype=np.float32)
    if jcfg.family == "encdec":
        from repro_torch.models.encdec import ENC_FRAMES_SERVE
        extra["frames"] = rng.standard_normal(
            (B, ENC_FRAMES_SERVE, jcfg.d_model), dtype=np.float32)
    tokens = rng.integers(1, jcfg.vocab_size, (B, s)).astype(np.int32)
    jctx = JLayerCtx(cfg=jcfg)
    lg, jc = japi.prefill(jctx, jp, jnp.asarray(tokens),
                          jnp.asarray(LENGTHS),
                          japi.init_cache(JDenseLayout(B, MAX_SEQ)),
                          **{k: jnp.asarray(v) for k, v in extra.items()})
    logits, ticks, lens = [np.asarray(lg)], [], jnp.asarray(LENGTHS)
    for _ in range(STEPS):
        tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        ticks.append(np.asarray(tok))
        lg, jc = japi.decode_step(jctx, jp, tok, jc, lens)
        logits.append(np.asarray(lg))
        lens = lens + 1
    job = dict(cfg=tcfg, params=jax.tree.map(np.asarray, jax.device_get(jp)),
               tokens=tokens, lengths=LENGTHS, extra=extra,
               decode_tokens=ticks, max_seq=MAX_SEQ, fusion="split")
    _CACHE[arch] = (job, logits, {k: np.asarray(v) for k, v in jc.items()})
    return _CACHE[arch]


# the extra jobs beside one a family and mesh: the fused granularity on
# TP-cut weights (its seams fall back to the split composition), and the
# MoE family with FSDP params (gathered over data before use)
EXTRA_JOBS = {(1, 2): [("qwen2-0.5b", dict(fusion="fused"))],
              (2, 2): [("dbrx-132b", dict(fsdp=True)),
                       ("qwen2-0.5b", dict(fsdp=True))]}


def _jobs(shape):
    jobs = [(arch, {}) for arch in FAMILIES] + EXTRA_JOBS[shape]
    return [(arch, kw, dict(_reference(arch)[0], mesh=(shape, MESHES[shape]),
                            **kw)) for arch, kw in jobs]


def _ranks(shape, tmp_path_factory):
    """The jobs of ``shape`` on gloo ranks: (arch, extra, rank 0's result,
    every rank's counts) a job."""
    key = ("ranks", shape)
    if key not in _CACHE:
        jobs = _jobs(shape)
        res = _torch_dist.run(
            "serve", int(np.prod(shape)), tmp_path_factory.mktemp("serve"),
            dict(jobs=[j for _, _, j in jobs]), timeout=300,
            mesh=(shape, MESHES[shape]))
        _CACHE[key] = [(arch, kw, res[0][i], [r[i]["counts"] for r in res])
                       for i, (arch, kw, _) in enumerate(jobs)]
    return _CACHE[key]


def _job_id(arch, kw):
    return "-".join([arch, *(f"{k}={v}" for k, v in kw.items())])


@pytest.mark.parametrize("shape", list(MESHES))
def test_tp_prefill_and_decode_match_the_unsharded_reference(
        shape, tmp_path_factory):
    """Every family (and the extra jobs) at ``shape``: the prefill's and
    each tick's logits within TOL["float32"] of the JAX package's
    unsharded ones, the cache gathered from the ranks within it of the
    JAX cache, and every rank issuing the same collectives."""
    for arch, kw, got, counts in _ranks(shape, tmp_path_factory):
        _, want_logits, want_cache = _reference(arch)
        tag = _job_id(arch, kw)
        assert len(got["logits"]) == STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            np.testing.assert_allclose(g, w, **TOL["float32"],
                                       err_msg=f"{tag} step {i}")
        assert set(got["cache"]) == set(want_cache), tag
        for name, w in want_cache.items():
            assert got["cache"][name].shape == w.shape, (tag, name)
            np.testing.assert_allclose(got["cache"][name], w,
                                       **TOL["float32"],
                                       err_msg=f"{tag} cache {name}")
        assert all(c == counts[0] for c in counts), tag


# ---------------------------------------------------------------------------
# Counts: the meta count of one rank against the gloo runs'
# ---------------------------------------------------------------------------


def _meta_count(cfg, shape, mesh_shape, names=DM, run=RunConfig()):
    with dryrun.fake_world(MeshConfig(mesh_shape, names)) as mesh:
        return dryrun.count_mesh(cfg, shape, run, mesh)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 1)])
def test_meta_count_of_the_train_step_is_the_gloo_runs(mesh_shape):
    """The smoke qwen2-0.5b's sharded train step (f32, 8 x 32, the gloo
    test's run), counted on meta as rank 0 of a fake world: the
    collectives the gloo ranks issue (TRAIN_COLLECTIVES)."""
    rec = _meta_count(_cfgs("qwen2-0.5b")[1],
                      ShapeConfig("t", 32, 8, "train"), mesh_shape,
                      run=RunConfig(**RUN))
    assert rec["collective_counts"] == \
        _torch_dist.TRAIN_COLLECTIVES[mesh_shape]
    assert not dist.is_initialized()


# the smoke qwen2-0.5b's TP decode tick, derived from the code (2 layers):
# the embedding's all-reduce, a layer's q / k / v gathered whole (one
# all-gather), its sequence-split attention (one all-reduce: T1's sum),
# wo's and w_down's all-reduces; the logits gathered whole. The data axis
# adds none.
QWEN_TICK = {"all-reduce": 1 + 2 * 3, "all-gather": 2 + 1}


@pytest.mark.parametrize("shape", list(MESHES))
def test_meta_count_of_prefill_and_decode_is_the_gloo_runs(
        shape, tmp_path_factory):
    """Every family's TP prefill and decode tick counted on meta as rank
    0 of a fake world issue the collectives each gloo rank issued (the
    parity runs above; the plain rules, as the dry run picks them for a
    smoke model), and the smoke qwen2-0.5b's tick its derived ones."""
    for arch, kw, _, counts in _ranks(shape, tmp_path_factory):
        if kw:
            continue
        cfg = _cfgs(arch)[1]
        dec = _meta_count(cfg, ShapeConfig("d", MAX_SEQ, B, "decode"), shape)
        pre = _meta_count(cfg, ShapeConfig("p", PROMPT, B, "prefill"), shape)
        assert dec["fsdp_params"] is False
        assert dec["collective_counts"] == counts[0][1], arch
        assert pre["collective_counts"] == counts[0][0], arch
        if arch == "qwen2-0.5b":
            assert dec["collective_counts"] == QWEN_TICK


# ---------------------------------------------------------------------------
# Specs: the JAX package's trees, and a rank's bytes
# ---------------------------------------------------------------------------


SPEC_MESHES = [((2, 2), DM), ((2, 2, 2), PDM)]


@pytest.mark.parametrize("fsdp_params", [True, False])
@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_trees_match_the_jax_rules(arch, mesh, fsdp_params):
    """The param tree (init_params on meta against eval_shape), the cache
    tree of a decode_32k layout and the serving inputs' batch specs:
    leaf by leaf the JAX package's ``Rules`` specs."""
    jcfg, tcfg = _cfgs(arch)
    rules = serve_rules(MeshConfig(*mesh), fsdp_params=fsdp_params)
    jrules = jmake_rules(JMeshConfig(*mesh), fsdp_params=fsdp_params)
    tparams = api.get_model(tcfg).init_params(device="meta")
    jparams = jax.eval_shape(jget_model(jcfg).init_params,
                             jax.random.PRNGKey(0))
    jflat = {tuple(k.key for k in path): spec for path, spec in
             jax.tree_util.tree_leaves_with_path(
                 jrules.param_spec_tree(jparams),
                 is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    tflat = dict(_flat(rules.param_spec_tree(tparams)))
    assert set(tflat) == set(jflat)
    for path, spec in tflat.items():
        assert tuple(spec) == tuple(jflat[path]), path
    shape = SHAPES["decode_32k"]
    tcache = api.get_model(tcfg).init_cache(
        DenseLayout(shape.global_batch, shape.seq_len), device="meta")
    jcache = jget_model(jcfg).cache_spec(
        JDenseLayout(shape.global_batch, shape.seq_len))
    assert set(tcache) == set(jcache)
    for name, leaf in tcache.items():
        assert tuple(leaf.shape) == jcache[name].shape
        assert tuple(rules.cache_spec(tuple(leaf.shape))) == \
            tuple(jrules.cache_spec(jcache[name].shape)), name
    for kind in ("decode_32k", "prefill_32k"):
        fn = (api.serve_decode_input_specs if kind == "decode_32k"
              else api.serve_prefill_input_specs)
        for name, leaf in fn(tcfg, SHAPES[kind]).items():
            if name != "cache":
                assert tuple(rules.batch_spec(leaf.shape)) == \
                    tuple(jrules.batch_spec(leaf.shape)), (kind, name)


def _cut_bytes(shape, dtype, spec, sizes):
    n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    for entry in spec:
        for a in (() if entry is None else
                  entry if isinstance(entry, tuple) else (entry,)):
            n //= sizes[a]
    return n


@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_argument_bytes_are_each_leaf_over_its_cut(arch):
    """A decode cell of the smoke config at (2, 2, 2): rank 0's argument
    bytes in the dry run equal the sum over the params, the cache, the
    tokens and the lengths of each leaf's global bytes over the ranks its
    spec cuts it across."""
    _, tcfg = _cfgs(arch)
    shape = ShapeConfig("d", 256, 8, "decode")
    mesh_cfg = MeshConfig((2, 2, 2), PDM)
    rules = serve_rules(mesh_cfg)
    sizes = rules.axis_sizes
    want = sum(_cut_bytes(t.shape, t.dtype, s, sizes) for (_, t), (_, s) in
               zip(_flat(api.get_model(tcfg).init_params(device="meta")),
                   _flat(rules.param_spec_tree(api.get_model(
                       tcfg).init_params(device="meta")))))
    specs = api.serve_decode_input_specs(tcfg, shape)
    for _, leaf in _flat(specs["cache"]):
        want += _cut_bytes(leaf.shape, leaf.dtype,
                           rules.cache_spec(leaf.shape), sizes)
    for name in ("tokens", "lengths"):
        leaf = specs[name]
        want += _cut_bytes(leaf.shape, leaf.dtype,
                           rules.batch_spec(leaf.shape), sizes)
    rec = _meta_count(tcfg, shape, (2, 2, 2), PDM)
    assert rec["argument_size_in_bytes"] == want


# ---------------------------------------------------------------------------
# The dry run's own rules
# ---------------------------------------------------------------------------


def test_serving_budget_is_the_h100s_less_cache_and_headroom():
    """The budget is the card's HBM less the rank's KV cache less the
    headroom; at 16 x 16 every assigned arch keeps TP-only params (the
    largest TP shard, grok-1-314b's 26.7 GB, under its budget), where
    the JAX package's 10 GB v5e budget cuts grok-1 and dbrx over data."""
    shape = SHAPES["decode_32k"]
    cfg = configs.get("qwen2-0.5b")
    cache = 24 * 128 * 32768 * 2 * 2 * 64 * 2 // 256   # cut 16 x 16
    assert dryrun.serve_replicate_budget(cfg, shape, SINGLE_POD) == (
        80 * 10**9 - cache - dryrun.SERVE_ACTIVATION_HEADROOM_BYTES)
    for arch in configs.ASSIGNED:
        for s in ("decode_32k", "prefill_32k"):
            assert not dryrun.serve_fsdp_params(configs.get(arch), SHAPES[s],
                                                SINGLE_POD), (arch, s)
    grok = configs.get("grok-1-314b")
    assert grok.param_count() * 2 / 16 > 10e9


def test_mesh_dry_run_refuses_a_process_with_a_group(tmp_path):
    """A default process group already there: the dry run does not
    start (and leaves that group alone)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="default process group"):
            with dryrun.fake_world(MeshConfig((1, 2), DM)):
                pass
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
