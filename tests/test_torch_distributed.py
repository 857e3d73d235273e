"""Slice 8a of the port on the CPU: the sharding rules, the mesh, rows 3 /
4 as shard partials, the collective combines, sequence-split decode
attention and the smoke qwen2-0.5b decoding with its cache split over
gloo ranks, against the JAX package.

The multi-rank tests run W = 2 and 4 gloo ranks, each in a process of its
own (``tests/_torch_dist.py``: a ``FileStore`` in ``tmp_path``, every
rank joined with a timeout and killed on expiry). Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: the plain partials against the JAX package's jnp partials,
2e-6 of each row's largest value (f32, sums of up to 128 products in
another order); the collective combines against its single-host
combines, 1e-6; the sharded attention against
``ref.attention_decode_ref``, rtol 1e-4 / atol 1e-5 (the JAX package's
own test of its sharded attention); the sharded smoke model against the
JAX package's unsharded ``decode_step``, ``TOL["float32"]``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from conftest import TOL
from repro import configs as jconfigs
from repro.config import MULTI_POD as JMULTI_POD
from repro.config import SINGLE_POD as JSINGLE_POD
from repro.config import MeshConfig as JMeshConfig
from repro.core import attention as jattn
from repro.core import softmax as jsmx
from repro.distributed.sharding import make_rules as jmake_rules
from repro.kernels import ref as jref
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs as tconfigs
from repro_torch.config import (MULTI_POD, SINGLE_POD, MeshConfig,
                                SoftmaxPhiConfig)
from repro_torch.core import softmax as smx
from repro_torch.core.attention import (ShardedDecodeAttention,
                                        make_decode_attention_fn)
from repro_torch.core.plan import make_plan
from repro_torch.distributed import P, local_shard, make_rules
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import mesh as tmesh
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.layers import LayerCtx, slice_decode_write

B, HQ, HK, D, S = 4, 8, 2, 64, 512
LENGTHS = np.array([100, 512, 7, 300], np.int32)
# the plain partials against the JAX package's: sums of up to 128
# products in f32 in another order (measured 1.24e-6 of the row's
# largest value at worst)
PARTIAL_REL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D), dtype=np.float32)
    k = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    v = rng.standard_normal((B, S, HK, D), dtype=np.float32)
    return q, k, v


# ---------------------------------------------------------------------------
# Rules: the JAX package's specs, entry by entry
# ---------------------------------------------------------------------------


def _same(tspec, jspec):
    assert isinstance(tspec, P)
    assert tuple(tspec) == tuple(jspec), (tspec, jspec)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("case", [
    ("param_spec", (("layers", "attn", "wq"), (24, 896, 896))),
    ("param_spec", (("layers", "attn", "wo"), (24, 896, 896))),
    ("param_spec", (("layers", "cm", "w_v"), (24, 7168, 2048))),
    ("param_spec", (("layers", "attn_norm", "scale"), (24, 896))),
    ("param_spec", (("layers", "ssm", "w_dt"), (32, 1600, 50))),
    ("param_spec", (("embedding",), (151936, 896))),
    ("param_spec", (("layers", "moe", "w_up"), (40, 16, 6144, 10752))),
    ("param_spec", (("layers", "moe", "w_down"), (40, 16, 10752, 6144))),
    ("param_spec", (("layers", "attn", "bq"), (24, 896))),
    ("act_spec", ("act_ffn", (256, 128, 4864))),
    ("act_spec", ("act_resid", (1, 64, 896))),
    ("act_spec", ("act_scores_decode", (128, 14, 32768))),
    ("act_spec", ("act_cache_slice", (128, 32768, 2, 64))),
    ("act_spec", ("act_decode_rep", (128, 14, 64))),
    ("act_spec", ("act_moe_hidden", (8, 64, 10752))),
    ("cache_spec", ((24, 128, 32768, 2, 64),)),
    ("cache_spec", ((24, 128, 32, 64, 64),)),
    ("cache_spec", ((24, 1, 524288, 8, 128),)),
    ("batch_spec", ((256, 4096),)),
    ("batch_spec", ((1, 524288),)),
])
def test_rules_match_reference(case, mesh_name):
    """Megatron orientation, dropped non-divisible dims, act specs that
    adapt to rank and divisibility, the cache's sequence over ``model``:
    the port's spec is the JAX package's on both production meshes."""
    method, args = case
    t_cfg, j_cfg = ((SINGLE_POD, JSINGLE_POD) if mesh_name == "single"
                    else (MULTI_POD, JMULTI_POD))
    _same(getattr(make_rules(t_cfg), method)(*args),
          getattr(jmake_rules(j_cfg), method)(*args))


def test_rules_literal_specs():
    """The JAX package's own literal cases (tests/test_distributed.py)."""
    rules = make_rules(SINGLE_POD)
    assert rules.param_spec(("layers", "attn", "wq"), (24, 896, 896)) == \
        P(None, ("data",), "model")
    assert rules.param_spec(("layers", "attn", "wo"), (24, 896, 896)) == \
        P(None, "model", ("data",))
    assert make_rules(MULTI_POD).param_spec(
        ("layers", "ssm", "w_dt"), (32, 1600, 50)) == \
        P(None, ("pod", "data"), None)
    assert rules.cache_spec((24, 128, 32768, 2, 64)) == \
        P(None, ("data",), "model", None, None)
    assert make_rules(SINGLE_POD, seq_shard_kv=False).cache_spec(
        (24, 128, 32768, 2, 64)) == P(None, ("data",), None, None, None)
    assert repr(P(None, "model")) == "P(None, 'model')"


@pytest.mark.parametrize("flags", [
    {}, {"fsdp_params": False}, {"fsdp_over_pod": False},
    {"act_over_pod": False}])
def test_rules_properties_match_reference(flags):
    for t_cfg, j_cfg in ((SINGLE_POD, JSINGLE_POD),
                         (MULTI_POD, JMULTI_POD)):
        t, j = make_rules(t_cfg, **flags), jmake_rules(j_cfg, **flags)
        for name in ("batch_axes", "act_batch_axes", "fsdp_axes",
                     "model_axis", "axis_sizes"):
            assert getattr(t, name) == getattr(j, name), name
        _same(t.param_spec(("layers", "mlp", "w_gate"), (24, 896, 4864)),
              j.param_spec(("layers", "mlp", "w_gate"), (24, 896, 4864)))
        _same(t.act_spec("act_logits", (64, 1, 151936)),
              j.act_spec("act_logits", (64, 1, 151936)))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", sorted(tconfigs.REGISTRY))
def test_every_arch_param_specs_match_reference(arch):
    """param_spec_tree over every leaf of each architecture's params (the
    port's on the meta device, the JAX package's under eval_shape), on
    both meshes: the same spec per leaf path, and every named dim
    divides."""
    tparams = tget_model(tconfigs.get(arch)).init_params(device="meta")
    jparams = jax.eval_shape(jget_model(jconfigs.get(arch)).init_params,
                             jax.random.PRNGKey(0))
    for t_cfg, j_cfg in ((SINGLE_POD, JSINGLE_POD),
                         (MULTI_POD, JMULTI_POD)):
        rules = make_rules(t_cfg)
        tspecs = dict(_flat(rules.param_spec_tree(tparams)))
        jspecs = jmake_rules(j_cfg).param_spec_tree(jparams)
        jflat = {tuple(k.key for k in path): spec for path, spec in
                 jax.tree_util.tree_leaves_with_path(
                     jspecs, is_leaf=lambda s: isinstance(
                         s, jax.sharding.PartitionSpec))}
        assert set(tspecs) == set(jflat)
        shapes = dict(_flat(tparams))
        for path, spec in tspecs.items():
            _same(spec, jflat[path])
            for dim, entry in zip(shapes[path].shape, spec):
                if entry is not None:
                    axes = entry if isinstance(entry, tuple) else (entry,)
                    n = int(np.prod([rules.axis_sizes[a] for a in axes]))
                    assert dim % n == 0, (arch, path, spec)


def test_input_specs_tree_matches_reference():
    from repro_torch.config import SHAPES as TSHAPES
    from repro_torch.models.api import serve_decode_input_specs
    cfg = tconfigs.get("qwen2-0.5b")
    specs = serve_decode_input_specs(cfg, TSHAPES["decode_32k"])
    t = make_rules(SINGLE_POD).input_specs_tree(specs)
    j = jmake_rules(JSINGLE_POD)
    assert t["tokens"] == P(("data",))
    for name, leaf in specs["cache"].items():
        _same(t["cache"][name], j.cache_spec(leaf.shape))
        assert t["cache"][name][2] == "model"
    _same(t["lengths"], j.batch_spec(specs["lengths"].shape))


# ---------------------------------------------------------------------------
# The mesh and local shards
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_raises_without_a_world():
    with pytest.raises(RuntimeError, match="default process group"):
        tmesh.make_mesh_from_config(MeshConfig((1, 1), ("data", "model")),
                                    device="cpu")


def test_mesh_raises_when_the_world_is_too_small(world_of_one):
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="need 2 ranks"):
        tmesh.make_mesh_from_config(MeshConfig((1, 2), ("data", "model")),
                                    device="cpu")
    m = tmesh.make_mesh_from_config(MeshConfig((1, 1), ("data", "model")),
                                    device="cpu")
    assert (m.coords, m.backend, m.axis_sizes) == (
        (0, 0), "gloo", {"data": 1, "model": 1})
    assert m.group("model") is not None


def test_mesh_config_backend_and_coordinates():
    assert tmesh.mesh_config() == SINGLE_POD
    assert tmesh.mesh_config(multi_pod=True) == MULTI_POD
    assert tmesh.backend_for("cuda") == "nccl"
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError):
        tmesh.backend_for("meta")
    # row-major, the last axis fastest (jax.make_mesh's device order)
    shape = (2, 3, 4)
    coords = [tmesh._unravel(r, shape) for r in range(24)]
    assert coords[:5] == [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 0, 3),
                          (0, 1, 0)]
    assert [tmesh._ravel(c, shape) for c in coords] == list(range(24))


def test_local_shard_cuts_like_a_named_sharding():
    class FakeMesh:
        shape, axis_names = (2, 2, 4), ("pod", "data", "model")
        coords = (1, 0, 3)
        coord = tmesh.Mesh.coord
        size = tmesh.Mesh.size
    x = torch.arange(4 * 8 * 16).reshape(4, 8, 16)
    got = local_shard(x, P(None, ("pod", "data"), "model"), FakeMesh())
    # (pod, data) = (1, 0) is block 2 of 4 along dim 1; model 3 of 4
    assert torch.equal(got, x[:, 4:6, 12:16])
    with pytest.raises(ValueError, match="divide"):
        local_shard(torch.zeros(3, 6), P("model", None), FakeMesh())


# ---------------------------------------------------------------------------
# Rows 3 / 4 as shard partials (their plain versions, the CPU path)
# ---------------------------------------------------------------------------


def _close_to_row_scale(got, want, rel=PARTIAL_REL):
    """|got - want| <= rel x the row's largest |want| (num: over D; den,
    the max: the element), -inf where the reference has -inf."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0))
    scale = np.abs(np.where(fin, want, 0.0))
    if want.ndim == 3:
        scale = scale.max(-1, keepdims=True)
    assert (err <= rel * scale).all(), (err / np.maximum(scale, 1e-30)).max()


@pytest.mark.parametrize("rank", range(4))
def test_plain_partials_match_reference(rank):
    """Per slice of W = 4: the plain partial (the split kernel's splits,
    folded without the division) is the JAX package's
    ``_local_partial_async`` / ``_local_partial_sync``, empty rows (0, 0,
    -inf) included."""
    q, k, v = _qkv()
    s_loc = S // 4
    start = rank * s_loc
    k_loc, v_loc = k[:, start:start + s_loc], v[:, start:start + s_loc]
    scale = D ** -0.5
    jl = jnp.asarray(LENGTHS)
    ja = jattn._local_partial_async(jnp.asarray(q), jnp.asarray(k_loc),
                                    jnp.asarray(v_loc), start, jl, 0.0,
                                    scale)
    js = jattn._local_partial_sync(jnp.asarray(q), jnp.asarray(k_loc),
                                   jnp.asarray(v_loc), start, jl, scale)
    tq = torch.from_numpy(q)
    tk = torch.from_numpy(np.ascontiguousarray(k_loc)).transpose(1, 2)
    tv = torch.from_numpy(np.ascontiguousarray(v_loc)).transpose(1, 2)
    ta = da.decode_attention_partial_unified_max(tq, tk, tv,
                                                 torch.from_numpy(LENGTHS),
                                                 start, phi=0.0)
    ts = da.decode_attention_partial_sync(tq, tk, tv,
                                          torch.from_numpy(LENGTHS), start)
    for got, want in zip((*ta, *ts), (*ja, *js)):
        assert got.dtype == torch.float32
        _close_to_row_scale(got.numpy(), np.asarray(want))
    empty = (LENGTHS <= start)
    assert bool((ta[1][empty] == 0).all()) and bool(
        (ts[2][empty] == -np.inf).all())


def test_partials_of_an_empty_slice_add_nothing():
    """A slice that holds no key of any row gives 0, 0 and -inf, and both
    combines then return the other slice's result unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    lens = torch.tensor([64, 200, 1, 255])
    lo = [kt[:, :, :256], vt[:, :, :256]]
    hi = [kt[:, :, 256:], vt[:, :, 256:]]
    for unified in (True, False):
        p_lo = da.decode_attention_partial_plain(q, *lo, lens, 0,
                                                 unified_max=unified)
        p_hi = da.decode_attention_partial_plain(q, *hi, lens, 256,
                                                 unified_max=unified)
        assert not p_hi[0].any() and not p_hi[1].any()
        assert bool((p_hi[2] == -torch.inf).all())
        if unified:
            both = smx.combine_async([smx.AsyncPartial(*p_lo),
                                      smx.AsyncPartial(*p_hi)])[0]
            alone = smx.combine_async([smx.AsyncPartial(*p_lo)])[0]
        else:
            both = smx.combine_sync([smx.SyncPartial(*p_lo),
                                     smx.SyncPartial(*p_hi)])
            alone = smx.combine_sync([smx.SyncPartial(*p_lo)])
        assert torch.equal(both, alone)


def test_partial_wrappers_take_global_lengths():
    """The wrappers pass global lengths and the slice's start; the local
    lengths are clamp(lengths - start, 0, S_loc)."""
    lens = torch.tensor([0, 5, 70, 300], dtype=torch.int32)
    assert da.local_lengths(lens, 64, 128).tolist() == [0, 0, 6, 128]


# ---------------------------------------------------------------------------
# Gloo runs: the collective combines, sharded attention, sharded decode
# ---------------------------------------------------------------------------


def _jax_partials(w):
    q, k, v = _qkv()
    s_loc = S // w
    scale = D ** -0.5
    jl = jnp.asarray(LENGTHS)
    pa, ps = [], []
    for r in range(w):
        kl = jnp.asarray(k[:, r * s_loc:(r + 1) * s_loc])
        vl = jnp.asarray(v[:, r * s_loc:(r + 1) * s_loc])
        pa.append(jattn._local_partial_async(jnp.asarray(q), kl, vl,
                                             r * s_loc, jl, 0.0, scale))
        ps.append(jattn._local_partial_sync(jnp.asarray(q), kl, vl,
                                            r * s_loc, jl, scale))
    return pa, ps


@pytest.mark.parametrize("w", [2, 4])
def test_collective_combines_match_reference(w, tmp_path):
    """Each rank's JAX partial through ``combine_async_collective`` /
    ``combine_sync_collective`` gives the JAX single-host combines of all
    of them, on every rank; one all-reduce for async (two with the
    statistic), two for sync."""
    pa, ps = _jax_partials(w)
    np_a = [tuple(np.asarray(x) for x in p) for p in pa]
    np_s = [tuple(np.asarray(x) for x in p) for p in ps]
    res = _torch_dist.run("combine", w, tmp_path,
                          {"async": np_a, "sync": np_s})
    want_a, want_mc = jsmx.combine_async(pa)
    want_s = jsmx.combine_sync(ps)
    for r in res:
        np.testing.assert_allclose(r["async_out"], np.asarray(want_a),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["mc"], np.asarray(want_mc))
        np.testing.assert_allclose(r["sync_out"], np.asarray(want_s),
                                   rtol=1e-6, atol=1e-6)
        assert (r["n_async"], r["n_sync"]) == (2, 2)


_ATTN = {}


def _attention_run(w, tmp_path):
    if w not in _ATTN:
        q, k, v = _qkv()
        _ATTN[w] = _torch_dist.run("attention", w, tmp_path, dict(
            q=q, k=k, v=v, lengths=LENGTHS))
    return _ATTN[w]


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_decode_attention_matches_reference(w, tmp_path):
    """decode_attention_sharded over W slices, both schemes, both
    backends (the "cuda" backend's wrappers run their plain versions on
    CPU tensors): every rank's output is ``ref.attention_decode_ref`` of
    the whole cache."""
    q, k, v = _qkv()
    want = np.asarray(jref.attention_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(LENGTHS)))
    for r in _attention_run(w, tmp_path):
        for key, (out, _) in r.items():
            np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5,
                                       err_msg=str(key))


@pytest.mark.parametrize("w", [2, 4])
def test_sharded_decode_attention_collective_count(w, tmp_path):
    """T1's claim at the collective level (CostCounter on the c10d ops):
    the async combine is ONE all-reduce a call, the synchronized one
    TWO."""
    for r in _attention_run(w, tmp_path):
        for (scheme, _), (_, n) in r.items():
            assert n == (1 if scheme == "unified_max" else 2), (scheme, n)


def _smoke_model():
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get("qwen2-0.5b")),
                               param_dtype="float32",
                               activation_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get("qwen2-0.5b")),
                               param_dtype="float32",
                               activation_dtype="float32")
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, jax.device_get(jp)


STEPS, MAX_SEQ = 8, 128
# row 0 crosses position 64 (W = 2's boundary) at its fifth step, row 2
# position 32 (W = 4's) at its fourth
DEC_LENGTHS = np.array([60, 10, 29, 100], np.int32)


@pytest.mark.parametrize("fusion,w", [("split", 2), ("split", 4),
                                      ("fused", 2)])
def test_sharded_decode_step_matches_unsharded_reference(fusion, w,
                                                         tmp_path):
    """The smoke qwen2-0.5b in f32 decodes 8 greedy steps with its cache
    split over W ranks (T1 on the "cuda" plan, sync on "torch"): every
    step's logits within TOL["float32"] of the JAX package's unsharded
    ``decode_step`` on the same params and cache, the same tokens, the
    ranks' slices joined equal to the JAX cache after the steps (each new
    entry on the rank that holds its position, nothing else written), and
    num_layers all-reduces a step (async) or twice that (sync)."""
    jcfg, tcfg, jp, host = _smoke_model()
    japi = jget_model(jcfg)
    b = len(DEC_LENGTHS)
    rng = np.random.default_rng(3)
    jcache = japi.init_cache(JDenseLayout(b, MAX_SEQ))
    pos = np.arange(MAX_SEQ)[None, :, None, None] < DEC_LENGTHS[
        :, None, None, None]
    cache = {}
    for name, leaf in jcache.items():
        vals = rng.standard_normal(leaf.shape, dtype=np.float32)
        cache[name] = np.where(pos[None], vals, 0.0).astype(np.float32)
    tokens = rng.integers(1, jcfg.vocab_size, (b,)).astype(np.int32)

    res = _torch_dist.run("decode", w, tmp_path, dict(
        cfg=tcfg, params=host, cache=cache, tokens=tokens,
        lengths=DEC_LENGTHS, steps=STEPS, fusion=fusion), timeout=240)

    jctx = JLayerCtx(cfg=jcfg)
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    jt, jlen = jnp.asarray(tokens), jnp.asarray(DEC_LENGTHS)
    want_logits, want_tokens = [], []
    for _ in range(STEPS):
        lg, jc = japi.decode_step(jctx, jp, jt, jc, jlen)
        want_logits.append(np.asarray(lg))
        jt = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        want_tokens.append(np.asarray(jt))
        jlen = jlen + 1
    for scheme in ("unified_max", "sync"):
        per_layer = 1 if scheme == "unified_max" else 2
        for rank, r in enumerate(res):
            got = r[scheme]
            for i in range(STEPS):
                np.testing.assert_allclose(got["logits"][i], want_logits[i],
                                           **TOL["float32"])
                np.testing.assert_array_equal(got["tokens"][i],
                                              want_tokens[i])
            assert got["counts"] == [per_layer * tcfg.num_layers] * STEPS
        for name in ("k", "v"):
            joined = np.concatenate([r[scheme]["cache"][name] for r in res],
                                    axis=2)
            np.testing.assert_allclose(joined, np.asarray(jc[name]),
                                       **TOL["float32"])
            # positions no step wrote hold the seeded cache bit for bit
            untouched = ~((np.arange(MAX_SEQ)[None, :] >= DEC_LENGTHS[:, None])
                          & (np.arange(MAX_SEQ)[None, :]
                             < DEC_LENGTHS[:, None] + STEPS))
            np.testing.assert_array_equal(joined[:, untouched],
                                          cache[name][:, untouched])


# ---------------------------------------------------------------------------
# The model's side: the KV write into a slice, looped refused
# ---------------------------------------------------------------------------


def test_slice_decode_write_lands_on_the_owning_rank_only():
    """Rank 1 of a 4-position split holds positions 4..7: a row at
    length 5 writes its local position 1, rows at 3 and 8 write nothing,
    and nothing else of the slice changes."""
    cache = torch.randn(4, 4, 2, 8)
    before = cache.clone()
    new = torch.randn(4, 1, 2, 8)
    lengths = torch.tensor([3, 5, 8, 4], dtype=torch.int32)
    w = slice_decode_write(cache, lengths, start=4)
    w.put(cache, new)
    want = before.clone()
    want[1, 1] = new[1, 0]
    want[3, 0] = new[3, 0]
    assert torch.equal(cache, want)
    # no row on this slice: nothing changes at all
    cache2 = before.clone()
    slice_decode_write(cache2, torch.tensor([0, 1, 2, 9]), 4).put(cache2,
                                                                 new)
    assert torch.equal(cache2, before)


def test_looped_with_a_sharded_ctx_is_refused():
    cfg = tconfigs.smoke(tconfigs.get("qwen2-0.5b"))
    fn = ShardedDecodeAttention(mesh=None, phi_cfg=cfg.softmax_phi)
    with pytest.raises(ValueError, match="slice 8b"):
        LayerCtx(cfg=cfg, plan=make_plan("torch", decode_fusion="looped"),
                 decode_attention_fn=fn)
    ctx = LayerCtx(cfg=cfg, plan=make_plan("torch", decode_fusion="fused"),
                   decode_attention_fn=fn)
    assert ctx.decode_attention_fn is fn


def test_make_decode_attention_fn_honours_rules_and_plan():
    rules = make_rules(MeshConfig((1, 2), ("data", "model")))
    fn = make_decode_attention_fn("mesh", rules, SoftmaxPhiConfig(),
                                  scheme="sync", backend="torch")
    assert (fn.mesh, fn.scheme, fn.model_axis, fn.backend) == (
        "mesh", "sync", "model", "torch")


def test_jax_mesh_config_is_the_ports():
    assert dataclasses.asdict(SINGLE_POD) == dataclasses.asdict(JSINGLE_POD)
    assert dataclasses.asdict(MULTI_POD) == dataclasses.asdict(JMULTI_POD)
    assert JMeshConfig((1, 2), ("data", "model")).model_axis == \
        MeshConfig((1, 2), ("data", "model")).model_axis
