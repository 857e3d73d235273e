"""The port's decode fusion on CPU tensors: the three fused stage kernels'
plain versions (rows 12-14 of the kernel table) and the ``ops`` front
doors against the JAX package's Pallas kernels run the way its own tests
run them (``interpret=True``) and against the JAX oracles, on the same
numpy inputs; split = fused = looped bitwise on the ``"torch"`` backend;
the fused plan's logits and the fused / looped engines' greedy tokens
against the JAX package; the engine's ``decode_fusion=`` override; and
the looped graph cache's launch accounting, driven with a stand-in graph.

Tolerances: TOL["float32"] for f32 inputs (same math, other summation
order: the plain versions accumulate the kernels' K tiles); TOL["bfloat16"]
for bf16 inputs. The CUDA kernels are held to these plain versions on the
card by ``chip_smoke.py``, and the CUDA graph to the eager fused step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import decode_fuse as jdf
from repro.kernels import ref as jref
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.core.plan import FUSION_MODES, make_plan
from repro_torch.kernels import decode_fuse as tdf
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout, PagedLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import LoopedDecode
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs it in
    parallel workers beside other files, where more threads only
    contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# Rows 12-14: plain versions and front doors against the Pallas kernels
# ---------------------------------------------------------------------------

# (M, num_heads, num_kv_heads, head_dim, d_model, bias, rope), the JAX
# package's own ingest cases; d_model 192 leaves a K tail of 64 behind
# the 128-deep K tiles
INGEST_CASES = [
    (1, 4, 2, 32, 128, False, True),
    (3, 8, 8, 64, 256, True, True),
    (1, 4, 1, 64, 192, True, False),
    (3, 12, 4, 64, 384, False, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,hq,hk,dh,d,bias,use_rope", INGEST_CASES)
def test_decode_ingest_matches_pallas(m, hq, hk, dh, d, bias, use_rope,
                                      dtype):
    rng = np.random.default_rng(hq * 1000 + d)
    (jx, tx) = _pair(rng.normal(size=(m, d)), dtype)
    (js, ts) = _pair(rng.normal(size=(d,)), dtype)
    ws = [_pair(rng.normal(size=(d, n)) * d ** -0.5, dtype)
          for n in (hq * dh, hk * dh, hk * dh)]
    bs = [_pair(rng.normal(size=(n,)), dtype) if bias else (None, None)
          for n in (hq * dh, hk * dh, hk * dh)]
    pos = np.array([4, 9, 1000][:m], np.int32)
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh,
              rope_theta=1e6, use_rope=use_rope)
    want = jdf.decode_ingest_fused(
        jx, js, *(w[0] for w in ws), jnp.asarray(pos), bq=bs[0][0],
        bk_bias=bs[1][0], bv=bs[2][0], interpret=True, **kw)
    oracle = jref.decode_ingest_ref(
        jx[:, None], js, *(w[0] for w in ws), jnp.asarray(pos),
        bq=bs[0][0], bk=bs[1][0], bv=bs[2][0], **kw)
    tkw = dict(kw, bq=bs[0][1], bk=bs[1][1], bv=bs[2][1])
    tpos = torch.from_numpy(pos)
    got = tdf.decode_ingest_plain(tx, ts, *(w[1] for w in ws), tpos,
                                  **tkw)
    # the wrapper on a CPU tensor is the plain version
    assert all(torch.equal(a, b) for a, b in zip(
        tdf.decode_ingest_fused(tx, ts, *(w[1] for w in ws), tpos,
                                **tkw), got))
    front = ops.decode_ingest(tx[:, None], ts, *(w[1] for w in ws),
                              tpos, plan=make_plan("cuda"), **tkw)
    ref_front = ops.decode_ingest(tx[:, None], ts, *(w[1] for w in ws),
                                  tpos, plan=make_plan("torch"), **tkw)
    for i, (g, w, o) in enumerate(zip(got, want, oracle)):
        assert g.shape == (m, w.shape[1]) and g.dtype == tx.dtype
        _close(g, w, dtype)
        _close(g, o.reshape(m, -1), dtype)
        assert torch.equal(front[i].reshape(m, -1), g)
        _close(ref_front[i], o, dtype)


OPROJ_CASES = [(1, 128, 128), (3, 256, 192), (3, 384, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,q_dim,d", OPROJ_CASES)
def test_oproj_residual_matches_pallas(m, q_dim, d, dtype):
    rng = np.random.default_rng(m * 100 + d)
    jo, to = _pair(rng.normal(size=(m, q_dim)), dtype)
    jw, tw = _pair(rng.normal(size=(q_dim, d)) * q_dim ** -0.5, dtype)
    jr, tr = _pair(rng.normal(size=(m, d)), dtype)
    want = jdf.oproj_residual_fused(jo, jw, jr, interpret=True)
    oracle = jref.oproj_residual_ref(jo[:, None], jw, jr[:, None])
    got = tdf.oproj_residual_plain(to, tw, tr)
    assert got.shape == (m, d) and got.dtype == tr.dtype
    _close(got, want, dtype)
    _close(got, oracle[:, 0], dtype)
    assert torch.equal(tdf.oproj_residual_fused(to, tw, tr), got)
    assert torch.equal(ops.oproj_residual(to[:, None], tw, tr[:, None],
                                          plan=make_plan("cuda"))[:, 0], got)
    _close(ops.oproj_residual(to[:, None], tw, tr[:, None],
                              plan=make_plan("torch")), oracle, dtype)


# (m, d_model, d_ff, activation): the JAX package's cases with M in
# {1, 3}; d_model 192 leaves a K tail
FFN_NORM_CASES = [(1, 128, 256, "swiglu"), (3, 192, 384, "swiglu"),
                  (1, 256, 512, "geglu"), (3, 384, 640, "geglu")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f,act", FFN_NORM_CASES)
def test_ffn_norm_matches_pallas(m, d, f, act, dtype):
    rng = np.random.default_rng(m * 100 + f)
    jx, tx = _pair(rng.normal(size=(m, d)), dtype)
    js, ts = _pair(rng.normal(size=(d,)), dtype)
    jg, tg = _pair(rng.normal(size=(d, f)) * d ** -0.5, dtype)
    ju, tu = _pair(rng.normal(size=(d, f)) * d ** -0.5, dtype)
    want = jdf.ffn_norm_fused(jx, js, jg, ju, activation=act, interpret=True)
    oracle = jref.ffn_norm_ref(jx[:, None], js, jg, ju, activation=act,
                               fused=True)
    got = tdf.ffn_norm_plain(tx, ts, tg, tu, activation=act)
    assert got.shape == (m, f) and got.dtype == tx.dtype
    _close(got, want, dtype)
    _close(got, oracle[:, 0], dtype)
    assert torch.equal(tdf.ffn_norm_fused(tx, ts, tg, tu, activation=act),
                       got)
    assert torch.equal(ops.ffn_norm(tx[:, None], ts, tg, tu, activation=act,
                                    plan=make_plan("cuda"))[:, 0], got)
    for fused in (True, False):
        _close(ops.ffn_norm(tx[:, None], ts, tg, tu, activation=act,
                            plan=make_plan("torch", fused_ffn=fused)),
               jref.ffn_norm_ref(jx[:, None], js, jg, ju, activation=act,
                                 fused=fused), dtype)


def test_stage_kernels_reject_bad_operands():
    x = torch.zeros(2, 16)
    w = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="oproj_residual"):
        tdf.oproj_residual_fused(x, w, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="activation"):
        tdf.ffn_norm_fused(x, torch.ones(16), w, w, activation="relu")
    with pytest.raises(ValueError, match="biases"):
        tdf.decode_ingest_fused(x, torch.ones(16), w, w, w,
                                torch.zeros(2, dtype=torch.int32),
                                num_heads=1, num_kv_heads=1, head_dim=8,
                                bq=torch.zeros(8))


def test_resident_tiles_fit_shared_memory():
    """The resident-row kernels keep their rows inside a block's shared
    memory, at decode M and past one 64-row block, and shrink the row
    tile for a wide model rather than fail: the split ingest keeps mt
    rows of one split's K range beside its weight ring, and the wgmma
    ffn_norm (bf16 and codes) one split's normed rows beside its TMA ring
    and, for codes, its conversion buffers."""
    from repro_torch import hardware
    budget = hardware.DEFAULT.smem_per_block
    for m in (1, 4, 64, 300):
        for k, n in ((896, 4864), (4096, 11008)):
            for hd, heads in ((64, 18), (128, 96)):
                mt, splits = tdf.ingest_tiles(m, k, hd, heads)
                span = tdf.split_tiles(k, splits) * tdf.SPLIT_ROWS
                assert mt % 8 == 0 and 8 <= mt <= 64
                assert tdf.ingest_smem(mt, span, hd) <= budget
            for w_bytes in (2, 1):
                splits = tdf.ffn_norm_splits(k, n, w_bytes)
                per = tdf.split_tiles(k, splits)
                assert tdf.wgmma_norm_smem(per, w_bytes) <= budget
                assert tdf.wgmma_norm_blocks_per_sm(per, w_bytes) >= 1
    assert tdf.ingest_tiles(4, 896, 64, 18) == (8, 7)


# ---------------------------------------------------------------------------
# Model path: split = fused = looped on "torch"; fused against the JAX plan
# ---------------------------------------------------------------------------


def _model(dtype: str):
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **over)
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **over)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def bf16_model():
    return _model("bfloat16")


@pytest.fixture(scope="module")
def f32_model():
    return _model("float32")


def test_every_granularity_constructs():
    tcfg = tconfigs.smoke(tconfigs.get(ARCH))
    for g in FUSION_MODES:
        ctx = LayerCtx(cfg=tcfg, plan=make_plan("cuda", decode_fusion=g))
        assert ctx.plan.decode_fusion.granularity == g
        assert ctx.fused == (g != "split")
        assert isinstance(ctx.graphs, LoopedDecode) == (g == "looped")
    # each looped context keeps graphs of its own
    a = LayerCtx(cfg=tcfg, plan=make_plan("cuda", decode_fusion="looped"))
    b = LayerCtx(cfg=tcfg, plan=make_plan("cuda", decode_fusion="looped"))
    assert a.graphs is not b.graphs and a == b
    # the graphs belong to the context's plan: no caller hands them in
    with pytest.raises(TypeError):
        LayerCtx(cfg=tcfg, plan=a.plan, graphs=a.graphs)


@pytest.mark.parametrize("fused_ffn", [False, True])
def test_stages_bitwise_split_on_torch(bf16_model, fused_ffn):
    """The fused seams on "torch" compose the split chain's expressions:
    stages A, C and D give bitwise the split stages' results."""
    _, tcfg, _, tp = bf16_model
    lay = tp["layers"]
    attn = {k: v[1] for k, v in lay["attn"].items()}
    attn["bq"] = torch.randn(attn["bq"].shape).to(attn["bq"].dtype)
    mlp = {k: v[1] for k, v in lay["mlp"].items()}
    norm = {"scale": (torch.rand(tcfg.d_model) + 0.5).to(torch.bfloat16)}
    x = torch.randn(3, 1, tcfg.d_model).to(torch.bfloat16)
    pos = torch.tensor([0, 17, 300], dtype=torch.int32)
    o = torch.randn(3, 1, tcfg.q_dim).to(torch.bfloat16)
    ctx = {g: LayerCtx(cfg=tcfg, plan=make_plan(
        "torch", fused_ffn=fused_ffn, decode_fusion=g)) for g in FUSION_MODES}
    for g in ("fused", "looped"):
        for a, b in zip(L.decode_ingest(ctx[g], norm, attn, x, pos),
                        L.decode_ingest(ctx["split"], norm, attn, x, pos)):
            assert torch.equal(a, b)
        assert torch.equal(L.decode_epilogue(ctx[g], attn, o, x),
                           L.decode_epilogue(ctx["split"], attn, o, x))
        assert torch.equal(L.decode_mlp(ctx[g], norm, mlp, x),
                           L.decode_mlp(ctx["split"], norm, mlp, x))


def _paged_step_inputs(tcfg, tp, backend):
    """A paged cache whose four rows share two 16-token pages: row 0
    prefills them, the others are spectators; then every row decodes
    through one group."""
    from repro_torch.kernels.group_attention import DecodeGroups
    api = tget_model(tcfg)
    b, ps, nb = 4, 16, 4
    perm = torch.randperm(b * nb, generator=torch.Generator().manual_seed(0))
    bt = perm.reshape(b, nb).int()
    bt[:, :2] = bt[0, :2]
    cache = api.init_cache(PagedLayout(b * nb, ps), device="cpu")
    toks = torch.randint(1, 500, (b, 2 * ps),
                         generator=torch.Generator().manual_seed(1)).int()
    row0 = torch.tensor([2 * ps, 0, 0, 0], dtype=torch.int32)
    ctx = LayerCtx(cfg=tcfg, plan=make_plan(backend))
    _, cache = api.prefill_chunk(ctx, tp, toks, row0, cache,
                                 torch.zeros(b, dtype=torch.int32),
                                 block_tables=bt)

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32)

    groups = DecodeGroups(
        tables=bt[:1, :2].contiguous(), n_pages=i32(2),
        g_prefix_len=i32(2 * ps), num_members=i32(b),
        member_rows=i32(*range(b))[None], gid=i32(*[0] * b),
        member=i32(*range(b)), prefix_len=i32(*[2 * ps] * b))
    return cache, bt, groups, torch.full((b,), 2 * ps, dtype=torch.int32)


@pytest.mark.parametrize("layout", ["dense", "paged grouped"])
def test_decode_logits_bitwise_across_granularities_on_torch(bf16_model,
                                                            layout):
    """split = fused = looped, bitwise, on the "torch" backend: the decode
    step's logits and every cache entry it wrote, from identical caches,
    for the dense cache and for grouped decode over a shared prefix."""
    _, tcfg, _, tp = bf16_model
    api = tget_model(tcfg)
    tokens = torch.tensor([5, 77, 300, 2], dtype=torch.int32)
    if layout == "dense":
        cache0 = api.init_cache(DenseLayout(4, 64), device="cpu")
        cache0["k"].normal_(generator=torch.Generator().manual_seed(2))
        cache0["v"].normal_(generator=torch.Generator().manual_seed(3))
        lengths = torch.tensor([9, 30, 1, 50], dtype=torch.int32)
        kw = {}
    else:
        cache0, bt, groups, lengths = _paged_step_inputs(tcfg, tp, "torch")
        kw = dict(block_tables=bt, decode_groups=groups)
    results = {}
    for g in FUSION_MODES:
        ctx = LayerCtx(cfg=tcfg, plan=make_plan(
            "torch", decode_group="grouped", decode_fusion=g))
        cache = {k: v.clone() for k, v in cache0.items()}
        logits, cache = api.decode_step(ctx, tp, tokens, cache, lengths, **kw)
        results[g] = (logits, cache)
    for g in ("fused", "looped"):
        assert torch.equal(results[g][0], results["split"][0]), g
        for name in ("k", "v"):
            assert torch.equal(results[g][1][name],
                               results["split"][1][name]), g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plan_logits_match_jax_fused_plan(dtype):
    """A ragged chunk then two decode steps under the "cuda" fused plan on
    CPU tensors (the stage kernels' plain versions): logits against the
    JAX package's fused plan; looped, which runs the fused path eagerly
    on CPU tensors, gives the same bits."""
    jcfg, tcfg, jp, tp = _model(dtype)
    japi, tapi = jget_model(jcfg), tget_model(tcfg)
    jctx = JLayerCtx(cfg=jcfg, plan=jmake_plan(fused_ffn=True,
                                               decode_fusion="fused"))
    tctx = LayerCtx(cfg=tcfg, plan=make_plan("cuda", decode_fusion="fused"))
    lctx = LayerCtx(cfg=tcfg, plan=make_plan("cuda", decode_fusion="looped"))
    rng = np.random.default_rng(3)
    b, c, s_max = 2, 16, 48
    tokens = rng.integers(1, jcfg.vocab_size, (b, c)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    zeros = np.zeros((b,), np.int32)
    _, jcache = japi.prefill_chunk(
        jctx, jp, jnp.asarray(tokens), jnp.asarray(lens),
        japi.init_cache(JDenseLayout(b, s_max)), jnp.asarray(zeros))
    _, tcache = tapi.prefill_chunk(
        tctx, tp, torch.from_numpy(tokens), torch.from_numpy(lens),
        tapi.init_cache(DenseLayout(b, s_max), device="cpu"),
        torch.from_numpy(zeros))
    for step, nxt in enumerate(([5, 77], [300, 2])):
        nxt = np.array(nxt, np.int32)
        jl, jcache = japi.decode_step(jctx, jp, jnp.asarray(nxt), jcache,
                                      jnp.asarray(lens + step))
        lcache = {k: v.clone() for k, v in tcache.items()}
        tl, tcache = tapi.decode_step(tctx, tp, torch.from_numpy(nxt),
                                      tcache, torch.from_numpy(lens + step))
        _close(tl, jl, dtype)
        ll, lcache = tapi.decode_step(lctx, tp, torch.from_numpy(nxt),
                                      lcache, torch.from_numpy(lens + step))
        assert torch.equal(ll, tl)
        assert all(torch.equal(lcache[k], tcache[k]) for k in tcache)


def _header_prompts(seed, header_len, tails, vocab=500):
    rng = np.random.default_rng(seed)
    header = rng.integers(1, vocab, size=header_len).astype(np.int32)
    return [np.concatenate([header, rng.integers(1, vocab, size=n).astype(
        np.int32)]) for n in tails]


@pytest.mark.parametrize("layout", ["dense", "paged sharing grouped"])
def test_engine_matches_jax_engine(f32_model, layout):
    """Greedy serving in f32 under fused and looped: the port's engine on
    the "cuda" plan (plain versions on the CPU) and on "torch" against
    the JAX engine with the same granularity, token for token."""
    jcfg, tcfg, jp, tp = f32_model
    budgets = [5, 3, 6, 4]
    if layout == "dense":
        prompts = [np.random.default_rng(5).integers(1, 500, n).astype(
            np.int32) for n in (9, 30, 17, 23)]
        kw = dict(num_slots=2, max_seq=96, prefill_chunk=16)
        jkw, tkw = {}, {}
    else:
        prompts = _header_prompts(13, 32, (9, 23, 5, 30))
        kw = dict(num_slots=3, max_seq=128, prefill_chunk=16,
                  cache_kind="paged", page_size=16, prefix_sharing=True)
        jkw = dict(decode_group="grouped", group_threshold=1)
        tkw = dict(decode_group="grouped", group_threshold=1)
    for g in ("fused", "looped"):
        want = JEngine(jcfg, jp, plan=jmake_plan(fused_ffn=True, **jkw),
                       decode_fusion=g, **kw).run(
            [(p, JSamplingParams(max_new_tokens=n))
             for p, n in zip(prompts, budgets)])
        for backend in ("cuda", "torch"):
            eng = Engine(tcfg, tp, plan=make_plan(backend, fused_ffn=True,
                                                  **tkw),
                         decode_fusion=g, device="cpu", **kw)
            got = eng.run([(p, SamplingParams(max_new_tokens=n))
                           for p, n in zip(prompts, budgets)])
            assert got == want, (g, backend)
            # no graph on CPU tensors: looped runs the fused path eagerly
            assert eng.stats.graph_captures == eng.stats.graph_replays == 0
            if layout != "dense":
                assert eng.stats.grouped_requests > 0


def test_engine_decode_fusion_overrides_the_plan(bf16_model):
    _, tcfg, _, tp = bf16_model
    plan = make_plan("cuda", decode_fusion="fused")
    eng = Engine(tcfg, tp, plan=plan, device="cpu", max_seq=64)
    assert eng.decode_fusion == "fused" and eng.ctx.graphs is None
    eng = Engine(tcfg, tp, plan=plan, decode_fusion="looped", device="cpu",
                 max_seq=64)
    assert eng.decode_fusion == "looped"
    assert eng.plan.decode_fusion.granularity == "looped"
    assert eng.plan.fused_ffn == plan.fused_ffn
    assert isinstance(eng.ctx.graphs, LoopedDecode)
    assert Engine(tcfg, tp, device="cpu",
                  max_seq=64).decode_fusion == "split"
    with pytest.raises(ValueError, match="decode_fusion"):
        Engine(tcfg, tp, decode_fusion="unrolled", device="cpu", max_seq=64)


def test_serve_cli_decode_fusion_keeps_tokens(capsys):
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-seq", "96", "--max-new", "4", "--prompt-len", "20"]
    outs = {}
    for mode in ("split", "fused", "looped"):
        assert serve.main(base + ["--decode-fusion", mode]) == 0
        outs[mode] = capsys.readouterr().out
    reqs = {m: [ln for ln in o.splitlines() if ln.startswith("  req ")]
            for m, o in outs.items()}
    assert reqs["fused"] == reqs["split"] == reqs["looped"]
    assert len(reqs["split"]) == 3
    for mode, out in outs.items():
        assert f"fusion={mode}" in out
    assert "graphs=0/0" in outs["looped"] and "graphs=" not in outs["fused"]


# ---------------------------------------------------------------------------
# The looped graph cache's launch accounting, with a stand-in graph
# ---------------------------------------------------------------------------


class _Counter:
    def __init__(self):
        self.launches = 0


class _StubGraph:
    """Stands in for a captured CUDA graph: ``replay`` recomputes the
    step's output from the static inputs without touching a counter,
    as a real replay runs no Python wrapper."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        self.out.copy_(self.fn(**self.static))


class _StubLooped(LoopedDecode):
    def __init__(self, counters, fn):
        super().__init__(counters)
        self.fn = fn

    def _record(self, step, static):
        out = step(**static)            # capture: Python runs, counts
        return _StubGraph(self.fn, static, out), out


def test_looped_launch_accounting_with_a_stub_graph():
    a, b = _Counter(), _Counter()

    def step(tokens, groups):
        a.launches += 3                 # what the wrappers count
        b.launches += 1 if groups is None else 2
        return _math(tokens, groups)

    def _math(tokens, groups):
        return tokens * 2 + (0 if groups is None else groups.sum())

    looped = _StubLooped((a, b), _math)
    anchors = (1234,)

    def tick(tokens, groups=None):
        return looped.run(step, dict(tokens=tokens, groups=groups), anchors)

    t = torch.tensor([1, 2, 3])
    # first tick of a key: eager, counted by the wrappers themselves
    assert torch.equal(tick(t), t * 2)
    assert (a.launches, b.launches, looped.captures, looped.replays) == \
        (3, 1, 0, 0)
    # second: capture (its counts taken back) and one replay credited
    assert torch.equal(tick(t + 1), (t + 1) * 2)
    assert (a.launches, b.launches, looped.captures, looped.replays) == \
        (6, 2, 1, 1)
    # later ticks: copy into the static buffers and replay
    for i in range(3):
        assert torch.equal(tick(t + 5 + i), (t + 5 + i) * 2)
    assert (a.launches, b.launches, looped.captures, looped.replays) == \
        (15, 5, 1, 4)
    # another shape is another key: eager first, then its own graph
    g = torch.tensor([10, 20])
    assert torch.equal(tick(t, g), t * 2 + 30)
    assert torch.equal(tick(t, g + 1), t * 2 + 32)
    assert (a.launches, b.launches, looped.captures, looped.replays) == \
        (21, 9, 2, 5)
    assert torch.equal(tick(t), t * 2)        # back to the first graph
    assert (a.launches, b.launches, looped.replays) == (24, 10, 6)
    # other anchors (another cache or params) are another key as well
    assert torch.equal(looped.run(step, dict(tokens=t, groups=None), (9,)),
                       t * 2)
    assert looped.captures == 2 and (a.launches, b.launches) == (27, 11)
    assert looped.eager_ticks == 3
