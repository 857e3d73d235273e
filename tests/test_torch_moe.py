"""The port's MoE family (repro_torch.models.moe) on the CPU.

  * ``moe_block`` against the JAX package's on inputs made from a seed with
    numpy and weights from its ``moe_params``: zero-drop, capacity 1.25
    with drops, groups 1 and 2, gated (dbrx) and ungated gelu (grok-1);
    the chosen experts equal, the outputs within ``conftest.TOL``, the aux
    within 1e-6.
  * ``prefill``, ``decode_step`` and ``prefill_chunk`` against the JAX
    package's on both smoke configs, params converted from its
    ``moe.init_params(PRNGKey(0))``; the engine's greedy tokens against
    its engine's, dense and paged.
  * Within the port: paged = dense bitwise; looped = fused on the CPU; the
    combine bitwise run to run and in a fixed order; int8 / fp8 weights
    refused; every ``ops.matmul`` call of a MoE serve at a
    ``called_gemm_shapes`` shape; the dense family's steps unchanged by
    the block hooks.
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
from repro.models import moe as jmoe
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs
from repro_torch.core import dispatch
from repro_torch.core.plan import make_plan
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

ARCHS = ["dbrx-132b", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: under the
    suite's parallel workers, a pool of threads per process oversubscribes
    the cores and each parallel region waits on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype):
    f = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **f),
            dataclasses.replace(configs.smoke(configs.get(arch)), **f))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol[dtype])


# whole-model logits in bf16: the expert products and activations round to
# bf16 in each framework's own order (XLA rounds silu's sigmoid before the
# product, torch once after it), and two MoE layers and the untied head
# carry that; f32 stays at conftest.TOL
MODEL_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(rtol=3e-2, atol=6e-2)}


# ---------------------------------------------------------------------------
# moe_block against the reference
# ---------------------------------------------------------------------------


def _block_inputs(jcfg, tcfg, dtype, skew, seed=0, b=4, s=32):
    jp = jmoe.moe_params(jcfg, jax.random.PRNGKey(seed + 1))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    if skew:
        # a common component along expert 0's router column sends most
        # tokens there, so capacity 1.25 drops pairs
        col = np.asarray(jp["router"])[:, 0]
        x += 3.0 * col / np.linalg.norm(col)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jp, tp, jx, tx


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["zero_drop", "cap1.25_drops"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_block_matches_reference(arch, dtype, mode, groups):
    jcfg, tcfg = _cfgs(arch, dtype)
    zero = mode == "zero_drop"
    jp, tp, jx, tx = _block_inputs(jcfg, tcfg, dtype, skew=not zero)
    e, k = jcfg.moe.num_experts, jcfg.moe.num_experts_per_tok

    # the chosen experts, group by group, exactly the reference's
    g = groups
    tg = tx.shape[0] * tx.shape[1] // g
    jl = jnp.einsum("gtd,de->gte",
                    jx.reshape(g, tg, -1).astype(jnp.float32), jp["router"])
    _, jidx = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), k)
    _, _, tidx = moe.route(tp["router"], tx.reshape(g, tg, -1), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    cap = moe.capacity(tg, k, e, 1.25, zero)
    counts = np.stack([np.bincount(np.asarray(jidx)[i].ravel(), minlength=e)
                       for i in range(g)])
    if zero:
        assert counts.max() <= cap
    else:
        assert counts.max() > cap, "the skew should overflow an expert"

    jout, jaux = jmoe.moe_block(JLayerCtx(cfg=jcfg), jp, jx, groups=groups,
                                zero_drop=zero)
    tout, taux = moe.moe_block(LayerCtx(cfg=tcfg), tp, tx, groups=groups,
                               zero_drop=zero)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    _close(tout, jout, dtype)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_moe_block_group_count_halves_until_it_divides():
    """Groups that do not divide the tokens halve, as in the reference:
    6 tokens in 4 groups run as 2 groups of 3."""
    jcfg, tcfg = _cfgs("dbrx-132b", "float32")
    jp, tp, jx, tx = _block_inputs(jcfg, tcfg, "float32", False, b=2, s=3)
    jout, _ = jmoe.moe_block(JLayerCtx(cfg=jcfg), jp, jx, groups=4)
    tout, _ = moe.moe_block(LayerCtx(cfg=tcfg), tp, tx, groups=4)
    _close(tout, jout, "float32")


def test_capacity_matches_reference_rule():
    for tg, k, e, cf in [(15, 2, 4, 1.25), (128, 4, 16, 1.25),
                         (4096, 4, 16, 2.0), (3, 2, 4, 1.25)]:
        cap = int(-(-tg * k * cf // e))
        cap = min(max(8, -(-cap // 8) * 8), tg * k)
        assert moe.capacity(tg, k, e, cf, False) == cap
        assert moe.capacity(tg, k, e, cf, True) == tg * k


def test_topk_ties_go_to_the_lower_expert():
    """Equal router logits pick the lower expert indices, as
    ``lax.top_k`` does."""
    router = torch.zeros((8, 6))
    router[:, 4] = 1.0
    x = torch.ones((1, 3, 8))
    _, w, idx = moe.route(router, x, 3)
    assert idx.tolist() == [[[4, 0, 1]] * 3]
    assert torch.allclose(w.sum(-1), torch.ones(1, 3))


def test_combine_is_bitwise_run_to_run_and_ordered():
    """The combine adds each token's rows in ascending expert order with
    no atomics: the same bits every run, and the bits of the ordered sum
    written out by hand."""
    jcfg, tcfg = _cfgs("dbrx-132b", "bfloat16")
    _, tp, _, tx = _block_inputs(jcfg, tcfg, "bfloat16", False)
    ctx = LayerCtx(cfg=tcfg)
    outs = [moe.moe_block(ctx, tp, tx, zero_drop=True)[0]
            for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)

    # the same sum by hand: every expert's FFN on every token, weighted,
    # then added in ascending expert order in bf16
    k = tcfg.moe.num_experts_per_tok
    xg = tx.reshape(1, -1, tcfg.d_model)
    _, w, idx = moe.route(tp["router"], xg, k)
    x2 = xg[0]
    acc = None
    order = idx[0].argsort(-1)
    for j in range(k):
        sel = idx[0].gather(1, order[:, j:j + 1])[:, 0]
        wj = w[0].gather(1, order[:, j:j + 1])[:, 0]
        rows = []
        for t in range(x2.shape[0]):
            e_ = int(sel[t])
            h = (torch.nn.functional.silu(x2[t:t + 1] @ tp["w_gate"][e_])
                 * (x2[t:t + 1] @ tp["w_up"][e_]))
            rows.append((h @ tp["w_down"][e_])
                        * wj[t].to(torch.bfloat16))
        term = torch.cat(rows)
        acc = term if acc is None else acc + term
    assert torch.equal(outs[0].reshape(-1, tcfg.d_model), acc)


# ---------------------------------------------------------------------------
# Model steps against the reference (params from its init_params)
# ---------------------------------------------------------------------------


def _model(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_converted_params_keep_the_reference_tree():
    jcfg, tcfg, jp, tp = _model("dbrx-132b", "bfloat16")
    m = tp["layers"]["moe"]
    e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    assert tuple(m["router"].shape) == (2, d, e)
    assert m["router"].dtype == torch.float32
    assert tuple(m["w_gate"].shape) == (2, e, d, f)
    assert tuple(m["w_down"].shape) == (2, e, f, d)
    assert "lm_head" in tp


def test_init_params_draws_the_reference_tree():
    """The port's own init: the reference's tree, shapes and dtypes, the
    router f32 but bf16-representable, stds about fan_in^-1/2."""
    jcfg, tcfg = _cfgs("dbrx-132b", "bfloat16")
    gen = torch.Generator().manual_seed(0)
    tp = get_model(tcfg).init_params(gen, device="cpu")
    shapes = jax.eval_shape(lambda key: jmoe.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: 0, tp)))
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
    r = tp["layers"]["moe"]["router"]
    assert torch.equal(r, r.bfloat16().float())
    assert abs(float(r.std()) - tcfg.d_model ** -0.5) < 0.01
    wd = tp["layers"]["moe"]["w_down"].float()
    assert abs(float(wd.std()) - tcfg.d_ff ** -0.5) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_then_decode_matches_reference(arch, backend, dtype):
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jctx = JLayerCtx(cfg=jcfg)
    tctx = LayerCtx(cfg=tcfg, plan=make_plan(backend))
    rng = np.random.default_rng(1)
    b, c, s_max = 2, 16, 48
    tokens = rng.integers(1, jcfg.vocab_size, (b, c)).astype(np.int32)
    chunk_lens = np.array([16, 11], np.int32)
    lengths = np.zeros((b,), np.int32)
    jcache = japi.init_cache(JDenseLayout(b, s_max))
    jl, jcache = japi.prefill_chunk(jctx, jp, jnp.asarray(tokens),
                                    jnp.asarray(chunk_lens), jcache,
                                    jnp.asarray(lengths))
    tcache = tapi.init_cache(DenseLayout(b, s_max), device="cpu")
    tl, tcache = tapi.prefill_chunk(tctx, tp, torch.from_numpy(tokens),
                                    torch.from_numpy(chunk_lens), tcache,
                                    torch.from_numpy(lengths))
    _close(tl, jl, dtype, MODEL_TOL)
    _close(tcache["k"][:, 0, :16], jcache["k"][:, 0, :16], dtype)
    _close(tcache["v"][:, 1, :11], jcache["v"][:, 1, :11], dtype)
    nxt = np.array([5, 77], np.int32)
    jl, _ = japi.decode_step(jctx, jp, jnp.asarray(nxt), jcache,
                             jnp.asarray(chunk_lens))
    tl, _ = tapi.decode_step(tctx, tp, torch.from_numpy(nxt), tcache,
                             torch.from_numpy(chunk_lens))
    _close(tl, jl, dtype, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(arch, dtype):
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(2)
    b, s, s_max = 2, 24, 32
    tokens = rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([24, 9], np.int32)
    jl, jcache = japi.prefill(JLayerCtx(cfg=jcfg), jp, jnp.asarray(tokens),
                              jnp.asarray(lengths),
                              japi.init_cache(JDenseLayout(b, s_max)))
    tl, tcache = tapi.prefill(LayerCtx(cfg=tcfg, plan=make_plan("cuda")),
                              tp, torch.from_numpy(tokens),
                              torch.from_numpy(lengths),
                              tapi.init_cache(DenseLayout(b, s_max),
                                              device="cpu"))
    _close(tl, jl, dtype, MODEL_TOL)
    _close(tcache["k"][:, :, :s], jcache["k"][:, :, :s], dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_kind", ["dense", "paged"])
def test_engine_matches_reference_engine(arch, cache_kind):
    """Greedy serving in f32: the port's engine gives the reference
    engine's tokens, on the dense cache and on the paged pool with prefix
    sharing (a shared header, preemption-free)."""
    jcfg, tcfg, jp, tp = _model(arch, "float32")
    rng = np.random.default_rng(7)
    header = rng.integers(1, 500, size=16)
    prompts = [np.concatenate([header, rng.integers(1, 500, size=n)]).astype(
        np.int32) for n in (5, 21, 9, 30, 3)]
    budgets = [6, 3, 8, 4, 5]
    kw = dict(num_slots=2, max_seq=96, prefill_chunk=16)
    if cache_kind == "paged":
        kw.update(cache_kind="paged", page_size=16, prefix_sharing=True)
    jeng = JEngine(jcfg, jp, plan=jmake_plan(fused_threshold=1), **kw)
    want = jeng.run([(p, JSamplingParams(max_new_tokens=m))
                     for p, m in zip(prompts, budgets)])
    teng = Engine(tcfg, tp, plan=make_plan("cuda", fused_threshold=1),
                  device="cpu", **kw)
    got = teng.run([(p, SamplingParams(max_new_tokens=m))
                    for p, m in zip(prompts, budgets)])
    assert got == want
    assert teng.ticks == jeng.ticks
    if cache_kind == "paged":
        assert teng.stats.shared_prefix_pages == \
            jeng.stats.shared_prefix_pages > 0


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dbrx_bf16():
    cfg = configs.smoke(configs.get("dbrx-132b"))
    gen = torch.Generator().manual_seed(0)
    return cfg, get_model(cfg).init_params(gen, device="cpu")


def _serve(cfg, params, n=4, budget=6, **kw):
    rng = np.random.default_rng(11)
    header = rng.integers(1, cfg.vocab_size, size=32)
    reqs = [(np.concatenate([header, rng.integers(
        1, cfg.vocab_size, size=int(t))]).astype(np.int32),
        SamplingParams(max_new_tokens=budget))
        for t in rng.integers(3, 40, size=n)]
    kw.setdefault("num_slots", 4)
    return Engine(cfg, params, max_seq=128, prefill_chunk=16, device="cpu",
                  **kw).run(reqs)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paged_equals_dense_bitwise(dbrx_bf16, backend):
    """bf16 greedy tokens: paged (gather and fused, sharing on and off)
    equal the dense cache's under D's gather discipline; on the "torch"
    plan the fused pool too."""
    cfg, params = dbrx_bf16
    gather = make_plan(backend, gather_chunk="dense")
    base = _serve(cfg, params, plan=gather)
    paged = dict(cache_kind="paged", page_size=16)
    assert _serve(cfg, params, plan=gather, **paged) == base
    assert _serve(cfg, params, plan=gather, prefix_sharing=True,
                  **paged) == base
    fused = make_plan(backend, fused_threshold=1)
    assert _serve(cfg, params, plan=fused, **paged) == _serve(
        cfg, params, plan=fused, prefix_sharing=True, **paged)


def test_looped_equals_fused_and_split_on_cpu(dbrx_bf16):
    cfg, params = dbrx_bf16
    paged = dict(cache_kind="paged", page_size=16, prefix_sharing=True)
    fused = _serve(cfg, params, decode_fusion="fused", **paged)
    assert _serve(cfg, params, decode_fusion="looped", **paged) == fused
    assert _serve(cfg, params, decode_fusion="looped") == _serve(
        cfg, params, decode_fusion="fused")


def test_moe_composes_with_tiers_grouping_and_kv_pages(dbrx_bf16):
    """bf16 MoE serves with tiers (two rounds through the host tier),
    grouped decode and int8 KV pages, the tier round trip bitwise."""
    cfg, params = dbrx_bf16
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, cfg.vocab_size, size=40).astype(np.int32),
             SamplingParams(max_new_tokens=5)) for _ in range(3)]
    kw = dict(num_slots=4, max_seq=128, prefill_chunk=16, page_size=16,
              cache_kind="paged", prefix_sharing=True, kv_dtype="int8",
              plan=make_plan("cuda", decode_group="grouped"), device="cpu")
    base = Engine(cfg, params, **kw).run(list(reqs))
    eng = Engine(cfg, params, host_pages=32, **kw)
    r1 = eng.run(list(reqs))
    eng.evict_finished(flush=True)
    r2 = eng.run(list(reqs))
    assert [r1[k] for k in sorted(r1)] == [base[k] for k in sorted(base)]
    assert [r2[k] for k in sorted(r2)] == [base[k] for k in sorted(base)]
    assert eng.stats.promoted_pages > 0 and eng.stats.session_hits > 0


@pytest.mark.parametrize("weight_dtype", ["int8", "fp8"])
def test_quantized_moe_weights_are_refused(dbrx_bf16, weight_dtype):
    cfg, params = dbrx_bf16
    with pytest.raises(ValueError, match="expert"):
        Engine(cfg, params, weight_dtype=weight_dtype, device="cpu")
    with pytest.raises(ValueError, match="expert"):
        Engine(cfg, params, plan=make_plan("cuda", weight_dtype=weight_dtype),
               device="cpu")


def test_serve_calls_only_called_gemm_shapes(dbrx_bf16, monkeypatch):
    """Every ops.matmul a MoE serve makes (split and fused stages, chunk
    and one-shot prefill) has its (K, N) in called_gemm_shapes, at
    dbrx-132b's smoke widths and the reference's untied head."""
    cfg, params = dbrx_bf16
    seen = set()
    real = ops.matmul

    def recording(x, w, **kw):
        out = real(x, w, **kw)
        seen.add((x.shape[-1], out.shape[-1]))
        return out

    monkeypatch.setattr(ops, "matmul", recording)
    for kw in (dict(), dict(decode_fusion="fused"),
               dict(cache_kind="paged", page_size=16)):
        _serve(cfg, params, n=2, budget=3, **kw)
    Engine(cfg, params, max_seq=128, prefill_chunk=0, device="cpu").run(
        [np.arange(1, 20, dtype=np.int32)])
    called = {(s.k, s.n) for s in dispatch.called_gemm_shapes(cfg)}
    assert seen == called


def test_dense_steps_unchanged_by_the_hooks():
    """The dense family through the hooked steps is bitwise the steps
    with their own blocks named explicitly."""
    cfg = configs.smoke(configs.get("qwen2-0.5b"))
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        device="cpu")
    ctx = LayerCtx(cfg=cfg, plan=make_plan("cuda", decode_fusion="fused"))
    toks = torch.arange(1, 17, dtype=torch.int32).reshape(2, 8)
    out = []
    for kw in (dict(), dict(chunk_block_fn=tfm.chunk_block)):
        cache = tfm.init_cache(cfg, DenseLayout(2, 32), device="cpu")
        lg, cache = tfm.prefill_chunk(ctx, params, toks,
                                      torch.tensor([8, 5], dtype=torch.int32),
                                      cache, torch.zeros(2, dtype=torch.int32),
                                      **kw)
        dk = {} if not kw else dict(decode_block_fn=tfm.decode_block)
        lg2, _ = tfm.decode_step(ctx, params, torch.tensor([3, 4]).int(),
                                 cache, torch.tensor([8, 5]).int(), **dk)
        out.append((lg, lg2, cache["k"].clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_moe_family_is_served_and_others_still_refused():
    """The MoE family has the paged pool and chunked prefill; the
    families of slice 7b are served too, dense-only with one-shot
    prefill, as in the JAX package."""
    api = get_model(configs.smoke(configs.get("dbrx-132b")))
    assert api.supports_paged and api.supports_chunked_prefill
    for arch in ("rwkv6-1.6b", "hymba-1.5b", "whisper-tiny"):
        api = get_model(configs.smoke(configs.get(arch)))
        assert not api.supports_paged
        assert not api.supports_chunked_prefill


_MOE_TIERS = ["--arch", "dbrx-132b", "--smoke", "--cache-kind", "paged",
              "--prefix-sharing", "--host-pages", "16", "--rounds", "2",
              "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--page-size", "16",
                                        "--prefill-chunk", "16"]],
                         ids=["defaults", "16-row-pages"])
def test_serve_cli_moe_rounds_hit_the_session_cache(extra, capsys):
    """The MoE smoke model serves two rounds through the host tier. With
    the default 64-row pages the 48-token prompts fill no page, so there
    is nothing to retain; with 16-row pages round 2 re-maps round 1's
    retained pages."""
    from repro_torch.launch import serve

    def summary(argv):
        assert serve.main(argv) == 0
        line = next(ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("served"))
        words = line.split()
        return line, int(words[1]), int(words[3])

    one, reqs1, toks1 = summary(_MOE_TIERS[:-4] + ["--rounds", "1"]
                                + _MOE_TIERS[-2:] + extra)
    line, reqs2, toks2 = summary(_MOE_TIERS + extra)
    # the summary counts every round's requests and tokens, as its time
    # and tick counts do; round 2 returns round 1's tokens
    assert reqs1 == 16 and toks1 > 0, one
    assert (reqs2, toks2) == (2 * reqs1, 2 * toks1), line
    hits = int(line.split(" session hits")[0].rsplit(" ", 1)[1])
    assert (hits > 0) == bool(extra), line


def test_serve_cli_refuses_tiers_without_sharing():
    from repro_torch.launch import serve

    with pytest.raises(ValueError,
                       match="tiered KV needs prefix_sharing=True"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--cache-kind",
                    "paged", "--host-pages", "0", "--device", "cpu"])
