"""The port's RWKV6 family (repro_torch.models.ssm) against the JAX
package's, on the CPU, at the smoke config (2 layers, d 128, 2 heads of
64), with params carried across from the JAX package's ``init_params``
by ``params_from_numpy`` and inputs made from a seed with numpy.

  * The time mix (chunked, with padding, a ragged ``valid`` mask and a
    carried state; and the recurrence step) and the channel mix (a
    sequence and one step), module by module.
  * ``prefill`` (logits and every cache leaf) and ``decode_step``; the
    padding invariance of ``prefill``; chunked equals stepwise.
  * The engine end to end: greedy tokens equal to the JAX engine's (f32,
    2 slots, ragged prompts), with bf16 and with int8 / fp8 weights
    (RWKV's projections are not weight keys: neither package quantizes
    them).

Tolerances: ``conftest.TOL`` per dtype (f32: the same math in another
summation order; bf16: the frameworks round at other points); whole-model
bf16 logits at MODEL_TOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs
from repro_torch.core.plan import make_plan
from repro_torch.models import ssm
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout, PagedLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

ARCH = "rwkv6-1.6b"
DTYPES = ["float32", "bfloat16"]
# whole-model logits in bf16 through two layers and the head
MODEL_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(rtol=3e-2, atol=6e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: under the
    suite's parallel workers, a pool of threads per process oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype):
    f = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **f),
            dataclasses.replace(configs.smoke(configs.get(arch)), **f))


_MODELS = {}


def model(arch, dtype):
    """(jcfg, tcfg, JAX params, the port's params), built once."""
    if (arch, dtype) not in _MODELS:
        jcfg, tcfg = cfgs(arch, dtype)
        jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.device_get(jp), device="cpu")
        _MODELS[arch, dtype] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch, dtype]


def layer0(jp, tp, key="layers"):
    """Layer 0's params in both trees."""
    return (jax.tree.map(lambda a: a[0], jp[key]),
            tree_map(lambda a: a[0], tp[key]))


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(np32(got), np32(want), **tol[dtype])


def inputs(shape, dtype, seed, scale=0.5):
    """The same normal draws for both frameworks, at ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def ctxs(jcfg, tcfg):
    """The JAX package's default context and the port's "cuda" plan (the
    kernels' plain versions on the CPU) with the FFN-up unfused, as the
    JAX default runs it: the fused kernel rounds act(g) * u once, where
    the split chain rounds g, u and act(g) first (the engine tests run
    the fused default)."""
    return (JLayerCtx(cfg=jcfg),
            LayerCtx(cfg=tcfg, plan=make_plan("cuda", fused_ffn=False)))


def cache_close(tcache, jcache, dtype, tol=TOL):
    """Every cache leaf's shape and dtype, and its values at ``tol``. In a
    bf16 model the f32 recurrent state sums products of activations that
    the frameworks already round differently, layer after layer, so only
    the f32 model holds it elementwise (the modules' own tests hold it at
    TOL in bf16)."""
    assert set(tcache) == set(jcache)
    for name in jcache:
        got, want = tcache[name], jcache[name]
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if dtype == "float32" or got.dtype != torch.float32:
            close(got, want, dtype, tol)


def engine_pair(arch, prompts, budgets, **kw):
    """Greedy outputs of the JAX engine and of the port's (f32 params,
    the "cuda" plan's plain versions on the CPU)."""
    jcfg, tcfg, jp, tp = model(arch, "float32")
    want = JEngine(jcfg, jp, **kw).run(
        [(p, JSamplingParams(max_new_tokens=n))
         for p, n in zip(prompts, budgets)])
    got = Engine(tcfg, tp, device="cpu", **kw).run(
        [(p, SamplingParams(max_new_tokens=n))
         for p, n in zip(prompts, budgets)])
    return got, want


def ragged_prompts(seed, lens, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["plain", "padded ragged carried"])
def test_time_mix_chunked_matches_reference(dtype, case):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jl, tl = layer0(jp, tp)
    jctx, tctx = ctxs(jcfg, tcfg)
    h, n = ssm._heads(tcfg)
    t = 64 if case == "plain" else 80       # 80 pads to two chunks
    jx, tx = inputs((2, t, tcfg.d_model), dtype, 1)
    kw_j, kw_t = {}, {}
    if case != "plain":
        valid = np.arange(t)[None, :] < np.array([[t], [37]])
        s0 = np.random.default_rng(2).standard_normal(
            (2, h, n, n)).astype(np.float32) * 0.1
        jlast, tlast = inputs((2, tcfg.d_model), dtype, 3)
        kw_j = dict(valid=jnp.asarray(valid), state0=jnp.asarray(s0),
                    last_x=jlast)
        kw_t = dict(valid=torch.from_numpy(valid),
                    state0=torch.from_numpy(s0), last_x=tlast)
    jo, js, jlx = jssm.time_mix_chunked(jctx, jl["tm"], jx,
                                        return_state=True, **kw_j)
    to, ts, tlx = ssm.time_mix_chunked(tctx, tl["tm"], tx,
                                       return_state=True, **kw_t)
    close(to, jo, dtype)
    close(ts, js, dtype)
    close(tlx, jlx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_time_mix_step_matches_reference(dtype):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jl, tl = layer0(jp, tp)
    jctx, tctx = ctxs(jcfg, tcfg)
    h, n = ssm._heads(tcfg)
    jx, tx = inputs((3, tcfg.d_model), dtype, 4)
    jlast, tlast = inputs((3, tcfg.d_model), dtype, 5)
    s = np.random.default_rng(6).standard_normal((3, h, n, n)).astype(
        np.float32) * 0.1
    jo, js, _ = jssm.time_mix_step(jctx, jl["tm"], jx, jnp.asarray(s), jlast)
    to, ts, tx2 = ssm.time_mix_step(tctx, tl["tm"], tx, torch.from_numpy(s),
                                    tlast)
    close(to, jo, dtype)
    close(ts, js, dtype)
    assert tx2 is tx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["sequence", "step"])
def test_channel_mix_matches_reference(dtype, form):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jl, tl = layer0(jp, tp)
    jctx, tctx = ctxs(jcfg, tcfg)
    shape = (2, 24, tcfg.d_model) if form == "sequence" else (2,
                                                               tcfg.d_model)
    jx, tx = inputs(shape, dtype, 7)
    jlast, tlast = inputs((2, tcfg.d_model), dtype, 8)
    if form == "sequence":
        jlast = tlast = None
    close(ssm.channel_mix(tctx, tl["cm"], tx, tlast),
          jssm.channel_mix(jctx, jl["cm"], jx, jlast), dtype)


def test_chunked_equals_stepwise():
    """The chunked form against the port's own recurrence step, token by
    token (the JAX package's test, 2e-3 in f32)."""
    _, tcfg, _, tp = model(ARCH, "float32")
    tl = tree_map(lambda a: a[0], tp["layers"])
    ctx = LayerCtx(cfg=tcfg)
    _, x = inputs((2, 48, tcfg.d_model), "float32", 9)
    out, s_end, _ = ssm.time_mix_chunked(ctx, tl["tm"], x, return_state=True)
    state = torch.zeros_like(s_end)
    last = torch.zeros((2, tcfg.d_model))
    outs = []
    for t in range(48):
        o, state, last = ssm.time_mix_step(ctx, tl["tm"], x[:, t], state,
                                           last)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s_end.numpy(), state.numpy(), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------


def prefill_pair(arch, dtype, lengths, t, s_max=128, seed=10):
    """Both packages' prefill on the same ragged prompts: (JAX logits,
    JAX cache, port logits, port cache, tokens)."""
    jcfg, tcfg, jp, tp = model(arch, dtype)
    jctx, tctx = ctxs(jcfg, tcfg)
    b = len(lengths)
    toks = np.random.default_rng(seed).integers(
        1, jcfg.vocab_size, (b, t)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jl, jc = japi.prefill(jctx, jp, jnp.asarray(toks), jnp.asarray(lens),
                          japi.init_cache(JDenseLayout(b, s_max)))
    tl, tc = tapi.prefill(tctx, tp, torch.from_numpy(toks),
                          torch.from_numpy(lens),
                          tapi.init_cache(DenseLayout(b, s_max),
                                          device="cpu"))
    return jl, jc, tl, tc, toks


def decode_pair(arch, dtype, jc, tc, lengths, seed=11):
    jcfg, tcfg, jp, tp = model(arch, dtype)
    jctx, tctx = ctxs(jcfg, tcfg)
    nxt = np.random.default_rng(seed).integers(
        1, jcfg.vocab_size, len(lengths)).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    jl, jc2 = jget_model(jcfg).decode_step(jctx, jp, jnp.asarray(nxt), jc,
                                           jnp.asarray(lens))
    tl, tc2 = get_model(tcfg).decode_step(tctx, tp, torch.from_numpy(nxt), tc,
                                          torch.from_numpy(lens))
    return jl, jc2, tl, tc2


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(dtype):
    jl, jc, tl, tc, _ = prefill_pair(ARCH, dtype, [64, 23, 1], 64)
    close(tl, jl, dtype, MODEL_TOL)
    cache_close(tc, jc, dtype, MODEL_TOL)
    jl2, jc2, tl2, tc2 = decode_pair(ARCH, dtype, jc, tc, [64, 23, 1])
    close(tl2, jl2, dtype, MODEL_TOL)
    cache_close(tc2, jc2, dtype, MODEL_TOL)


def test_prefill_is_padding_invariant():
    """Ragged prompts: padding after ``lengths`` changes neither the
    logits nor the state (the JAX package's test, at its tolerances)."""
    _, tcfg, _, tp = model(ARCH, "bfloat16")
    api, ctx = get_model(tcfg), LayerCtx(cfg=tcfg)
    rng = np.random.default_rng(1)
    prompt = rng.integers(1, tcfg.vocab_size, size=19).astype(np.int32)
    padded = np.concatenate([prompt, rng.integers(
        1, tcfg.vocab_size, size=45).astype(np.int32)])
    lens = torch.tensor([19], dtype=torch.int32)
    out = [api.prefill(ctx, tp, torch.from_numpy(p)[None], lens,
                       api.init_cache(DenseLayout(1, 128), device="cpu"))
           for p in (prompt, padded)]
    np.testing.assert_allclose(np32(out[0][0]), np32(out[1][0]), rtol=2e-2,
                               atol=2e-2)
    for name in out[0][1]:
        np.testing.assert_allclose(np32(out[0][1][name]),
                                   np32(out[1][1][name]), rtol=3e-2,
                                   atol=3e-2)


def test_init_params_draws_the_reference_tree():
    jcfg, tcfg = cfgs(ARCH, "bfloat16")
    tp = get_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                     device="cpu")
    shapes = jax.eval_shape(jget_model(jcfg).init_params,
                            jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    w = tp["layers"]["cm"]["w_v"]
    assert abs(w.float().std().item() - tcfg.d_ff ** -0.5) < \
        0.1 * tcfg.d_ff ** -0.5


def looped_parity(arch, prompts, budgets, **kw):
    """Greedy f32 tokens under ``decode_fusion="looped"``: the port's
    equal its own ``"split"`` run's and the JAX engine's looped run's
    (on CPU tensors the port runs the looped step eagerly)."""
    got, want = engine_pair(arch, prompts, budgets,
                            decode_fusion="looped", **kw)
    split, _ = engine_pair(arch, prompts, budgets, decode_fusion="split",
                           **kw)
    assert got == want == split


def test_paged_layout_and_looped_refused():
    """The paged layout is refused; ``"looped"`` serves the family (its
    tokens are split's and the JAX engine's)."""
    _, tcfg, _, tp = model(ARCH, "float32")
    api = get_model(tcfg)
    assert not api.supports_paged and not api.supports_chunked_prefill
    with pytest.raises(ValueError, match="no paged-KV path"):
        api.init_cache(PagedLayout(8, 16), device="cpu")
    with pytest.raises(ValueError, match="no paged-KV path"):
        Engine(tcfg, tp, cache_kind="paged", device="cpu")
    looped_parity(ARCH, ragged_prompts(11, (19, 9, 70)), [6, 5, 6],
                  num_slots=2, max_seq=128)


# ---------------------------------------------------------------------------
# The engine end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", ["split", "fused"])
def test_engine_matches_reference_engine(fusion):
    """Greedy f32 serving, 2 slots, ragged prompts (one past a 64-token
    bucket): the port's tokens are the JAX engine's. "fused" calls no
    fused seam in this family, so it serves as "split" does."""
    prompts = ragged_prompts(7, (19, 9, 90, 70, 5))
    got, want = engine_pair(ARCH, prompts, [8, 6, 8, 5, 7], num_slots=2,
                            max_seq=128, decode_fusion=fusion)
    assert got == want


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_quantized_engine_matches_reference_engine(wd):
    """int8 / fp8 weights: the JAX engine serves this family, quantizing
    no leaf of it (its projections are not weight keys); so does the
    port, token for token, and the same as bf16."""
    prompts = ragged_prompts(8, (12, 33, 7))
    got, want = engine_pair(ARCH, prompts, [6, 5, 6], num_slots=2,
                            max_seq=96, weight_dtype=wd)
    plain, _ = engine_pair(ARCH, prompts, [6, 5, 6], num_slots=2,
                           max_seq=96)
    assert got == want == plain


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_serve_cli_serves_the_family(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ...`` serves the smoke
    config of each slice 7b family on the CPU; ``--cache-kind paged``
    refuses it."""
    from repro_torch.launch import serve
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-seq", "128", "--max-new", "3",
            "--prompt-len", "70"]
    assert serve.main(args) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "req 2:" in out
    with pytest.raises(ValueError, match="no paged-KV path"):
        serve.main(args + ["--cache-kind", "paged"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_serve_cli_serves_the_family_looped(arch, capsys):
    """``--decode-fusion looped`` serves each slice 7b family on the CPU
    with the ``req N:`` lines of ``--decode-fusion split``."""
    from repro_torch.launch import serve
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--max-seq", "128", "--max-new", "3",
            "--prompt-len", "70", "--decode-fusion"]

    def reqs(fusion):
        assert serve.main(args + [fusion]) == 0
        out = capsys.readouterr().out
        assert f"fusion={fusion}" in out
        return [ln for ln in out.splitlines() if ln.lstrip().startswith("req ")]

    looped = reqs("looped")
    assert len(looped) == 3 and looped == reqs("split")
