"""The port's Hymba family (repro_torch.models.hybrid) against the JAX
package's, on the CPU, at the smoke config (2 layers, d 128, 4 / 2 heads
of 32, window 64, SSM state 16 and expand 2), with params carried across
from the JAX package's ``init_params`` by ``params_from_numpy`` and
inputs made from a seed with numpy.

  * The SSD SSM (chunked, with padding, a ragged ``valid`` mask and a
    carried state; one step), the ring attention (T1 unified, the
    overflow recompute forced, and sync; rows before, at and past the
    ring's wrap) and ``_ring_from_prefill``, module by module.
  * ``prefill`` (logits and every cache leaf) and ``decode_step``; the
    padding invariance of ``prefill``; chunked equals stepwise.
  * The engine end to end: greedy tokens equal to the JAX engine's (f32,
    2 slots, ragged prompts, two of them longer than the window, so the
    ring wraps), also with int8 / fp8 weights, whose logits stay within
    ``quant.logits_guard_tol`` of bf16.

Tolerances: ``conftest.TOL`` per dtype, module by module and for the f32
model; the bf16 model's cache at MODEL_TOL (test_torch_ssm.py) and its
logits within BF16_LOGITS_SHARE of their range.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import make_plan as jmake_plan
from repro.models import hybrid as jhybrid
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch.core.plan import make_plan
from repro_torch.kernels import quant
from repro_torch.models import hybrid
from repro_torch.models import wquant
from repro_torch.models.api import get_model
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map
from test_torch_ssm import (DTYPES, MODEL_TOL, cache_close, close, ctxs,
                            decode_pair, engine_pair, inputs, layer0,
                            looped_parity, model,
                            np32, prefill_pair, ragged_prompts)

ARCH = "hymba-1.5b"
# bf16 whole-model logits, as a share of their range: at init the SSM
# path adds outputs of magnitude ~10 to the residual stream, where a bf16
# ulp is 1/16, and the frameworks round its sums at other points, so
# after the final norm the logits carry a few such ulps (the f32 model
# holds them at TOL, and every module holds TOL in bf16)
BF16_LOGITS_SHARE = 0.1


def logits_close(got, want, dtype):
    if dtype == "float32":
        close(got, want, dtype, MODEL_TOL)
        return
    err = np.abs(np32(got) - np32(want)).max()
    assert err <= BF16_LOGITS_SHARE * max(np.abs(np32(want)).max(), 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors (see
    test_torch_ssm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["plain", "padded ragged carried"])
def test_ssm_chunked_matches_reference(dtype, case):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jl, tl = layer0(jp, tp)
    jctx, tctx = ctxs(jcfg, tcfg)
    inner, hm, n = hybrid._ssm_dims(tcfg)
    t = 64 if case == "plain" else 100      # 100 pads to two chunks
    jx, tx = inputs((2, t, tcfg.d_model), dtype, 1)
    kw_j, kw_t = {}, {}
    if case != "plain":
        valid = np.arange(t)[None, :] < np.array([[t], [41]])
        s0 = np.random.default_rng(2).standard_normal(
            (2, hm, hybrid.SSM_HEAD, n)).astype(np.float32) * 0.1
        kw_j = dict(valid=jnp.asarray(valid), state0=jnp.asarray(s0))
        kw_t = dict(valid=torch.from_numpy(valid),
                    state0=torch.from_numpy(s0))
    jo, js = jhybrid.ssm_chunked(jctx, jl["ssm"], jx, return_state=True,
                                 **kw_j)
    to, ts = hybrid.ssm_chunked(tctx, tl["ssm"], tx, return_state=True,
                                **kw_t)
    close(to, jo, dtype)
    close(ts, js, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_step_matches_reference(dtype):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jl, tl = layer0(jp, tp)
    jctx, tctx = ctxs(jcfg, tcfg)
    inner, hm, n = hybrid._ssm_dims(tcfg)
    jx, tx = inputs((3, tcfg.d_model), dtype, 4)
    s = np.random.default_rng(5).standard_normal(
        (3, hm, hybrid.SSM_HEAD, n)).astype(np.float32) * 0.1
    jo, js = jhybrid.ssm_step(jctx, jl["ssm"], jx, jnp.asarray(s))
    to, ts = hybrid.ssm_step(tctx, tl["ssm"], tx, torch.from_numpy(s))
    close(to, jo, dtype)
    close(ts, js, dtype)


def test_ssd_chunked_equals_stepwise():
    """The chunked SSD against the port's own step, token by token (the
    JAX package's test, 2e-3 in f32)."""
    _, tcfg, _, tp = model(ARCH, "float32")
    tl = tree_map(lambda a: a[0], tp["layers"])
    ctx = LayerCtx(cfg=tcfg)
    inner, hm, n = hybrid._ssm_dims(tcfg)
    _, x = inputs((2, 32, tcfg.d_model), "float32", 9)
    out, s_end = hybrid.ssm_chunked(ctx, tl["ssm"], x, return_state=True)
    state = torch.zeros((2, hm, hybrid.SSM_HEAD, n))
    outs = []
    for t in range(32):
        o, state = hybrid.ssm_step(ctx, tl["ssm"], x[:, t], state)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s_end.numpy(), state.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["unified", "unified overflow", "sync"])
def test_ring_decode_attention_matches_reference(dtype, mode):
    """Rows before the ring is full, exactly full, wrapped once and past
    a second wrap; "unified overflow" scales q so that max(s − φ) passes
    the band and the recompute's result is taken."""
    jcfg, tcfg, _, _ = model(ARCH, dtype)
    scheme = "sync" if mode == "sync" else "unified_max"
    jctx = JLayerCtx(cfg=jcfg, plan=jmake_plan(scheme=scheme))
    tctx = LayerCtx(cfg=tcfg, plan=make_plan("cuda", scheme=scheme))
    w, hq, hk, hd = 64, tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
    scale = 100.0 if mode == "unified overflow" else 1.0
    jq, tq = inputs((4, hq, hd), dtype, 6, scale=scale)
    jk, tk = inputs((4, w, hk, hd), dtype, 7)
    jv, tv = inputs((4, w, hk, hd), dtype, 8)
    lens = np.array([5, w, w + 9, 2 * w + 3], np.int32)
    s = torch.einsum("bhd,bkhd->bhk", tq.float() * hd ** -0.5,
                     tk.repeat_interleave(hq // hk, dim=2).float())
    band = tcfg.softmax_phi.band[1] + tcfg.softmax_phi.phi
    assert (s.max().item() > band) == (mode == "unified overflow")
    want = jhybrid.ring_decode_attention(jctx, jq, jk, jv, jnp.asarray(lens))
    got = hybrid.ring_decode_attention(tctx, tq, tk, tv,
                                       torch.from_numpy(lens))
    close(got, want, dtype)
    assert torch.isfinite(got).all()


def test_ring_from_prefill_matches_reference():
    """Rows shorter than the ring, equal to it and past it, from a batch
    padded past every row."""
    rng = np.random.default_rng(12)
    k = rng.standard_normal((4, 150, 2, 8)).astype(np.float32)
    lens = np.array([7, 64, 100, 150], np.int32)
    want = jhybrid._ring_from_prefill(jnp.asarray(k), jnp.asarray(lens), 64)
    got = hybrid._ring_from_prefill(torch.from_numpy(k),
                                    torch.from_numpy(lens), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_reference(dtype):
    """Prompts shorter than the window and longer (the ring keeps each
    row's last 64 valid positions), then decode steps that write past
    the ring's wrap."""
    lens = [100, 23, 70]
    jl, jc, tl, tc, _ = prefill_pair(ARCH, dtype, lens, 128)
    logits_close(tl, jl, dtype)
    cache_close(tc, jc, dtype, MODEL_TOL)
    for step in range(2):
        jl, jc, tl, tc = decode_pair(ARCH, dtype, jc, tc,
                                     [n + step for n in lens], seed=step)
        logits_close(tl, jl, dtype)
        cache_close(tc, jc, dtype, MODEL_TOL)


def test_prefill_is_padding_invariant():
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


def test_ring_width_is_the_window_at_most_max_seq():
    _, tcfg, _, _ = model(ARCH, "float32")
    api = get_model(tcfg)
    assert api.init_cache(DenseLayout(2, 128), device="cpu")["k"].shape[2] \
        == tcfg.sliding_window == 64
    assert api.init_cache(DenseLayout(2, 48), device="cpu")["k"].shape[2] \
        == 48


# ---------------------------------------------------------------------------
# The engine end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", ["split", "fused"])
def test_engine_matches_reference_engine(fusion):
    """Greedy f32 serving, 2 slots, ragged prompts, two longer than the
    64-token window: the port's tokens are the JAX engine's."""
    prompts = ragged_prompts(7, (19, 9, 90, 70, 5))
    got, want = engine_pair(ARCH, prompts, [8, 6, 8, 5, 7], num_slots=2,
                            max_seq=128, decode_fusion=fusion)
    assert got == want


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_quantized_engine_matches_reference_engine(wd):
    """int8 / fp8 weights (the attention, MLP and the SSM's w_gate are
    weight keys): the JAX engine serves them, and the port's tokens are
    its tokens."""
    prompts = ragged_prompts(8, (12, 80, 7))
    got, want = engine_pair(ARCH, prompts, [6, 5, 6], num_slots=2,
                            max_seq=128, weight_dtype=wd)
    assert got == want


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_quantized_logits_within_the_guard(wd):
    """Prefill and decode logits with quantized weights on the "torch"
    plan within logits_guard_tol(spec) x max(|logits|, 1) of the bf16
    logits."""
    _, tcfg, _, tp = model(ARCH, "bfloat16")
    api = get_model(tcfg)
    spec = quant.spec_for(wd)
    qp = wquant.quantize_params(tp, spec)
    assert isinstance(qp["layers"]["ssm"]["w_gate"], dict)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, 500, (2, 80)).astype(np.int32))
    lens = torch.tensor([80, 33], dtype=torch.int32)
    out = {}
    for name, params in (("bf16", tp), ("q", qp)):
        ctx = LayerCtx(tcfg, make_plan("torch"))
        cache = api.init_cache(DenseLayout(2, 128), device="cpu")
        l1, cache = api.prefill(ctx, params, toks, lens, cache)
        l2, _ = api.decode_step(ctx, params, toks[:, 0], cache, lens)
        out[name] = torch.cat([l1, l2])[:, :tcfg.vocab_size].float()
    tol = quant.logits_guard_tol(spec) * max(
        out["bf16"].abs().max().item(), 1.0)
    assert (out["q"] - out["bf16"]).abs().max().item() <= tol


def test_looped_is_refused():
    """No longer refused: ``decode_fusion="looped"`` serves the family,
    its greedy tokens equal to split's and to the JAX engine's."""
    looped_parity(ARCH, ragged_prompts(12, (19, 90, 70)), [6, 5, 6],
                  num_slots=2, max_seq=128)
