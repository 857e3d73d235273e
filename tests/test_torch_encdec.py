"""The port's Whisper family (repro_torch.models.encdec) and the layer
pieces it brought (layernorm, the ungated GELU MLP, ``attention_block``
with ``causal`` / ``use_rope`` / ``kv_x``, ``attention_decode_block``)
against the JAX package's, on the CPU, at the smoke config (2 + 2 layers,
d 128, 4 / 2 heads of 32, layernorm, GELU), with params carried across
from the JAX package's ``init_params`` by ``params_from_numpy`` and
inputs made from a seed with numpy.

  * Module by module: the norm, the MLP, the encoder's non-causal
    attention block, cross-attention (Sq ≠ Sk, no rope), the one-token
    decode block, ``encode`` and the cross keys and values
    (``attention_qkv`` with ``kv_x``, against the JAX ``_cross_kv``).
  * ``prefill`` (with frames and with the engine's zero frames; logits
    and every cache leaf) and ``decode_step``.
  * The engine end to end: greedy tokens equal to the JAX engine's (f32,
    2 slots, ragged prompts), also with int8 / fp8 weights.

Tolerances: ``conftest.TOL`` per dtype; whole-model bf16 logits at
MODEL_TOL (test_torch_ssm.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro_torch.models import encdec
from repro_torch.models import layers as TL
from repro_torch.models.api import get_model
from repro_torch.models.kvlayout import DenseLayout
from test_torch_ssm import (DTYPES, MODEL_TOL, cache_close, close, ctxs,
                            decode_pair, engine_pair, inputs, layer0,
                            looped_parity, model,
                            ragged_prompts)

ARCH = "whisper-tiny"
ENC = 96                    # encoder frames at smoke size (serving: 1,500)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors (see
    test_torch_ssm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dtype):
    jcfg, tcfg, jp, tp = model(ARCH, dtype)
    jctx, tctx = ctxs(jcfg, tcfg)
    return jcfg, tcfg, jp, tp, jctx, tctx


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    jcfg, tcfg, jp, tp, jctx, tctx = _setup(dtype)
    jl, tl = layer0(jp, tp)
    rng = np.random.default_rng(3)
    jl["mlp_norm"] = {k: jnp.asarray(rng.normal(1.0, 0.2, v.shape)).astype(
        v.dtype) for k, v in jl["mlp_norm"].items()}
    tl["mlp_norm"] = {k: torch.from_numpy(np.array(
        v.astype(jnp.float32))).to(getattr(torch, dtype))
        for k, v in jl["mlp_norm"].items()}
    assert set(tl["mlp_norm"]) == {"scale", "bias"}
    jx, tx = inputs((2, 12, tcfg.d_model), dtype, 1, scale=2.0)
    jh = JL.norm(jcfg, jl["mlp_norm"], jx)
    th = TL.norm(tcfg, tl["mlp_norm"], tx)
    close(th, jh, dtype)
    close(TL.mlp_block(tctx, tl["mlp"], th), JL.mlp_block(jctx, jl["mlp"], jh),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["encoder", "cross"])
def test_attention_block_matches_reference(dtype, kind):
    """The encoder's non-causal self-attention (rope), and
    cross-attention: 24 decoder rows against 96 encoder rows, no rope,
    the keys and values projected from the encoder rows."""
    jcfg, tcfg, jp, tp, jctx, tctx = _setup(dtype)
    jl, tl = layer0(jp, tp)
    jx, tx = inputs((2, 24, tcfg.d_model), dtype, 2)
    pos = np.broadcast_to(np.arange(24), (2, 24)).astype(np.int32)
    if kind == "encoder":
        want = JL.attention_block(jctx, jl["attn"], jx, jnp.asarray(pos),
                                  causal=False)
        got = TL.attention_block(tctx, tl["attn"], tx,
                                 torch.from_numpy(pos.copy()), causal=False)
    else:
        je, te = inputs((2, ENC, tcfg.d_model), dtype, 3)
        jkv = jencdec._cross_kv(jctx, jl["cross"], je)
        tkv = TL.attention_qkv(tctx, tl["cross"], tx,
                               torch.from_numpy(pos.copy()), use_rope=False,
                               kv_x=te)[1:]
        for a, b in zip(tkv, jkv):
            close(a, b, dtype)
        want = JL.attention_block(jctx, jl["cross"], jx, jnp.asarray(pos),
                                  causal=False, use_rope=False,
                                  kv_override=jkv)
        got = TL.attention_block(tctx, tl["cross"], tx,
                                 torch.from_numpy(pos.copy()), causal=False,
                                 use_rope=False, kv_x=te)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_block_matches_reference(dtype):
    """One token a row into a dense cache at ragged lengths: the output,
    and the KV written in place at each row's length."""
    jcfg, tcfg, jp, tp, jctx, tctx = _setup(dtype)
    jl, tl = layer0(jp, tp)
    hk, hd = tcfg.num_kv_heads, tcfg.head_dim
    jx, tx = inputs((3, 1, tcfg.d_model), dtype, 4)
    jk, tk = inputs((3, 32, hk, hd), dtype, 5)
    jv, tv = inputs((3, 32, hk, hd), dtype, 6)
    lens = np.array([0, 17, 31], np.int32)
    want, wk, wv = JL.attention_decode_block(
        jctx, jl["attn"], jx, jnp.asarray(lens), jk, jv, jnp.asarray(lens))
    tk, tv = tk.clone(), tv.clone()
    got = TL.attention_decode_block(tctx, tl["attn"], tx,
                                    torch.from_numpy(lens), tk, tv,
                                    torch.from_numpy(lens))
    close(got, want, dtype)
    close(tk, wk, dtype)
    close(tv, wv, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    jcfg, tcfg, jp, tp, jctx, tctx = _setup(dtype)
    jf, tf = inputs((2, ENC, tcfg.d_model), dtype, 7)
    close(encdec.encode(tctx, tp, tf), jencdec.encode(jctx, jp, jf), dtype,
          MODEL_TOL)


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frames", ["random", "zeros"])
def test_prefill_and_decode_match_reference(dtype, frames):
    """Ragged prompts; with random frames (the encoder carries signal)
    and with none (the zero frames the engine passes); then two decode
    steps over both caches."""
    jcfg, tcfg, jp, tp, jctx, tctx = _setup(dtype)
    b, s, s_max = 3, 24, 48
    rng = np.random.default_rng(8)
    toks = rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([24, 9, 1], np.int32)
    kw_j, kw_t = {}, {}
    if frames == "random":
        jf, tf = inputs((b, ENC, tcfg.d_model), dtype, 9)
        kw_j, kw_t = dict(frames=jf), dict(frames=tf)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jl, jc = japi.prefill(jctx, jp, jnp.asarray(toks), jnp.asarray(lens),
                          jencdec.init_cache(jcfg, JDenseLayout(b, s_max),
                                             enc_len=ENC), **kw_j)
    tl, tc = tapi.prefill(tctx, tp, torch.from_numpy(toks),
                          torch.from_numpy(lens),
                          encdec.init_cache(tcfg, DenseLayout(b, s_max),
                                            device="cpu", enc_len=ENC),
                          **kw_t)
    close(tl, jl, dtype, MODEL_TOL)
    cache_close(tc, jc, dtype, MODEL_TOL)
    for step in range(2):
        jl, jc, tl, tc = decode_pair(ARCH, dtype, jc, tc,
                                     [n + step for n in lens], seed=step)
        close(tl, jl, dtype, MODEL_TOL)
        cache_close(tc, jc, dtype, MODEL_TOL)


def test_init_params_and_cache_draw_the_reference_trees():
    jcfg, tcfg, _, _ = model(ARCH, "bfloat16")
    tp = get_model(tcfg).init_params(torch.Generator().manual_seed(0),
                                     device="cpu")
    shapes = jax.eval_shape(jget_model(jcfg).init_params,
                            jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
    assert not tp["layers"]["attn_norm"]["bias"].any()
    cache = get_model(tcfg).init_cache(DenseLayout(2, 40), device="cpu")
    jcache = jget_model(jcfg).cache_spec(JDenseLayout(2, 40))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    assert cache["xk"].shape[2] == encdec.ENC_FRAMES_SERVE == 1500


# ---------------------------------------------------------------------------
# The engine end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fusion", ["split", "fused"])
def test_engine_matches_reference_engine(fusion):
    """Greedy f32 serving, 2 slots, ragged prompts, the engine's zero
    frames at 1,500 encoder positions: the port's tokens are the JAX
    engine's."""
    prompts = ragged_prompts(7, (19, 9, 40, 5))
    got, want = engine_pair(ARCH, prompts, [6, 4, 6, 5], num_slots=2,
                            max_seq=96, decode_fusion=fusion)
    assert got == want


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_quantized_engine_matches_reference_engine(wd):
    """int8 / fp8 weights (the decoder's attention, cross-attention and
    MLP are weight keys; the encoder stays bf16 in both packages): the
    port's tokens are the JAX engine's."""
    prompts = ragged_prompts(8, (12, 30, 7))
    got, want = engine_pair(ARCH, prompts, [5, 4, 5], num_slots=2,
                            max_seq=64, weight_dtype=wd)
    assert got == want


@pytest.mark.parametrize("wd", ["int8", "fp8"])
def test_quantized_logits_within_the_guard(wd):
    """Prefill and decode logits with quantized weights on the "torch"
    plan within logits_guard_tol(spec) x max(|logits|, 1) of the bf16
    logits."""
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import quant
    from repro_torch.models import wquant
    from repro_torch.models.layers import LayerCtx

    _, tcfg, _, tp = model(ARCH, "bfloat16")
    api = get_model(tcfg)
    spec = quant.spec_for(wd)
    qp = wquant.quantize_params(tp, spec)
    assert isinstance(qp["layers"]["cross"]["wq"], dict)
    assert not isinstance(qp["enc_layers"]["attn"]["wq"], dict)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, 500, (2, 24)).astype(np.int32))
    lens = torch.tensor([24, 9], dtype=torch.int32)
    _, frames = inputs((2, ENC, tcfg.d_model), "bfloat16", 5)
    out = {}
    for name, params in (("bf16", tp), ("q", qp)):
        ctx = LayerCtx(tcfg, make_plan("torch"))
        cache = encdec.init_cache(tcfg, DenseLayout(2, 48), device="cpu",
                                  enc_len=ENC)
        l1, cache = api.prefill(ctx, params, toks, lens, cache,
                                frames=frames)
        l2, _ = api.decode_step(ctx, params, toks[:, 0], cache, lens)
        out[name] = torch.cat([l1, l2])[:, :tcfg.vocab_size].float()
    tol = quant.logits_guard_tol(spec) * max(
        out["bf16"].abs().max().item(), 1.0)
    assert (out["q"] - out["bf16"]).abs().max().item() <= tol


def test_looped_is_refused():
    """No longer refused: ``decode_fusion="looped"`` serves the family,
    its greedy tokens equal to split's and to the JAX engine's."""
    looped_parity(ARCH, ragged_prompts(12, (19, 40, 5)), [5, 4, 5],
                  num_slots=2, max_seq=96)
