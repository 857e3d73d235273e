"""The port's fused FFN-up (row 8 of the kernel table) on CPU tensors: its
plain version and the ``ops.fused_ffn`` front door against the JAX
package's Pallas kernel run the way its own tests run it
(``interpret=True``) and against the JAX oracle, on the same numpy inputs;
the model path that routes every gated ``mlp_block`` through it; and the
fused plan's logits and greedy tokens against the JAX package's fused
plan.

Tolerances: TOL["float32"] for f32 inputs (same math, other summation
order: the plain version accumulates the wgmma body's fixed K tiles);
TOL["bfloat16"] for bf16 inputs. The plain version's rows do not depend on
their batch, bit for bit, and the wgmma body's ring fits a block's shared
memory. The CUDA kernel is held to this plain version on the card by
``chip_smoke.py``.
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
from repro.kernels import fused_ffn as jff
from repro.kernels import ref as jref
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch import hardware
from repro_torch.core.plan import DEFAULT_PLAN, make_plan
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
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


def _operands(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(size=(m, k)), dtype)
    wg = _pair(rng.normal(size=(k, n)) * k ** -0.5, dtype)
    wu = _pair(rng.normal(size=(k, n)) * k ** -0.5, dtype)
    return x, wg, wu


# ---------------------------------------------------------------------------
# Row 8: the plain version and the front door against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 13, 64, 200])
def test_fused_ffn_up_matches_pallas(m, dtype):
    """K = 200 and N = 72 are multiples of no tile of either kernel."""
    k, n = 200, 72
    (jx, tx), (jg, tg), (ju, tu) = _operands(m, k, n, dtype, seed=m)
    for act in ("swiglu", "geglu"):
        want = jff.fused_ffn_up(jx, jg, ju, activation=act, interpret=True)
        got = tff.fused_ffn_up_plain(tx, tg, tu, activation=act)
        assert got.shape == (m, n) and got.dtype == tx.dtype
        _close(got, want, dtype)
        # the wrapper on a CPU tensor is the plain version
        assert torch.equal(tff.fused_ffn_up(tx, tg, tu, activation=act), got)
        # the front door: kernel route on "cuda", the oracle on "torch"
        front = ops.fused_ffn(tx, tg, tu, activation=act,
                              plan=make_plan("cuda"))
        assert torch.equal(front, got)
        _close(ops.fused_ffn(tx, tg, tu, activation=act,
                             plan=make_plan("torch")), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_up_ref_matches_jax_ref(dtype):
    """The oracle: activation on the unrounded f32 products, one rounding;
    leading axes pass through the front door."""
    (jx, tx), (jg, tg), (ju, tu) = _operands(12, 96, 40, dtype, seed=7)
    want = jref.fused_ffn_up_ref(jx, jg, ju)
    _close(ref.fused_ffn_up_ref(tx, tg, tu), want, dtype)
    got = ops.fused_ffn(tx.reshape(3, 4, 96), tg, tu, plan=make_plan("torch"))
    assert got.shape == (3, 4, 40)
    _close(got.reshape(12, 40), want, dtype)


def test_fused_ffn_up_rejects_bad_operands():
    x = torch.zeros(2, 16)
    w = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="fused_ffn_up"):
        tff.fused_ffn_up(x, w, torch.zeros(16, 16))
    with pytest.raises(ValueError, match="activation"):
        tff.fused_ffn_up(x, w, w, activation="relu")


def test_fused_ffn_tiles_fit_shared_memory():
    """The body's ring holds two weight tiles and the x tiles of a block's
    rows per stage and fits a block's shared memory at every M of the
    qwen2 FFN-up, bf16 and codes (whose half-size tiles leave room for
    the two converted bf16 buffers): M past one block's WG_TILES x
    WG_TOKENS rows takes more row blocks (the grid tiles M), never more x
    tiles a stage."""
    cfg = tconfigs.get(ARCH)
    spec = hardware.DEFAULT
    for m in (1, 4, 64, 256, 4096):
        rows = min(m, tff.WG_TILES * tff.WG_TOKENS)
        assert -(-rows // tff.WG_TOKENS) <= tff.WG_TILES
        for w_bytes in (2, 1):
            assert tff.wgmma_smem_bytes(w_bytes) <= spec.smem_per_block
    assert tff.wgmma_smem_bytes(1) == tff.wgmma_smem_bytes(2)
    # the K tile is one 128-byte swizzled row of bf16; the column block is
    # the wgmma's 64 rows, which N = d_ff fills exactly
    assert tff.WG_BK * 2 == 128
    assert cfg.d_ff % tff.WG_BN == 0


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_fused_ffn_row_alone_bitwise_in_batch(act):
    """bf16, M = 200 (four 64-row tiles, the last ragged): rows run
    alone give their rows' bits in the batch."""
    (_, tx), (_, tg), (_, tu) = _operands(200, 200, 72, "bfloat16", seed=9)
    batch = tff.fused_ffn_up_plain(tx, tg, tu, activation=act)
    for i in (0, 77, 199):
        alone = tff.fused_ffn_up_plain(tx[i:i + 1], tg, tu, activation=act)
        assert torch.equal(alone.view(torch.int16),
                           batch[i:i + 1].view(torch.int16))


def test_fused_ffn_plain_walks_fixed_k_tiles():
    """The bf16 plain version sums WG_BK-wide K tiles in K order in f32,
    the last one ragged (K = 200), at every M, then the activation and
    one rounding: each row on its own, bit for bit."""
    (_, tx), (_, tg), (_, tu) = _operands(5, 200, 72, "bfloat16", seed=4)
    got = tff.fused_ffn_up_plain(tx, tg, tu)
    for r in range(5):
        g = torch.zeros(72)
        u = torch.zeros(72)
        for t in range(0, 200, tff.WG_BK):
            xs = tx[r, t:t + tff.WG_BK].float()
            g += xs @ tg[t:t + tff.WG_BK].float()
            u += xs @ tu[t:t + tff.WG_BK].float()
        want = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
        assert torch.equal(got[r], want)


# ---------------------------------------------------------------------------
# The model path
# ---------------------------------------------------------------------------


def _model(dtype: str):
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **over)
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **over)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


def test_plan_fuses_ffn_on_the_kernel_backend_only():
    assert make_plan("cuda").fused_ffn.fused
    assert not make_plan("torch").fused_ffn.fused
    assert not make_plan("cuda", fused_ffn=False).fused_ffn.fused
    assert make_plan("torch", fused_ffn=True).fused_ffn.fused
    assert not DEFAULT_PLAN.fused_ffn.fused


def test_mlp_block_routes_every_row_count_through_fused_ffn(monkeypatch):
    """With a fused plan every gated mlp_block calls the fused FFN-up
    once, at M = one decode row per slot and at M = B x C for a chunk;
    an unfused plan never does."""
    _, tcfg, _, tp = _model("float32")
    calls = []
    real = ops.fused_ffn_up

    def spy(x, *a, **k):
        calls.append(x.shape[0])
        return real(x, *a, **k)

    monkeypatch.setattr(ops, "fused_ffn_up", spy)
    api = tget_model(tcfg)
    b, c = 2, 16
    tokens = torch.randint(1, 100, (b, c), dtype=torch.int32)
    lens = torch.full((b,), c, dtype=torch.int32)
    for plan, want in ((make_plan("cuda"), True),
                       (make_plan("cuda", fused_ffn=False), False)):
        calls.clear()
        ctx = LayerCtx(cfg=tcfg, plan=plan)
        cache = api.init_cache(DenseLayout(b, 64), device="cpu")
        _, cache = api.prefill_chunk(ctx, tp, tokens, lens, cache,
                                     torch.zeros_like(lens))
        api.decode_step(ctx, tp, tokens[:, 0], cache, lens)
        n = tcfg.num_layers
        assert calls == ([b * c] * n + [b] * n if want else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_fused_plan_logits_match_jax_fused_plan(backend, dtype):
    """A ragged chunk then one decode step under the fused plan: logits
    against the JAX package with ``make_plan(fused_ffn=True)``."""
    jcfg, tcfg, jp, tp = _model(dtype)
    japi, tapi = jget_model(jcfg), tget_model(tcfg)
    jctx = JLayerCtx(cfg=jcfg, plan=jmake_plan(fused_ffn=True))
    tctx = LayerCtx(cfg=tcfg, plan=make_plan(backend, fused_ffn=True))
    rng = np.random.default_rng(3)
    b, c, s_max = 2, 16, 48
    tokens = rng.integers(1, jcfg.vocab_size, (b, c)).astype(np.int32)
    chunk_lens = np.array([16, 11], np.int32)
    zeros = np.zeros((b,), np.int32)
    jl, jcache = japi.prefill_chunk(
        jctx, jp, jnp.asarray(tokens), jnp.asarray(chunk_lens),
        japi.init_cache(JDenseLayout(b, s_max)), jnp.asarray(zeros))
    tl, tcache = tapi.prefill_chunk(
        tctx, tp, torch.from_numpy(tokens), torch.from_numpy(chunk_lens),
        tapi.init_cache(DenseLayout(b, s_max), device="cpu"),
        torch.from_numpy(zeros))
    _close(tl, jl, dtype)
    nxt = np.array([5, 77], np.int32)
    jl, _ = japi.decode_step(jctx, jp, jnp.asarray(nxt), jcache,
                             jnp.asarray(chunk_lens))
    tl, _ = tapi.decode_step(tctx, tp, torch.from_numpy(nxt), tcache,
                             torch.from_numpy(chunk_lens))
    _close(tl, jl, dtype)


def test_fused_plan_engine_matches_jax_fused_engine():
    """Greedy serving under the fused plan, f32: the port's engine on the
    ``"torch"`` and ``"cuda"`` plans against the JAX engine with
    ``make_plan(fused_ffn=True)``, token for token."""
    jcfg, tcfg, jp, tp = _model("float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (9, 30, 17)]
    kw = dict(num_slots=2, max_seq=96, prefill_chunk=16)
    want = JEngine(jcfg, jp, plan=jmake_plan(fused_ffn=True), **kw).run(
        [(p, JSamplingParams(max_new_tokens=5)) for p in prompts])
    for backend in ("torch", "cuda"):
        got = Engine(tcfg, tp, plan=make_plan(backend, fused_ffn=True),
                     device="cpu", **kw).run(
            [(p, SamplingParams(max_new_tokens=5)) for p in prompts])
        assert got == want, backend


def test_mlp_block_fused_equals_unfused_in_f32():
    """In f32 the fused epilogue and the unfused chain round at the same
    points, so they agree to f32 accuracy."""
    _, tcfg, _, tp = _model("float32")
    x = torch.randn(5, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    fused = L.mlp_block(LayerCtx(cfg=tcfg, plan=make_plan("torch",
                                                          fused_ffn=True)),
                        p, x)
    plain = L.mlp_block(LayerCtx(cfg=tcfg, plan=make_plan("torch")), p, x)
    torch.testing.assert_close(fused, plain, **TOL["float32"])
