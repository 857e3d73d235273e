"""The flat GEMM's wgmma body (row 2 wherever N is not narrow) and the
quantized FFN-up bodies (rows 8 and 14 with codes) on CPU tensors: their
plain versions, which walk the bodies' fixed 64-row K tiles and splits
(``flat_gemm.split_acc``: each tile in f32, one batched product a row,
the splits' sums in split order, then the steps and one rounding),
against the JAX package's ``flat_gemm``, ``oproj_residual_fused``,
``fused_ffn_up`` and ``ffn_norm_fused`` run with ``interpret=True`` on the
same numpy inputs, within ``TOL["bfloat16"]``; bf16, int8 and fp8:

  * the pickers: the wgmma body's splits and ring from K, N, the weight
    width and the card (never M), its ring inside a block's shared memory
    at 1- and 2-byte weights, one wave of clusters where it splits, the
    tied heads unsplit; 64-row token tiles covering any M;
  * ``flat_gemm_plain`` / ``oproj_residual_plain`` at N wide enough for
    the wgmma body, split and unsplit, (K, N) and the (N, K) view, M from
    1 to 300; ``fused_ffn_up_plain`` / ``ffn_norm_plain`` with codes;
  * a row's plain result bitwise the same alone as in a batch, for each.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py`` (its "wgmma GEMM" and quantized FFN-up phases).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import decode_fuse as jdf
from repro.kernels import quant as jq
from repro.kernels.flat_gemm import flat_gemm as jflat_gemm
from repro.kernels.fused_ffn import fused_ffn_up as jfused_ffn_up
from repro.models import wquant as jw
from repro_torch import hardware
from repro_torch.kernels import decode_fuse as tdf
from repro_torch.kernels import flat_gemm as tfg
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import quant as tq
from repro_torch.models import wquant as tw

BF16 = TOL["bfloat16"]
H100 = hardware.H100_SXM
QSPECS = {"int8": (jq.INT8, tq.INT8), "fp8": (jq.FP8, tq.FP8)}
# (K, N, (K, N) layout): 66 column tiles of a 200-deep K (4 tiles, the
# last ragged), split; the narrowest N the wgmma body takes is 132 x 32;
# an (N, K) view one K tile deep, unsplit
SHAPES = [(200, 4224, True), (136, 4352, True), (64, 8192, False)]
# codes come in the (K, N) layout only
CASES = [(k, n, kn, kind) for k, n, kn in SHAPES
         for kind in ("bf16", "int8", "fp8") if kn or kind == "bf16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs it in
    parallel workers beside other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _weight(rng, k, n, kind):
    """((JAX w, JAX step or None), (port w, port step or None)) of one
    bf16 weight, quantized by both packages for int8 / fp8."""
    jwb, twb = _bf16_pair(rng.normal(size=(k, n)) * k ** -0.5)
    if kind == "bf16":
        return (jwb, None), (twb, None)
    js, ts = QSPECS[kind]
    jl, tl = jw.quantize_weight(jwb, js), tw.quantize_weight(twb, ts)
    return (jl["codes"], jl["scale"]), (tl["codes"], tl["scale"])


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# Pickers
# ---------------------------------------------------------------------------


def test_wgmma_pickers_on_h100():
    spec = H100
    # qwen2-0.5b's gate / up: 76 column tiles, 5 splits of three K tiles
    # at four blocks a SM, bf16 and codes; llama2-7b's 4,096 -> 11,008:
    # 172 tiles, 2 splits at three a SM; the tied heads unsplit
    want = {(896, 4864, True): 5, (4096, 11008, True): 2,
            (896, 152064, False): 1, (4096, 32000, False): 1}
    for (k, n, kn), splits in want.items():
        for w_bytes in (2, 1) if kn else (2,):
            assert tfg.gemm_tiles(k, n, w_kn=kn, w_bytes=w_bytes,
                                  spec=spec) == ("wgmma", 64, splits)
    for (k, n, _), splits in want.items():
        for w_bytes in (2, 1):
            s = tfg.wgmma_splits(k, n, w_bytes, spec=spec)
            per = tfg.split_tiles(k, s)
            smem = tfg.wgmma_smem(per, w_bytes)
            occ = tfg.blocks_per_sm(smem, tfg.WG_MAX_BLOCKS, spec=spec)
            # the ring fits a block, at least 4 deep where the split holds
            # 4 tiles, and a split launch's clusters run in one wave
            assert smem <= spec.smem_per_block and occ >= 1
            assert min(tfg.WG_STAGES, max(2, per)) == min(4, max(2, per))
            if s > 1:
                assert -(-n // tfg.WG_BN) <= hardware.cluster_slots(
                    spec, s, occ)
            # none empty: ceil(n_kt / s) tiles a split
            n_kt = -(-k // tfg.WG_BK)
            assert -(-n_kt // per) == s
    # K, N, the weight width and the card only: no M anywhere
    for fn in (tfg.gemm_tiles, tfg.wgmma_splits, tfg.wgmma_smem,
               tdf.ffn_norm_splits):
        assert "m" not in inspect.signature(fn).parameters
    # a smaller card splits where the H100 does not need to
    half = hardware.HardwareSpec(**{**spec.__dict__, "num_sms": 66})
    assert tfg.wgmma_splits(896, 4864, spec=half) \
        < tfg.wgmma_splits(896, 4864, spec=spec)


def test_wgmma_token_tiles_cover_m():
    """The token operand is WG_TOKENS rows whatever M; gridDim.y takes
    ceil(M / WG_TOKENS) tiles, every one with a live row, so any M runs
    (the plan's ladder sends M < 128; direct callers may send more)."""
    for m in range(1, 301):
        tiles = -(-m // tfg.WG_TOKENS)
        assert tiles * tfg.WG_TOKENS >= m > (tiles - 1) * tfg.WG_TOKENS
    assert tfg.WG_TOKENS == tfg.WG_BN == tfg.WG_BK == 64


def test_quant_ffn_splits_match_bf16_at_qwen():
    """Codes halve the weight tiles and add two conversion buffers; the
    rmsnorm-fused FFN-up keeps bf16's three splits at two blocks a SM,
    the wgmma GEMM bf16's five at four."""
    for w_bytes in (2, 1):
        assert tdf.ffn_norm_splits(896, 4864, w_bytes) == 3
        per = tfg.split_tiles(896, 3)
        assert tdf.wgmma_norm_blocks_per_sm(per, w_bytes) == 2
        assert tfg.wgmma_splits(896, 4864, w_bytes) == 5
    assert tdf.ffn_norm_splits(4096, 11008, 1) == 4


# ---------------------------------------------------------------------------
# Plain versions against the JAX kernels
# ---------------------------------------------------------------------------


def test_test_shapes_take_the_wgmma_body():
    got = {(k, n): tfg.gemm_tiles(k, n, w_kn=kn)[::2]
           for k, n, kn in SHAPES}
    assert got == {(200, 4224): ("wgmma", 4), (136, 4352): ("wgmma", 3),
                   (64, 8192): ("wgmma", 1)}


@pytest.mark.parametrize("k,n,kn,kind", CASES)
@pytest.mark.parametrize("m", [1, 4, 13, 64, 127, 300])
def test_wgmma_flat_gemm_matches_pallas(m, k, n, kn, kind):
    rng = np.random.default_rng(m * 1000 + k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jflat_gemm(jx, jwt, w_scale=js, interpret=True)
    if not kn:
        twt = twt.T.contiguous().T          # the (N, K) view
    got = tfg.flat_gemm_plain(tx, twt, w_scale=ts)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tfg.flat_gemm(tx, twt, w_scale=ts), got)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("m", [1, 13, 127])
def test_wgmma_oproj_residual_matches_pallas(m, kind):
    k, n = 200, 4224
    rng = np.random.default_rng(m + 7)
    jo, to = _bf16_pair(rng.normal(size=(m, k)))
    jr, tr = _bf16_pair(rng.normal(size=(m, n)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jdf.oproj_residual_fused(jo, jwt, jr, w_scale=js, interpret=True)
    got = tdf.oproj_residual_plain(to, twt, tr, w_scale=ts)
    _close(got, want)
    assert torch.equal(tdf.oproj_residual_fused(to, twt, tr, w_scale=ts),
                       got)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 4, 13, 64, 200])
def test_quant_fused_ffn_up_matches_pallas(m, kind):
    k, n = 200, 144
    rng = np.random.default_rng(m * 31 + k)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    (jg, jsg), (tg, tsg) = _weight(rng, k, n, kind)
    (ju, jsu), (tu, tsu) = _weight(rng, k, n, kind)
    for act in ("swiglu", "geglu"):
        want = jfused_ffn_up(jx, jg, ju, activation=act, wg_scale=jsg,
                             wu_scale=jsu, interpret=True)
        got = tff.fused_ffn_up_plain(tx, tg, tu, activation=act,
                                     wg_scale=tsg, wu_scale=tsu)
        _close(got, want)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 4, 13, 64])
def test_quant_ffn_norm_matches_pallas(m, kind):
    d, f = 200, 4224
    rng = np.random.default_rng(m * 17 + d)
    jx, tx = _bf16_pair(rng.normal(size=(m, d)))
    js_, ts_ = _bf16_pair(1 + 0.1 * rng.normal(size=(d,)))
    (jg, jsg), (tg, tsg) = _weight(rng, d, f, kind)
    (ju, jsu), (tu, tsu) = _weight(rng, d, f, kind)
    assert tdf.ffn_norm_splits(d, f, 1) > 1
    want = jdf.ffn_norm_fused(jx, js_, jg, ju, wg_scale=jsg, wu_scale=jsu,
                              interpret=True)
    got = tdf.ffn_norm_plain(tx, ts_, tg, tu, wg_scale=tsg, wu_scale=tsu)
    _close(got, want)


# ---------------------------------------------------------------------------
# A row alone bitwise in its batch; the plain walks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,kn,kind", CASES)
def test_wgmma_row_alone_bitwise_in_batch(k, n, kn, kind):
    rng = np.random.default_rng(k + n)
    _, tx = _bf16_pair(rng.normal(size=(300, k)))
    _, tr = _bf16_pair(rng.normal(size=(300, n)))
    _, (twt, ts) = _weight(rng, k, n, kind)
    if not kn:
        twt = twt.T.contiguous().T
    for m in (13, 300):
        batch = tfg.flat_gemm_plain(tx[:m], twt, w_scale=ts)
        fused = (tdf.oproj_residual_plain(tx[:m], twt, tr[:m], w_scale=ts)
                 if kn else None)
        for i in (0, 5, m - 1):
            alone = tfg.flat_gemm_plain(tx[i:i + 1], twt, w_scale=ts)
            assert (_bits(alone) == _bits(batch[i:i + 1])).all()
            if kn:
                alone = tdf.oproj_residual_plain(tx[i:i + 1], twt,
                                                 tr[i:i + 1], w_scale=ts)
                assert (_bits(alone) == _bits(fused[i:i + 1])).all()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quant_ffn_row_alone_bitwise_in_batch(kind):
    """The quantized FFN-up plain versions (row 8's fixed K tiles, row
    14's splits) give a row the same bits alone as in a batch: each tile
    is one product a row, never a 2-D matmul whose order follows M."""
    k, n = 200, 4224
    rng = np.random.default_rng(5)
    _, tx = _bf16_pair(rng.normal(size=(64, k)))
    _, ts_ = _bf16_pair(1 + 0.1 * rng.normal(size=(k,)))
    _, (tg, tsg) = _weight(rng, k, n, kind)
    _, (tu, tsu) = _weight(rng, k, n, kind)
    kw = dict(wg_scale=tsg, wu_scale=tsu)
    for act in ("swiglu", "geglu"):
        up = tff.fused_ffn_up_plain(tx, tg, tu, activation=act, **kw)
        nrm = tdf.ffn_norm_plain(tx, ts_, tg, tu, activation=act, **kw)
        for i in (0, 31, 63):
            alone = tff.fused_ffn_up_plain(tx[i:i + 1], tg, tu,
                                           activation=act, **kw)
            assert (_bits(alone) == _bits(up[i:i + 1])).all()
            alone = tdf.ffn_norm_plain(tx[i:i + 1], ts_, tg, tu,
                                       activation=act, **kw)
            assert (_bits(alone) == _bits(nrm[i:i + 1])).all()


def test_quant_fused_ffn_plain_walks_fixed_k_tiles():
    """The codes' plain FFN-up sums the body's WG_BK tiles in K order,
    each row its own f32 product of the codes cast exactly, then applies
    the steps and the activation to the f32 sums and rounds once."""
    k, n = 200, 48
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32)).to(
        torch.bfloat16)
    _, (g, sg) = _weight(rng, k, n, "int8")
    _, (u, su) = _weight(rng, k, n, "int8")
    got = tff.fused_ffn_up_plain(x, g, u, wg_scale=sg, wu_scale=su)
    for r in range(3):
        acc = []
        for w, s in ((g, sg), (u, su)):
            a = torch.zeros(n)
            for t in range(0, k, tff.WG_BK):
                a += x[r, t:t + tff.WG_BK].float() @ w[t:t + tff.WG_BK].float()
            acc.append(a * s)
        want = (torch.nn.functional.silu(acc[0]) * acc[1]).to(torch.bfloat16)
        assert torch.equal(got[r], want)
