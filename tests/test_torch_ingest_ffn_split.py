"""Split K of the port's fused decode ingest (row 12) and of its bf16
rmsnorm-fused FFN-up (row 14), on CPU tensors.

The kernels cut K into fixed ranges of whole 64-row tiles from K = 0 and
fold the ranges' f32 partials in split order through a cluster; their
plain versions walk the same splits with ``flat_gemm.split_acc`` (each
row its own product, the splits summed in split order). Here:

  * the split pickers (``ingest_splits``, ``ffn_norm_splits``) take no M:
    a function of K, N (or the head count) and the card. At qwen2-0.5b
    (d 896, 14 / 2 heads of 64, d_ff 4,864) and llama2-7b (d 4,096, 32 /
    32 heads of 128, d_ff 11,008) widths they give at most 8 splits, none
    empty; the ingest runs one wave at both, row 14 one wave at qwen2-0.5b
    (at llama2-7b its 172 column tiles already exceed the card, and the
    fewest splits whose normed rows fit a block are taken); shared memory
    and the register caps fit (arithmetic only, no weights);
  * ``decode_ingest_plain`` and ``ffn_norm_plain``, at shapes where the
    pickers give more than one split, against the JAX package's Pallas
    kernels run with ``interpret=True`` on the same numpy inputs, at
    TOL["float32"] (f32; same math, other summation order) and
    TOL["bfloat16"] (bf16; output rounding plus order): bias and rope on
    and off, swiglu and geglu, and the int8 / fp8 twins (both packages
    get the same codes and steps; row 14's quantized body stays unsplit);
  * a row's plain result is bitwise the same alone and in a batch, and
    the bf16 row 14 plain version is the explicit walk of its splits.

``chip_smoke.py`` holds the CUDA kernels to these plain versions on the
card.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import decode_fuse as jdf
from repro.kernels import quant as jq
from repro.models import wquant as jw
from repro_torch import hardware
from repro_torch.kernels import decode_fuse as tdf
from repro_torch.kernels import quant as tq
from repro_torch.kernels.ref import ffn_activation, rmsnorm_ref
from repro_torch.models import wquant as tw

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QSPECS = {"int8": (jq.INT8, tq.INT8), "fp8": (jq.FP8, tq.FP8)}
H100 = hardware.H100_SXM
# (K, heads, head_dim, N of row 14) of the two models' layers
QWEN = dict(k=896, heads=14 + 2 * 2, head_dim=64, f=4864)
LLAMA = dict(k=4096, heads=32 + 2 * 32, head_dim=128, f=11008)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs it in
    parallel workers beside other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str = "bfloat16"):
    j = jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _qpair(a: np.ndarray, kind: str):
    """The same bf16 weight quantized by both packages: (JAX leaf, port
    leaf), each {"codes", "scale"}."""
    jwb, twb = _pair(a)
    js, ts = QSPECS[kind]
    return jw.quantize_weight(jwb, js), tw.quantize_weight(twb, ts)


def _close(got: torch.Tensor, want, dtype: str = "bfloat16"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _none_empty(k: int, splits: int) -> bool:
    return (splits - 1) * tdf.split_tiles(k, splits) < -(-k // tdf.SPLIT_ROWS)


# ---------------------------------------------------------------------------
# The pickers
# ---------------------------------------------------------------------------


def test_split_pickers_take_no_m():
    for fn in (tdf.ingest_splits, tdf.ffn_norm_splits,
               tdf.wgmma_norm_blocks_per_sm):
        assert not {"m", "M"} & set(inspect.signature(fn).parameters)


@pytest.mark.parametrize("model,want", [(QWEN, 7), (LLAMA, 2)],
                         ids=["qwen2-0.5b", "llama2-7b"])
def test_ingest_splits_one_wave(model, want):
    spec, k, heads = H100, model["k"], model["heads"]
    s = tdf.ingest_splits(k, heads, spec=spec)
    assert s == want and 1 < s <= tdf.MAX_SPLITS and _none_empty(k, s)
    # one wave: every cluster of s blocks runs at once at the kernel's
    # INGEST_PER_SM blocks a SM, and no more splits would
    assert heads <= hardware.cluster_slots(spec, s, tdf.INGEST_PER_SM)
    assert heads * s <= tdf.INGEST_PER_SM * spec.num_sms
    threads = model["head_dim"] // 16 * 32
    span = tdf.split_tiles(k, s) * tdf.SPLIT_ROWS
    for m in (1, 4, 8, 64):
        mt, splits = tdf.ingest_tiles(m, k, model["head_dim"], heads,
                                      spec=spec)
        assert splits == s and mt % 8 == 0 and 8 <= mt <= 64
        smem = tdf.ingest_smem(mt, span, model["head_dim"])
        assert smem <= spec.smem_per_block
        if m <= 8:
            # decode rows: two blocks a SM fit its shared memory, and the
            # launch bound leaves them at least 128 registers a thread
            assert mt == 8
            assert tdf.INGEST_PER_SM * (
                smem + spec.smem_reserved_per_block) <= spec.smem_per_sm
            assert spec.regs_per_sm // (tdf.INGEST_PER_SM * threads) >= 128
    # the f32 partials (up to 64 rows x head_dim) reuse the weight ring
    assert 64 * model["head_dim"] * 4 <= tdf.ingest_smem(
        0, 0, model["head_dim"], w_bytes=1)


def test_ffn_norm_splits_one_wave_at_qwen():
    spec, k, n = H100, QWEN["k"], QWEN["f"]
    s = tdf.ffn_norm_splits(k, n, spec=spec)
    assert s == 3 and _none_empty(k, s)
    per = tdf.split_tiles(k, s)
    occ = tdf.wgmma_norm_blocks_per_sm(per, spec=spec)
    blocks = -(-n // tdf.FN_BN)
    assert blocks == 76 and blocks < spec.num_sms   # unsplit: SMs idle
    assert occ == 2 and blocks <= hardware.cluster_slots(spec, s, occ)
    smem = tdf.wgmma_norm_smem(per)
    assert occ * (smem + spec.smem_reserved_per_block) <= spec.smem_per_sm
    # the register cap of FN_MAX_BLOCKS blocks a SM holds the two m64n64
    # f32 accumulators (64 a thread) with room to spare
    cap = spec.regs_per_sm // (tdf.FN_MAX_BLOCKS * tdf.FN_THREADS) // 8 * 8
    assert cap >= 2 * tdf.FN_BN * tdf.FN_TOKENS // 128 + 32
    # more splits would not all run at once
    for more in range(s + 1, tdf.MAX_SPLITS + 1):
        per_m = tdf.split_tiles(k, more)
        s_m = -(-(-(-k // tdf.SPLIT_ROWS)) // per_m)
        if s_m > s:
            occ_m = tdf.wgmma_norm_blocks_per_sm(per_m, spec=spec)
            assert blocks > hardware.cluster_slots(spec, s_m, occ_m)


def test_ffn_norm_splits_fit_the_rows_at_llama():
    spec, k, n = H100, LLAMA["k"], LLAMA["f"]
    s = tdf.ffn_norm_splits(k, n, spec=spec)
    assert s == 4 and _none_empty(k, s)
    blocks = -(-n // tdf.FN_BN)
    assert blocks > spec.num_sms          # the columns alone fill the card
    assert tdf.wgmma_norm_smem(tdf.split_tiles(k, s)) <= spec.smem_per_block
    # fewer splits leave the normed rows no room beside the ring
    assert tdf.wgmma_norm_blocks_per_sm(tdf.split_tiles(k, s - 1),
                                        spec=spec) == 0


def test_split_pickers_follow_the_card():
    half = dataclasses.replace(H100, num_sms=66)
    assert tdf.ingest_splits(896, 18, spec=half) < tdf.ingest_splits(
        896, 18, spec=H100)
    assert tdf.ffn_norm_splits(896, 4864, spec=half) == 1


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# (M, num_heads, num_kv_heads, head_dim, d_model, bias, rope)
INGEST_CASES = [
    (1, 4, 2, 32, 128, False, True),
    (3, 8, 8, 64, 256, True, True),
    (2, 4, 1, 64, 192, True, False),
    (3, 12, 4, 64, 384, False, True),
]


def _ingest_inputs(m, hq, hk, dh, d, bias, dtype):
    rng = np.random.default_rng(hq * 1000 + d + m)
    jx, tx = _pair(rng.normal(size=(m, d)), dtype)
    js, ts = _pair(1 + 0.1 * rng.normal(size=(d,)), dtype)
    ws = [rng.normal(size=(d, n)) * d ** -0.5
          for n in (hq * dh, hk * dh, hk * dh)]
    bs = [_pair(rng.normal(size=(n,)), dtype) if bias else (None, None)
          for n in (hq * dh, hk * dh, hk * dh)]
    pos = np.array([4, 9, 1000][:m], np.int32)
    return (jx, tx), (js, ts), ws, bs, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,hq,hk,dh,d,bias,use_rope", INGEST_CASES)
def test_split_ingest_matches_pallas(m, hq, hk, dh, d, bias, use_rope,
                                     dtype):
    assert tdf.ingest_splits(d, hq + 2 * hk) > 1
    (jx, tx), (js, ts), ws, bs, pos = _ingest_inputs(m, hq, hk, dh, d, bias,
                                                     dtype)
    wp = [_pair(w, dtype) for w in ws]
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh, rope_theta=1e6,
              use_rope=use_rope)
    want = jdf.decode_ingest_fused(
        jx, js, *(w[0] for w in wp), jnp.asarray(pos), bq=bs[0][0],
        bk_bias=bs[1][0], bv=bs[2][0], interpret=True, **kw)
    got = tdf.decode_ingest_plain(tx, ts, *(w[1] for w in wp),
                                  torch.from_numpy(pos), bq=bs[0][1],
                                  bk=bs[1][1], bv=bs[2][1], **kw)
    for g, w in zip(got, want):
        assert g.shape == (m, w.shape[1]) and g.dtype == tx.dtype
        _close(g, w, dtype)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m,hq,hk,dh,d,bias,use_rope", INGEST_CASES[1:])
def test_split_ingest_quant_matches_pallas(m, hq, hk, dh, d, bias, use_rope,
                                           kind):
    (jx, tx), (js, ts), ws, bs, pos = _ingest_inputs(m, hq, hk, dh, d, bias,
                                                     "bfloat16")
    leaves = [_qpair(w, kind) for w in ws]
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh, rope_theta=1e6,
              use_rope=use_rope)
    want = jdf.decode_ingest_fused(
        jx, js, *(lf[0]["codes"] for lf in leaves), jnp.asarray(pos),
        bq=bs[0][0], bk_bias=bs[1][0], bv=bs[2][0],
        wq_scale=leaves[0][0]["scale"], wk_scale=leaves[1][0]["scale"],
        wv_scale=leaves[2][0]["scale"], interpret=True, **kw)
    got = tdf.decode_ingest_plain(
        tx, ts, *(lf[1]["codes"] for lf in leaves), torch.from_numpy(pos),
        bq=bs[0][1], bk=bs[1][1], bv=bs[2][1],
        wq_scale=leaves[0][1]["scale"], wk_scale=leaves[1][1]["scale"],
        wv_scale=leaves[2][1]["scale"], **kw)
    for g, w in zip(got, want):
        _close(g, w)


# (M, d_model, d_ff, activation)
FFN_CASES = [(1, 128, 256, "swiglu"), (3, 192, 384, "swiglu"),
             (1, 256, 512, "geglu"), (3, 384, 640, "geglu")]


def _ffn_inputs(m, d, f, dtype):
    rng = np.random.default_rng(m * 100 + f)
    jx, tx = _pair(rng.normal(size=(m, d)), dtype)
    js, ts = _pair(1 + 0.1 * rng.normal(size=(d,)), dtype)
    wg = rng.normal(size=(d, f)) * d ** -0.5
    wu = rng.normal(size=(d, f)) * d ** -0.5
    return (jx, tx), (js, ts), wg, wu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f,act", FFN_CASES)
def test_split_ffn_norm_matches_pallas(m, d, f, act, dtype):
    assert tdf.ffn_norm_splits(d, f) > 1
    (jx, tx), (js, ts), wg, wu = _ffn_inputs(m, d, f, dtype)
    (jg, tg), (ju, tu) = _pair(wg, dtype), _pair(wu, dtype)
    want = jdf.ffn_norm_fused(jx, js, jg, ju, activation=act, interpret=True)
    got = tdf.ffn_norm_plain(tx, ts, tg, tu, activation=act)
    assert got.shape == (m, f) and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("m,d,f,act", FFN_CASES)
def test_ffn_norm_quant_matches_pallas(m, d, f, act, kind):
    (jx, tx), (js, ts), wg, wu = _ffn_inputs(m, d, f, "bfloat16")
    (jgl, tgl), (jul, tul) = _qpair(wg, kind), _qpair(wu, kind)
    want = jdf.ffn_norm_fused(jx, js, jgl["codes"], jul["codes"],
                              activation=act, wg_scale=jgl["scale"],
                              wu_scale=jul["scale"], interpret=True)
    got = tdf.ffn_norm_plain(tx, ts, tgl["codes"], tul["codes"],
                             activation=act, wg_scale=tgl["scale"],
                             wu_scale=tul["scale"])
    _close(got, want)


# ---------------------------------------------------------------------------
# Rows alone, and the walk of the splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_ingest_row_alone_bitwise_in_batch(kind):
    m, hq, hk, dh, d = 5, 8, 8, 64, 256
    rng = np.random.default_rng(5)
    _, tx = _pair(rng.normal(size=(m, d)))
    _, ts = _pair(1 + 0.1 * rng.normal(size=(d,)))
    ws, scales = [], {}
    for name, n in (("wq", hq * dh), ("wk", hk * dh), ("wv", hk * dh)):
        w = rng.normal(size=(d, n)) * d ** -0.5
        if kind == "bf16":
            ws.append(_pair(w)[1])
        else:
            leaf = _qpair(w, kind)[1]
            ws.append(leaf["codes"])
            scales[name + "_scale"] = leaf["scale"]
    bq, bk, bv = (_pair(rng.normal(size=(n,)))[1]
                  for n in (hq * dh, hk * dh, hk * dh))
    pos = torch.tensor([3, 70, 511, 2, 1000], dtype=torch.int32)
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh, bq=bq, bk=bk,
              bv=bv, **scales)
    batch = tdf.decode_ingest_plain(tx, ts, *ws, pos, **kw)
    for i in range(m):
        alone = tdf.decode_ingest_plain(tx[i:i + 1], ts, *ws, pos[i:i + 1],
                                        **kw)
        for a, b in zip(alone, batch):
            assert (_bits(a) == _bits(b[i:i + 1])).all()
    # the wrapper on a CPU tensor is the plain version
    assert all(torch.equal(a, b) for a, b in zip(
        tdf.decode_ingest_fused(tx, ts, *ws, pos, **kw), batch))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_ffn_norm_row_alone_bitwise_in_batch(kind):
    m, d, f = 5, 384, 640
    rng = np.random.default_rng(6)
    _, tx = _pair(rng.normal(size=(m, d)))
    _, ts = _pair(1 + 0.1 * rng.normal(size=(d,)))
    wg = rng.normal(size=(d, f)) * d ** -0.5
    wu = rng.normal(size=(d, f)) * d ** -0.5
    if kind == "bf16":
        g, u, kw = _pair(wg)[1], _pair(wu)[1], {}
    else:
        gl, ul = _qpair(wg, kind)[1], _qpair(wu, kind)[1]
        g, u = gl["codes"], ul["codes"]
        kw = dict(wg_scale=gl["scale"], wu_scale=ul["scale"])
    batch = tdf.ffn_norm_plain(tx, ts, g, u, **kw)
    for i in range(m):
        alone = tdf.ffn_norm_plain(tx[i:i + 1], ts, g, u, **kw)
        assert (_bits(alone) == _bits(batch[i:i + 1])).all()
    assert torch.equal(tdf.ffn_norm_fused(tx, ts, g, u, **kw), batch)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_ffn_norm_walks_its_splits_in_order(act):
    """d_model 384 is six 64-row tiles in six splits: per row, each
    split's tiles in f32 in K order, the splits' sums in split order, the
    activation on the f32 sums, one rounding."""
    m, d, f = 2, 384, 640
    (_, tx), (_, ts), wg, wu = _ffn_inputs(m, d, f, "bfloat16")
    g, u = _pair(wg)[1], _pair(wu)[1]
    s = tdf.ffn_norm_splits(d, f)
    assert s == 6
    span = tdf.split_tiles(d, s) * tdf.SPLIT_ROWS
    xn = rmsnorm_ref(tx, ts, 1e-6)
    got = tdf.ffn_norm_plain(tx, ts, g, u, activation=act)
    for r in range(m):
        sums = []
        for w in (g, u):
            total = None
            for lo in range(0, d, span):
                part = torch.zeros(f)
                for t in range(lo, min(lo + span, d), tdf.SPLIT_ROWS):
                    part += xn[r, t:t + tdf.SPLIT_ROWS].float() @ \
                        w[t:t + tdf.SPLIT_ROWS].float()
                total = part if total is None else total + part
            sums.append(total)
        want = (ffn_activation(sums[0], act) * sums[1]).to(torch.bfloat16)
        assert torch.equal(got[r], want)
