"""Split K of the flat GEMM (row 2) and of oproj_residual (row 13) on CPU
tensors: their plain versions, which walk the kernel's splits (each
split's whole BK tiles in f32, the splits' sums in split order, then the
step, the rounding and the residual), against the JAX package's
``flat_gemm`` and ``oproj_residual_fused`` run with ``interpret=True``
on the same numpy inputs, within ``TOL["bfloat16"]``:

  * at shapes where the split shows on the H100 (N narrower than 132
    blocks of 32 columns): K over several splits with a ragged last one,
    N not a multiple of BN, M in {1, 4, 13, 64}; bf16, int8 and fp8
    weights;
  * ``pick_splits`` / ``gemm_tiles``: the split body for narrow N only
    (enough blocks for N = 128 and 896), the wgmma body unsplit for the
    tied head, a function of K, N and the card (no M argument);
  * a row's plain result bitwise the same alone as in a batch.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import decode_fuse as jdf
from repro.kernels import quant as jq
from repro.kernels.flat_gemm import flat_gemm as jflat_gemm
from repro.models import wquant as jw
from repro_torch import hardware
from repro_torch.kernels import decode_fuse as tdf
from repro_torch.kernels import quant as tq
from repro_torch.kernels.flat_gemm import (MAX_SPLITS, SPLIT_BN, flat_gemm,
                                           flat_gemm_plain, gemm_tiles,
                                           pick_bk, pick_splits, split_acc,
                                           split_smem)
from repro_torch.models import wquant as tw

BF16 = TOL["bfloat16"]
H100 = hardware.H100_SXM
# (K, N): two splits of one tile, the second ragged (72 of 128); eight
# splits of one tile, the last ragged (104); six splits of two tiles, the
# last one tile of 120; N not a multiple of BN = 64
SHAPES = [(200, 136), (1000, 136), (1400, 1000)]
WEIGHTS = ["bf16", "int8", "fp8"]
QSPECS = {"int8": (jq.INT8, tq.INT8), "fp8": (jq.FP8, tq.FP8)}


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


def test_test_shapes_split_on_the_default_card():
    for k, n in SHAPES:
        for w_bytes in (2, 1):
            body, _, splits = gemm_tiles(k, n, w_bytes=w_bytes)
            assert body == "split" and splits > 1


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 13, 64])
def test_split_flat_gemm_matches_pallas(m, k, n, kind):
    rng = np.random.default_rng(m * 1000 + k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jflat_gemm(jx, jwt, w_scale=js, interpret=True)
    got = flat_gemm_plain(tx, twt, w_scale=ts)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(flat_gemm(tx, twt, w_scale=ts), got)


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 13, 64])
def test_split_oproj_residual_matches_pallas(m, k, n, kind):
    rng = np.random.default_rng(m * 1000 + k + n + 1)
    jo, to = _bf16_pair(rng.normal(size=(m, k)))
    jr, tr = _bf16_pair(rng.normal(size=(m, n)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jdf.oproj_residual_fused(jo, jwt, jr, w_scale=js, interpret=True)
    got = tdf.oproj_residual_plain(to, twt, tr, w_scale=ts)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _close(got, want)
    assert torch.equal(tdf.oproj_residual_fused(to, twt, tr, w_scale=ts),
                       got)


def test_pick_splits_on_h100():
    import inspect
    spec = H100
    # the tied head (896 -> 152064, the (N, K) view) fills the card with
    # its columns: the wgmma body, one split
    assert pick_splits(896, 152064, 128, 128, spec=spec) == 1
    assert gemm_tiles(896, 152064, w_kn=False, spec=spec) == ("wgmma", 64, 1)
    # the decode GEMMs of qwen2-0.5b: q / o_proj (896 -> 896), k / v
    # (896 -> 128), down (4864 -> 896), bf16 and 1-byte codes
    want = {(896, 896): 7, (896, 128): 7, (4864, 896): 8}
    for (k, n), splits in want.items():
        for w_bytes in (2, 1):
            body, bk, s = gemm_tiles(k, n, w_bytes=w_bytes, spec=spec)
            assert (body, bk, s) == ("split", 128, splits)
            bn = SPLIT_BN
            n_kt = -(-k // bk)
            # every SM gets a block, or every K tile (up to a portable
            # cluster) is a split of its own
            assert (-(-n // bn) * s >= spec.num_sms
                    or s == min(n_kt, MAX_SPLITS))
            # ceil(n_kt / splits) tiles a split: none is empty
            assert -(-n_kt // -(-n_kt // s)) == s
            assert bk == pick_bk(k, w_bytes=w_bytes, spec=spec)
            assert split_smem(bk, w_kn=True, w_bytes=w_bytes) \
                <= spec.smem_per_block
    # a function of K, N and the card only: the pickers take no M
    for fn in (gemm_tiles, pick_splits, pick_bk):
        assert "m" not in inspect.signature(fn).parameters
    # columns that fill the card alone (132 blocks of 32) never take the
    # split body; a split grid aims at two blocks per SM
    assert gemm_tiles(896, 4864, spec=spec)[0] == "wgmma"
    assert gemm_tiles(4864, 132 * 32, spec=spec)[0] == "wgmma"
    assert gemm_tiles(4864, 131 * 32, spec=spec)[0] == "split"
    assert gemm_tiles(4864, 131 * 32, spec=spec)[2] > 1
    assert pick_splits(4864, 131 * 32, 32, 128, spec=spec) == 3
    assert pick_splits(4864, 264 * 32, 32, 128, spec=spec) == 1


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_split_row_alone_bitwise_in_batch(k, n, kind):
    rng = np.random.default_rng(k * n)
    _, tx = _bf16_pair(rng.normal(size=(64, k)))
    _, tr = _bf16_pair(rng.normal(size=(64, n)))
    _, (twt, ts) = _weight(rng, k, n, kind)
    for m in (13, 64):
        batch = flat_gemm_plain(tx[:m], twt, w_scale=ts)
        fused = tdf.oproj_residual_plain(tx[:m], twt, tr[:m], w_scale=ts)
        for i in (0, 5, m - 1):
            alone = flat_gemm_plain(tx[i:i + 1], twt, w_scale=ts)
            assert (_bits(alone) == _bits(batch[i:i + 1])).all()
            alone = tdf.oproj_residual_plain(tx[i:i + 1], twt, tr[i:i + 1],
                                             w_scale=ts)
            assert (_bits(alone) == _bits(fused[i:i + 1])).all()


def test_split_acc_walks_whole_tiles_from_zero():
    """split_acc at (BK 128, 6 splits) over K = 1400: splits of two tiles
    from K = 0 (the last one tile of 120), tiles summed in K order inside
    a split, the splits in split order, each row on its own."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 1400)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(1400, 40)).astype(np.float32))
    got = split_acc(x, w, 128, 6)
    for r in range(3):
        total = None
        for lo in range(0, 1400, 256):
            part = torch.zeros(40)
            for t in range(lo, min(lo + 256, 1400), 128):
                part += x[r, t:t + 128] @ w[t:t + 128]
            total = part if total is None else total + part
        assert torch.equal(got[r], total)
    step = torch.from_numpy(rng.uniform(0.5, 2, size=40).astype(np.float32))
    assert torch.equal(split_acc(x, w, 128, 6, step), got * step)
