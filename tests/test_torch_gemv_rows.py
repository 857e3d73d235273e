"""The port's GEMV past four rows, on CPU tensors. The CUDA kernel holds
at most MAX_M = 4 token rows; a call with more launches it on consecutive
slices (``gemv.row_slices``) that write one output. The tiles
(``gemv_tiles``: columns a block, K splits) depend on K, N and the card
only, so every slice runs the same splits and a row's bits are the bits
it gets alone:

  * ``row_slices`` covers M in {5, 8, 15} (and 1 .. 4) with consecutive
    slices of at most four rows, and refuses M = 0;
  * the plain version (what the wrapper runs on a CPU tensor) at M = 15
    is bitwise each row taken alone and each slice taken alone, bf16,
    int8 and fp8;
  * it agrees with the JAX package's ``gemv`` run with ``interpret=True``
    at M = 15 within ``TOL["bfloat16"]`` (bf16 output rounding plus
    summation order; the quantized cases give both packages the same
    codes and steps).

``chip_smoke.py`` holds the kernel to these slices on the card (M = 5, 8
and 15, each row bitwise alone).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import quant as jq
from repro.kernels.gemv import gemv as jgemv
from repro.models import wquant as jw
from repro_torch.kernels import quant as tq
from repro_torch.kernels.gemv import (MAX_M, gemv, gemv_plain, gemv_tiles,
                                      row_slices)
from repro_torch.models import wquant as tw

BF16 = TOL["bfloat16"]
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
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _weight(rng, k, n, kind):
    jwb, twb = _bf16_pair(rng.normal(size=(k, n)) * k ** -0.5)
    if kind == "bf16":
        return (jwb, None), (twb, None)
    js, ts = QSPECS[kind]
    jl, tl = jw.quantize_weight(jwb, js), tw.quantize_weight(twb, ts)
    return (jl["codes"], jl["scale"]), (tl["codes"], tl["scale"])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("m,want", [
    (1, [(0, 1)]), (4, [(0, 4)]), (5, [(0, 4), (4, 5)]),
    (8, [(0, 4), (4, 8)]), (15, [(0, 4), (4, 8), (8, 12), (12, 15)])])
def test_row_slices_cover_m_in_kernel_sized_slices(m, want):
    slices = row_slices(m)
    assert slices == want
    assert all(1 <= hi - lo <= MAX_M for lo, hi in slices)
    # consecutive, from row 0 to row M - 1, each row once
    assert [r for lo, hi in slices for r in range(lo, hi)] == list(range(m))


def test_row_slices_refuse_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        row_slices(0)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("k,n", [(200, 144), (1400, 1008)])
def test_fifteen_rows_bitwise_alone_and_by_slice(k, n, kind):
    """M = 15 over a split weight: each row, and each kernel-sized slice,
    taken alone gives its rows' bits in the batch."""
    rng = np.random.default_rng(k + n)
    _, tx = _bf16_pair(rng.normal(size=(15, k)))
    _, (twt, ts) = _weight(rng, k, n, kind)
    assert gemv_tiles(k, n)[1] > 1
    batch = gemv_plain(tx, twt, w_scale=ts)
    assert batch.shape == (15, n)
    for i in range(15):
        assert (_bits(gemv_plain(tx[i:i + 1], twt, w_scale=ts))
                == _bits(batch[i:i + 1])).all()
    for lo, hi in row_slices(15):
        assert (_bits(gemv_plain(tx[lo:hi], twt, w_scale=ts))
                == _bits(batch[lo:hi])).all()
    # the wrapper on a CPU tensor is the plain version, at any M
    assert torch.equal(gemv(tx, twt, w_scale=ts), batch)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("m", [5, 8, 15])
def test_many_rows_match_pallas(m, kind):
    rng = np.random.default_rng(m * 7)
    k, n = 1400, 1008
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jgemv(jx, jwt, w_scale=js, interpret=True)
    got = gemv_plain(tx, twt, w_scale=ts)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
