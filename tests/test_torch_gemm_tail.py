"""The GEMM kernels' odd-N tail (rows 1 and 2) on CPU tensors.

A bf16 (K, N) weight whose N is not a multiple of 8 (hymba's ``w_dt``,
1,600 -> 50) has rows that are not 16-byte aligned. The JAX package's
``flat_gemm`` pads N to its tile; the port's kernels load such rows
element by element instead (columns past N as zero) and write only the
columns below N, and the flat GEMM always runs the split body for them
(TMA cannot take the unaligned rows). Here:

  * the plain versions, which walk the launched body's tiles and splits,
    against the JAX package's ``gemv`` and ``flat_gemm`` (interpret=True)
    at N in {50, 18, 32}, M in {1, 4, 7}, within ``TOL["bfloat16"]``, and
    each row bitwise the same alone as in its batch;
  * the launch checks (``gemv.launch_layout``) accept such weights in
    bf16 and refuse them as codes, which keep N a multiple of 16;
  * ``flat_gemm.gemm_tiles`` sends an unaligned weight to the split body
    whatever its width, from K and N alone.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels.flat_gemm import flat_gemm as jflat_gemm
from repro.kernels.gemv import gemv as jgemv
from repro_torch.kernels import quant as tq
from repro_torch.kernels.flat_gemm import (flat_gemm, flat_gemm_plain,
                                           gemm_tiles)
from repro_torch.kernels.gemv import gemv, gemv_plain, kn_tail, launch_layout
from repro_torch.models import wquant as tw

BF16 = TOL["bfloat16"]
SHAPES = [(1600, 50), (1600, 18), (1600, 32), (384, 50)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(a: np.ndarray):
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 7])
@pytest.mark.parametrize("which", ["gemv", "flat_gemm"])
def test_odd_n_plain_matches_pallas(which, m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    jw, tw_ = _bf16_pair(rng.normal(size=(k, n)) * k ** -0.5)
    jfn, plain, wrapper = {"gemv": (jgemv, gemv_plain, gemv),
                           "flat_gemm": (jflat_gemm, flat_gemm_plain,
                                         flat_gemm)}[which]
    want = np.asarray(jfn(jx, jw, interpret=True), np.float32)
    got = plain(tx, tw_)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    assert torch.equal(wrapper(tx, tw_), got)
    for i in range(m):
        assert torch.equal(plain(tx[i:i + 1], tw_), got[i:i + 1])


@pytest.mark.parametrize("n", [50, 18, 51])
def test_launch_checks_take_any_n_in_bf16(n):
    x = torch.zeros((4, 1600), dtype=torch.bfloat16)
    w = torch.zeros((1600, n), dtype=torch.bfloat16)
    for what in ("gemv", "flat_gemm"):
        assert launch_layout(what, x, w, None) == (True, n, 0)
    assert kn_tail(w)
    q = tw.quantize_weight(torch.ones((1600, n), dtype=torch.bfloat16),
                           tq.INT8)
    with pytest.raises(ValueError, match="N a multiple of 16"):
        launch_layout("gemv", x, q["codes"], q["scale"])
    # x's rows must stay 16-byte vectors: K a multiple of 8
    with pytest.raises(ValueError, match="K a multiple of 8"):
        launch_layout("flat_gemm", torch.zeros((4, 1601),
                                               dtype=torch.bfloat16)[:, 1:],
                      w, None)


def test_unaligned_weights_run_the_split_body():
    assert not kn_tail(torch.zeros((1600, 32), dtype=torch.bfloat16))
    # wide N would take the wgmma body; unaligned rows cannot feed TMA
    assert gemm_tiles(1600, 32256)[0] == "wgmma"
    body, bk, splits = gemm_tiles(1600, 32258, tail=True)
    assert body == "split" and splits >= 1
    assert gemm_tiles(1600, 50, tail=True) == gemm_tiles(1600, 50)
    assert gemm_tiles(1600, 50)[0] == "split"
