"""Split K of the port's GEMV (row 1, ImplA) on CPU tensors: its plain
version, which walks the kernel's splits (each split's whole
SPLIT_ROWS-row chunks in f32 from K = 0, the splits' sums in split order,
then the step and one rounding), against the JAX package's ``gemv`` run
with ``interpret=True`` on the same numpy inputs, within
``TOL["bfloat16"]``:

  * M in {1, 2, 3, 4}; bf16, int8 and fp8 weights (the quantized cases
    give both packages the same codes and steps: ``quantize_weight`` is
    bitwise the same in both, so the quantized comparison is held to the
    same tolerance as bf16 — bf16 output rounding plus summation order —
    not to the looser logits guard ``quant.logits_guard_tol``); a (K, N)
    weight over several splits with a ragged last chunk, and the
    transposed (N, K) view that the tied head reads unsplit;
  * ``pick_splits`` / ``gemv_tiles``: a function of K, N and the card,
    at most MAX_SPLITS, no split empty, one split where the columns fill
    the card;
  * a row's plain result bitwise the same alone as in a batch of 4, and
    the walk itself, chunk by chunk, bitwise.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import quant as jq
from repro.kernels.gemv import gemv as jgemv
from repro.models import wquant as jw
from repro_torch import hardware
from repro_torch.kernels import quant as tq
from repro_torch.kernels.gemv import (MAX_SPLITS, SPLIT_ROWS, gemv,
                                      gemv_plain, gemv_tiles, pick_cols,
                                      pick_splits)
from repro_torch.models import wquant as tw

BF16 = TOL["bfloat16"]
H100 = hardware.H100_SXM
# (K, N): four splits of one chunk, the last 8 rows; eight splits of three
# chunks, the last 56 rows. N a multiple of 16 (the codes' vectors), not
# of the 32-column block
SHAPES = [(200, 144), (1400, 1008)]
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


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def test_test_shapes_split_on_the_default_card():
    assert [gemv_tiles(k, n)[1] for k, n in SHAPES] == [4, 8]


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_split_gemv_matches_pallas(m, k, n, kind):
    rng = np.random.default_rng(m * 1000 + k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    (jwt, js), (twt, ts) = _weight(rng, k, n, kind)
    want = jgemv(jx, jwt, w_scale=js, interpret=True)
    got = gemv_plain(tx, twt, w_scale=ts)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(gemv(tx, twt, w_scale=ts), got)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_tied_head_view_matches_pallas(m):
    """The (N, K) view of a row-major embedding, as the tied head reads
    it: unsplit, against the JAX kernel on the materialised (K, N)."""
    rng = np.random.default_rng(m)
    k, n = 200, 272
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    je, te = _bf16_pair(rng.normal(size=(n, k)) * k ** -0.5)
    assert gemv_tiles(k, n, False) == (64, 1)
    got = gemv_plain(tx, te.T)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jgemv(jx, je.T, interpret=True), np.float32), **BF16)
    assert torch.equal(gemv(tx, te.T), got)


def test_pick_splits_on_h100():
    spec = H100
    # a function of K, N and the card: no M anywhere in the signatures
    for fn in (pick_cols, pick_splits, gemv_tiles):
        assert "m" not in inspect.signature(fn).parameters
    # the GEMV shapes of qwen2-0.5b at one slot: q / o_proj, k / v, down
    # narrow (32 columns), gate / up at 64 columns
    want = {(896, 896): (32, 7), (896, 128): (32, 7), (4864, 896): (32, 8),
            (896, 4864): (64, 3)}
    for (k, n), tiles in want.items():
        cols, s = gemv_tiles(k, n, spec=spec)
        assert (cols, s) == tiles
        n_ch = -(-k // SPLIT_ROWS)
        assert 1 <= s <= MAX_SPLITS
        # ceil(n_ch / splits) chunks a split: none is empty
        assert -(-n_ch // -(-n_ch // s)) == s
        # one wave at two blocks per SM
        assert -(-n // cols) * s <= 2 * spec.num_sms
    # columns that fill the card alone are never split; the (N, K) view
    # (the tied head) launches unsplit
    assert gemv_tiles(896, 152064, spec=spec) == (64, 1)
    assert gemv_tiles(896, 152064, False, spec=spec) == (64, 1)
    # the card's size moves both: on half the SMs one wave holds half
    # the blocks, and 64-column blocks of N = 896 already fill it
    half = dataclasses.replace(spec, num_sms=66)
    assert pick_splits(896, 4864, spec=half) == 1
    assert pick_splits(896, 4864, spec=spec) == 3
    assert pick_cols(896, spec=half) == 64
    assert pick_cols(896, spec=spec) == 32


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("k,n", SHAPES)
def test_split_row_alone_bitwise_in_batch(k, n, kind):
    rng = np.random.default_rng(k * n)
    _, tx = _bf16_pair(rng.normal(size=(4, k)))
    _, (twt, ts) = _weight(rng, k, n, kind)
    batch = gemv_plain(tx, twt, w_scale=ts)
    for i in range(4):
        alone = gemv_plain(tx[i:i + 1], twt, w_scale=ts)
        assert (_bits(alone) == _bits(batch[i:i + 1])).all()


@pytest.mark.parametrize("kind", WEIGHTS)
def test_split_walks_whole_chunks_from_zero(kind):
    """K = 1400 at N = 1008 is 8 splits of three 64-row chunks from
    K = 0, the last split 56 rows: chunks summed in K order inside a
    split, the splits in split order, the step on the sum, then one
    rounding — each row on its own."""
    rng = np.random.default_rng(11)
    k, n = 1400, 1008
    _, tx = _bf16_pair(rng.normal(size=(3, k)))
    _, (twt, ts) = _weight(rng, k, n, kind)
    assert gemv_tiles(k, n)[1] == 8
    span = 3 * SPLIT_ROWS
    got = gemv_plain(tx, twt, w_scale=ts)
    for r in range(3):
        total = None
        for lo in range(0, k, span):
            part = torch.zeros(n)
            for t in range(lo, min(lo + span, k), SPLIT_ROWS):
                part += tx[r, t:t + SPLIT_ROWS].float() @ \
                    twt[t:t + SPLIT_ROWS].float()
            total = part if total is None else total + part
        if ts is not None:
            total = total * ts
        assert torch.equal(got[r], total.to(torch.bfloat16))
