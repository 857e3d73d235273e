"""The port's kernel modules (repro_torch.kernels.*) on CPU tensors — their
plain versions — against the JAX package's Pallas kernels run the way its
own tests run them (``interpret=True``), on the same numpy inputs.

Tolerances: TOL["float32"] for f32 inputs (same math, other summation
order); TOL["bfloat16"] for bf16 inputs (bf16 rounds at other points in
the two frameworks). The CUDA kernels themselves are held to these plain
versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import decode_attention as jda
from repro.kernels.flash_prefill import flash_prefill as jflash_prefill
from repro.kernels.flat_gemm import flat_gemm as jflat_gemm
from repro.kernels.gemv import gemv as jgemv
from repro_torch import hardware
from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core.dispatch import DispatchEntry, Impl
from repro_torch.core.plan import MatmulPlan, make_plan
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_prefill as tfp
from repro_torch.kernels import ops
from repro_torch.kernels.flat_gemm import (flat_gemm, gemm_tiles, pick_bk,
                                           split_smem)
from repro_torch.kernels.gemv import gemv

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``
    (rounded once, in f32 -> dtype, on the JAX side, then carried over
    bit for bit)."""
    j = jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# GEMMs (both weight layouts: row-major (K, N) and the transposed view of a
# row-major (N, K) tensor, the tied-LM-head layout)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,fn,jfn", [
    (1, 200, 136, gemv, jgemv),
    (2, 96, 72, gemv, jgemv),
    (3, 200, 136, flat_gemm, jflat_gemm),
    (5, 96, 72, flat_gemm, jflat_gemm),
    (8, 200, 136, flat_gemm, jflat_gemm),
    (13, 96, 72, flat_gemm, jflat_gemm),
    (64, 200, 136, flat_gemm, jflat_gemm),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_gemm_matches_pallas_kernel(m, k, n, fn, jfn, dtype):
    rng = np.random.default_rng(m * 100 + k)
    jx, tx = _pair(rng.normal(size=(m, k)), dtype)
    jw, tw = _pair(rng.normal(size=(k, n)) * k ** -0.5, dtype)
    want = jfn(jx, jw, interpret=True)
    _close(fn(tx, tw), want, dtype)                      # (K, N) row-major
    _close(fn(tx, tw.T.contiguous().T), want, dtype)     # (N, K) view


def test_pick_bn_bk_on_h100():
    """The flat GEMM's tiles on the H100: narrow N (fewer than 132 blocks
    of 32 columns) takes the split body at pick_bk's BK; every wider N
    the wgmma body's fixed 64-column, 64-row K tile (no BN to pick)."""
    spec = hardware.H100_SXM
    assert spec.num_sms == 132 and spec.smem_per_block == 232_448
    # decode shapes of qwen2-0.5b: q / o_proj, gate / up, the tied head
    assert gemm_tiles(896, 896, spec=spec) == ("split", 128, 7)
    assert gemm_tiles(896, 4864, spec=spec) == ("wgmma", 64, 5)
    assert gemm_tiles(896, 152064, w_kn=False, spec=spec) == (
        "wgmma", 64, 1)
    # the boundary: 131 blocks of 32 columns are narrow, 132 are not
    assert gemm_tiles(4864, 131 * 32, spec=spec)[0] == "split"
    assert gemm_tiles(4864, 132 * 32, spec=spec)[0] == "wgmma"
    for k in (896, 4864, 40):
        for w_kn in (True, False):
            bk = pick_bk(k, w_kn=w_kn, spec=spec)
            assert bk <= max(32, -(-k // 32) * 32)
            assert split_smem(bk, w_kn=w_kn) <= spec.smem_per_block
    assert pick_bk(896, spec=spec) == 128
    assert pick_bk(40, spec=spec) == 64
    # a card with a small shared-memory budget gets shallower K tiles
    tiny = hardware.HardwareSpec(**{**spec.__dict__, "smem_per_block": 40_000})
    assert pick_bk(4096, spec=tiny) < pick_bk(4096, spec=spec)
    # the budget is counted for the layout launched: a 128-deep K tile's
    # four stages fit 140 000 bytes as (N, K) rows (139 264) but not as
    # (K, N) rows (143 360)
    edge = hardware.HardwareSpec(**{**spec.__dict__, "smem_per_block": 140_000})
    assert pick_bk(4096, w_kn=True, spec=edge) == 64
    assert pick_bk(4096, w_kn=False, spec=edge) == 128


@pytest.mark.parametrize("m,want", [(1, Impl.GEMV), (2, Impl.GEMV),
                                    (3, Impl.FLAT_GEMM), (64, Impl.FLAT_GEMM),
                                    (127, Impl.FLAT_GEMM),
                                    (128, Impl.XLA_DOT)])
def test_matmul_plan_ladder_routes_by_m(m, want, monkeypatch):
    """The default ladder m1=3, m2=128, and ops.matmul dispatching on it:
    the kernel wrapper the plan picks is the one that runs."""
    assert MatmulPlan().pick(m, 64, 48) is want
    calls = []
    monkeypatch.setattr(ops, "gemv", lambda x, w: calls.append("gemv")
                        or x @ w)
    monkeypatch.setattr(ops, "flat_gemm", lambda x, w: calls.append("flat")
                        or x @ w)
    x, w = torch.randn(m, 64), torch.randn(64, 48)
    out = ops.matmul(x, w, plan=make_plan("cuda"))
    assert out.shape == (m, 48)
    assert calls == {Impl.GEMV: ["gemv"], Impl.FLAT_GEMM: ["flat"],
                     Impl.XLA_DOT: []}[want]
    calls.clear()
    ops.matmul(x, w, plan=make_plan("torch"))
    assert calls == []                       # the torch backend: ref math
    # a tuned entry overrides the default ladder for its [K, N]
    tuned = MatmulPlan(entries={(64, 48): DispatchEntry(64, 48, 1, 2)})
    assert tuned.pick(1, 64, 48) is Impl.FLAT_GEMM
    assert tuned.pick(2, 64, 48) is Impl.XLA_DOT


# ---------------------------------------------------------------------------
# Decode attention (dense cache, (B, HK, S, D) layout as the JAX kernels)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_max,block_k,lengths", [
    (64, 16, [64, 37, 1]),        # ragged, block_k divides S
    (40, 16, [40, 17, 5]),        # S not a block_k multiple (padded tiles)
    (48, 48, [3, 48, 30]),        # one tile
])
def test_decode_attention_matches_pallas(s_max, block_k, lengths, dtype):
    b, hq, hk, d = 3, 8, 2, 32
    rng = np.random.default_rng(s_max + block_k)
    jq, tq = _pair(rng.normal(size=(b, hq, d)), dtype)
    jk, tk = _pair(rng.normal(size=(b, hk, s_max, d)), dtype)
    jv, tv = _pair(rng.normal(size=(b, hk, s_max, d)), dtype)
    lens = np.array(lengths, np.int32)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)

    want, want_stat = jda.decode_attention_unified_max(
        jq, jk, jv, jl, phi=0.25, block_k=block_k, interpret=True)
    got, stat = tda.decode_attention_unified_max(tq, tk, tv, tl, phi=0.25,
                                                 block_k=block_k)
    _close(got, want, dtype)
    _close(stat, want_stat, "float32" if dtype == "float32" else dtype)
    want = jda.decode_attention_sync(jq, jk, jv, jl, block_k=block_k,
                                     interpret=True)
    _close(tda.decode_attention_sync(tq, tk, tv, tl, block_k=block_k), want,
           dtype)


def test_decode_sync_recompute_flag_selects_output():
    """``out``/``flag`` form: untouched when the flag is clear, replaced
    by the online-max result when it is set."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 24, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 2, 24, 16)).astype(np.float32))
    lens = torch.tensor([24, 7], dtype=torch.int32)
    sync = tda.decode_attention_sync(q, k, v, lens)
    prev = torch.full_like(sync, 7.0)
    kept = tda.decode_attention_sync(q, k, v, lens, out=prev,
                                     flag=torch.tensor(False))
    assert torch.equal(kept, prev)
    redone = tda.decode_attention_sync(q, k, v, lens, out=prev,
                                       flag=torch.tensor(True))
    assert torch.equal(redone, sync)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_attention_decode_front_door_overflow_recompute(backend):
    """Logits far outside φ's band: the unified-max stat crosses band[1]
    and the front door returns the online-max result on both backends."""
    rng = np.random.default_rng(1)
    b, s, hk, hq, d = 2, 32, 2, 4, 16
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)) * 40
    kc = torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32))
    lens = torch.tensor([32, 9], dtype=torch.int32)
    phi = SoftmaxPhiConfig()
    _, stat = tda.decode_attention_unified_max(
        q, kc.transpose(1, 2), vc.transpose(1, 2), lens)
    assert (stat > phi.band[1]).any()
    got = ops.attention_decode(q, kc, vc, lens, phi_cfg=phi,
                               plan=make_plan(backend))
    want = tda.decode_attention_sync(q, kc.transpose(1, 2),
                                     vc.transpose(1, 2), lens)
    assert torch.isfinite(got).all()
    _close(got, want.numpy(), "float32")


# ---------------------------------------------------------------------------
# Flash prefill (both schemes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window,block", [
    (16, 16, True, 0, 16),        # one query tile: stat comparable
    (32, 32, True, 0, 16),        # two query tiles
    (32, 32, True, 8, 16),        # sliding window
    (16, 48, True, 0, 16),        # Sk > Sq (chunk continuation)
    (16, 32, False, 0, 16),       # no mask
])
def test_flash_prefill_matches_pallas(sq, sk, causal, window, block, dtype):
    b, hq, hk, d = 2, 4, 2, 16
    rng = np.random.default_rng(sq * 7 + sk + window)
    jq, tq = _pair(rng.normal(size=(b, sq, hq, d)), dtype)
    jk, tk = _pair(rng.normal(size=(b, sk, hk, d)), dtype)
    jv, tv = _pair(rng.normal(size=(b, sk, hk, d)), dtype)
    kw = dict(causal=causal, sliding_window=window, block_q=block,
              block_k=block)

    want, want_stat = jflash_prefill(jq, jk, jv, unified_max=True,
                                        phi=0.5, interpret=True, **kw)
    got, stat = tfp.flash_prefill(tq, tk, tv, unified_max=True, phi=0.5,
                                  **kw)
    _close(got, want, dtype)
    if sq <= block:
        # the reference's stat is the last query tile's only; with one
        # tile that is the whole row set
        _close(stat, want_stat, "float32" if dtype == "float32" else dtype)
    want = jflash_prefill(jq, jk, jv, unified_max=False, interpret=True,
                             **kw)
    _close(tfp.flash_prefill(tq, tk, tv, unified_max=False, **kw), want,
           dtype)


@pytest.mark.parametrize("big_tile", [0, 1])
def test_flash_prefill_stat_is_true_max(big_tile):
    """With Sq > block_q the port's stat is the max of s − φ over every
    query row (numpy), whichever tile holds it — the reference keeps only
    the last tile's."""
    b, sq, hq, hk, d, blk, phi = 1, 64, 2, 1, 8, 16, 0.0
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sq, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, sq, hk, d)).astype(np.float32)
    row = 5 if big_tile == 0 else 40          # tile 0 or a middle tile
    q[0, row, 0] = 60.0 * k[0, 2, 0] / np.linalg.norm(k[0, 2, 0]) ** 2 \
        * np.sqrt(d)                          # s(row, key 2) = 60
    _, stat = tfp.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), unified_max=True,
                                phi=phi, block_q=blk, block_k=blk)
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, hq // hk, axis=2))
    s = s * d ** -0.5 - phi
    mask = np.tril(np.ones((sq, sq), bool))
    want = np.where(mask, s, -np.inf).max(axis=(2, 3))
    np.testing.assert_allclose(stat.numpy(), want, **TOL["float32"])
    assert stat.max().item() > 59.0


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_attention_prefill_front_door_overflow_recompute(backend):
    rng = np.random.default_rng(2)
    b, s, hq, hk, d = 1, 24, 4, 2, 16
    q = torch.from_numpy(rng.normal(size=(b, s, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32))
    q = q * 40
    got = ops.attention_prefill(q, k, v, phi_cfg=SoftmaxPhiConfig(),
                                plan=make_plan(backend))
    want = tfp.flash_prefill(q, k, v, unified_max=False)
    assert torch.isfinite(got).all()
    _close(got, want.numpy(), "float32")


def test_cpu_tensor_runs_plain_version_without_launch():
    """On a CPU tensor no wrapper touches the CUDA build or its counter."""
    before = (gemv.launches, flat_gemm.launches,
              tda.decode_attention_unified_max.launches,
              tfp.flash_prefill_unified_max.launches)
    x, w = torch.randn(2, 16), torch.randn(16, 8)
    gemv(x, w)
    flat_gemm(x, w)
    assert (gemv.launches, flat_gemm.launches,
            tda.decode_attention_unified_max.launches,
            tfp.flash_prefill_unified_max.launches) == before
