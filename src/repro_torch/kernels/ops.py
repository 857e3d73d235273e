"""Plan-dispatched front doors: the GEMM router (T3) and the attention
entry points with the T1 overflow recompute.

Every wrapper takes one ``plan=`` operand (``None`` = ``DEFAULT_PLAN``,
the ``"cuda"`` backend). On ``"cuda"`` the kernel wrappers run — their
kernels on CUDA tensors, their plain versions on CPU tensors; on
``"torch"`` the reference math in :mod:`repro_torch.kernels.ref` runs.

The JAX package's ``lax.cond`` overflow recompute becomes a device-side
flag here: ``flag = (stat > band_hi).any()`` stays on the card, and the
sync kernel reads it at entry and returns at once unless it is set, so
no layer waits on a host sync. The ``"torch"`` backend selects with
``torch.where``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core.dispatch import Impl
from repro_torch.core.plan import DEFAULT_PLAN, ExecutionPlan
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    decode_attention_sync,
    decode_attention_unified_max,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill_sync,
    flash_prefill_unified_max,
)
from repro_torch.kernels.flat_gemm import flat_gemm
from repro_torch.kernels.gemv import gemv


def _unified(phi_cfg: SoftmaxPhiConfig, scheme: str) -> bool:
    """T1 runs only when the model has a calibrated φ *and* the plan asks
    for it; either veto selects the sync scheme."""
    return phi_cfg.active and scheme == "unified_max"


def _overflow(stat: torch.Tensor, phi_cfg: SoftmaxPhiConfig) -> torch.Tensor:
    return (stat > phi_cfg.band[1]).any()


# ---------------------------------------------------------------------------
# GEMM front door (T3)
# ---------------------------------------------------------------------------


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Plan-dispatched GEMM. x: (..., K), w: (K, N) — row-major or the
    transposed view of a row-major (N, K) tensor."""
    mp = (plan or DEFAULT_PLAN).matmul
    lead = x.shape[:-1]
    k, n = x.shape[-1], w.shape[-1]
    x2 = x.reshape(-1, k)
    impl = mp.pick(x2.shape[0], k, n)
    if mp.backend != "cuda" or impl is Impl.XLA_DOT:
        out = ref.flat_gemm_ref(x2, w)
    elif impl is Impl.GEMV:
        out = gemv(x2, w)
    else:
        out = flat_gemm(x2, w)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# Attention front doors (T1)
# ---------------------------------------------------------------------------


def attention_prefill(q, k, v, *,
                      phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
                      causal: bool = True, sliding_window: int = 0,
                      plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Prefill attention (q (B,Sq,HQ,D), k/v (B,Sk,HK,D)) with T1 and the
    overflow recompute."""
    ap = (plan or DEFAULT_PLAN).attention_prefill
    unified = _unified(phi_cfg, ap.scheme)
    if ap.backend != "cuda":
        if q.shape[1] * k.shape[1] >= ap.chunk_threshold ** 2:
            return ref.attention_prefill_chunked(
                q, k, v, causal=causal, sliding_window=sliding_window,
                phi=phi_cfg.phi if unified else None)
        return ref.attention_prefill_ref(q, k, v, causal=causal,
                                         sliding_window=sliding_window)
    if not unified:
        return flash_prefill_sync(q, k, v, causal=causal,
                                  sliding_window=sliding_window)
    out, stat = flash_prefill_unified_max(
        q, k, v, causal=causal, phi=phi_cfg.phi,
        sliding_window=sliding_window)
    if not ap.fallback:
        return out
    return flash_prefill_sync(q, k, v, causal=causal,
                              sliding_window=sliding_window, out=out,
                              flag=_overflow(stat, phi_cfg))


def attention_decode(q, k_cache, v_cache, lengths, *,
                     phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
                     plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Decode attention (q (B,HQ,D), caches (B,S,HK,D)) with T1 and the
    overflow recompute. The kernels read the caches in place through a
    (B, HK, S, D) transposed view — no copy."""
    dp = (plan or DEFAULT_PLAN).attention_decode
    unified = _unified(phi_cfg, dp.scheme)
    if dp.backend != "cuda":
        if not unified:
            return ref.attention_decode_ref(q, k_cache, v_cache, lengths)
        out, stat = ref.attention_decode_unified_max_ref(
            q, k_cache, v_cache, lengths, phi=phi_cfg.phi)
        if not dp.fallback:
            return out
        safe = ref.attention_decode_ref(q, k_cache, v_cache, lengths)
        return torch.where(_overflow(stat, phi_cfg), safe, out)

    kt = k_cache.transpose(1, 2)          # views: (B, HK, S, D)
    vt = v_cache.transpose(1, 2)
    # block_k reaches only the plain versions (CPU tensors), which walk
    # the cache in the TPU kernel's tiles; the CUDA kernel ignores it
    if not unified:
        return decode_attention_sync(q, kt, vt, lengths, block_k=dp.block_k)
    out, stat = decode_attention_unified_max(
        q, kt, vt, lengths, phi=phi_cfg.phi, block_k=dp.block_k)
    if not dp.fallback:
        return out
    return decode_attention_sync(q, kt, vt, lengths, block_k=dp.block_k,
                                 out=out, flag=_overflow(stat, phi_cfg))


def attention_chunk(q, k_cache, v_cache, lengths, *,
                    phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Chunked-prefill attention: C tokens attend to prefix + chunk. As
    in the JAX package this is reference math on both backends, with the
    scheme and recompute taken from the plan's ``attention_prefill``."""
    ap = (plan or DEFAULT_PLAN).attention_prefill
    if not _unified(phi_cfg, ap.scheme):
        return ref.attention_chunk_ref(q, k_cache, v_cache, lengths,
                                       phi=None)
    out, stat = ref.attention_chunk_unified_max_ref(
        q, k_cache, v_cache, lengths, phi=phi_cfg.phi)
    if not ap.fallback:
        return out
    safe = ref.attention_chunk_ref(q, k_cache, v_cache, lengths, phi=None)
    return torch.where(_overflow(stat, phi_cfg), safe, out)
