"""Plan-dispatched front doors: the GEMM router (T3) and the attention
entry points with the T1 overflow recompute.

Every wrapper takes one ``plan=`` operand (``None`` = ``DEFAULT_PLAN``,
the ``"cuda"`` backend). On ``"cuda"`` the kernel wrappers run — their
kernels on CUDA tensors, their plain versions on CPU tensors; on
``"torch"`` the reference math in :mod:`repro_torch.kernels.ref` runs.

A GEMM weight is a tensor or, quantized, the ``{"codes", "scale"}`` dict
of ``models/wquant.py``; :func:`_wparts` splits it, and the dict is the
one signal that sends the codes and steps into the kernels' quantized
variants (model call sites never change).

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
from repro_torch.kernels.chunk_attention import (
    paged_chunk_attention_sync,
    paged_chunk_attention_sync_quant,
    paged_chunk_attention_unified_max,
    paged_chunk_attention_unified_max_quant,
)
from repro_torch.kernels.decode_fuse import (
    decode_ingest_fused,
    decode_ingest_fused_quant,
    ffn_norm_fused,
    ffn_norm_fused_quant,
    oproj_residual_fused,
    oproj_residual_fused_quant,
)
from repro_torch.kernels.decode_attention import (
    decode_attention_partial_sync,
    decode_attention_partial_unified_max,
    decode_attention_sync,
    decode_attention_unified_max,
    paged_decode_attention_sync,
    paged_decode_attention_sync_quant,
    paged_decode_attention_unified_max,
    paged_decode_attention_unified_max_quant,
)
from repro_torch.kernels.flash_prefill import (
    flash_prefill_sync,
    flash_prefill_unified_max,
)
from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_quant
from repro_torch.kernels.fused_ffn import fused_ffn_up, fused_ffn_up_quant
from repro_torch.kernels.gemv import gemv, gemv_quant
from repro_torch.kernels.group_attention import (
    DecodeGroups,
    group_prefix_partials,
    group_prefix_partials_quant,
    group_tail_merge,
    group_tail_merge_quant,
    grouped_paged_decode_attention_unified_max,
)

# every kernel wrapper that counts its launches in ``.launches``, and the
# quantized variants' counters (a CUDA graph replay runs none of them, so
# the replay credits them instead)
LAUNCH_COUNTERS = (
    gemv, flat_gemm, fused_ffn_up, decode_ingest_fused,
    oproj_residual_fused, ffn_norm_fused, decode_attention_unified_max,
    decode_attention_sync, paged_decode_attention_unified_max,
    paged_decode_attention_sync, group_prefix_partials, group_tail_merge,
    flash_prefill_unified_max, flash_prefill_sync,
    paged_chunk_attention_unified_max, paged_chunk_attention_sync,
    gemv_quant, flat_gemm_quant, fused_ffn_up_quant,
    decode_ingest_fused_quant, oproj_residual_fused_quant,
    ffn_norm_fused_quant, paged_decode_attention_unified_max_quant,
    paged_decode_attention_sync_quant, paged_chunk_attention_unified_max_quant,
    paged_chunk_attention_sync_quant, group_prefix_partials_quant,
    group_tail_merge_quant, decode_attention_partial_unified_max,
    decode_attention_partial_sync,
)


def _unified(phi_cfg: SoftmaxPhiConfig, scheme: str) -> bool:
    """T1 runs only when the model has a calibrated φ *and* the plan asks
    for it; either veto selects the sync scheme."""
    return phi_cfg.active and scheme == "unified_max"


def _overflow(stat: torch.Tensor, phi_cfg: SoftmaxPhiConfig) -> torch.Tensor:
    return (stat > phi_cfg.band[1]).any()


def _wparts(w):
    """A GEMM weight operand as ``(tensor, per-output-channel steps or
    None)``: a quantized leaf (``{"codes", "scale"}``) gives its codes and
    steps, a tensor itself and None."""
    if isinstance(w, dict):
        return w["codes"], w["scale"]
    return w, None


# ---------------------------------------------------------------------------
# GEMM front door (T3)
# ---------------------------------------------------------------------------


def matmul(x: torch.Tensor, w, *,
           plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Plan-dispatched GEMM. x: (..., K), w: (K, N) — row-major, the
    transposed view of a row-major (N, K) tensor, or a quantized
    ``{"codes", "scale"}`` leaf."""
    mp = (plan or DEFAULT_PLAN).matmul
    w, w_scale = _wparts(w)
    lead = x.shape[:-1]
    k, n = x.shape[-1], w.shape[-1]
    x2 = x.reshape(-1, k)
    impl = mp.pick(x2.shape[0], k, n)
    if mp.backend != "cuda" or impl is Impl.XLA_DOT:
        # the library GEMM; with codes the reference's own XLA-dot
        # expression (codes cast to x's dtype, f32 accumulation, times the
        # step), which the JAX package computes outside any Pallas kernel
        # too, so this is the quantized path at M >= 128, not a fallback
        out = ref.flat_gemm_ref(x2, w, w_scale=w_scale)
    else:
        # bf16 weights keep the unchanged two-operand call
        qkw = {} if w_scale is None else {"w_scale": w_scale}
        kernel = gemv if impl is Impl.GEMV else flat_gemm
        out = kernel(x2, w, **qkw)
    return out.reshape(*lead, n)


def fused_ffn(x: torch.Tensor, w_gate, w_up, *, activation: str = "swiglu",
              plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` for x (..., K): the fused FFN-up
    kernel when the plan's ``fused_ffn`` entry is fused on ``"cuda"``,
    the reference math otherwise. Weights as :func:`matmul` takes them."""
    fp = (plan or DEFAULT_PLAN).fused_ffn
    w_gate, wg_scale = _wparts(w_gate)
    w_up, wu_scale = _wparts(w_up)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kw = dict(activation=activation, wg_scale=wg_scale, wu_scale=wu_scale)
    if fp.fused and fp.backend == "cuda":
        out = fused_ffn_up(x2, w_gate, w_up, **kw)
    else:
        out = ref.fused_ffn_up_ref(x2, w_gate, w_up, **kw)
    return out.reshape(*lead, w_gate.shape[-1])


# ---------------------------------------------------------------------------
# Decode-fusion stage front doors
# ---------------------------------------------------------------------------


def decode_ingest(x, norm_scale, wq, wk, wv, positions, *, num_heads: int,
                  num_kv_heads: int, head_dim: int, rope_theta: float = 1e4,
                  eps: float = 1e-6, use_rope: bool = True, bq=None, bk=None,
                  bv=None, plan: Optional[ExecutionPlan] = None):
    """Fused decode ingest: rmsnorm → QKV → bias → rope in one seam. x
    (B, 1, D), positions (B,) -> q (B, 1, HQ, Dh), k / v (B, 1, HK, Dh).
    The ingest kernel on ``"cuda"`` (plan.decode_fusion), the oracle
    that composes the split chain's expressions on ``"torch"``. Weights
    as :func:`matmul` takes them."""
    fp = (plan or DEFAULT_PLAN).decode_fusion
    wq, wq_scale = _wparts(wq)
    wk, wk_scale = _wparts(wk)
    wv, wv_scale = _wparts(wv)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              head_dim=head_dim, rope_theta=rope_theta, eps=eps,
              use_rope=use_rope, bq=bq, bk=bk, bv=bv, wq_scale=wq_scale,
              wk_scale=wk_scale, wv_scale=wv_scale)
    if fp.backend != "cuda":
        return ref.decode_ingest_ref(x, norm_scale, wq, wk, wv, positions,
                                     **kw)
    b, s, d = x.shape
    q, k, v = decode_ingest_fused(x.reshape(b * s, d), norm_scale, wq, wk,
                                  wv, positions, **kw)
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv_heads, head_dim),
            v.reshape(b, s, num_kv_heads, head_dim))


def oproj_residual(o, wo, resid, *,
                   plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """``resid + o @ wo`` (o (B, S, Q), resid (B, S, D)) with the residual
    add in the GEMM's epilogue on ``"cuda"``; the split composition on
    ``"torch"``. Serves the o_proj and the FFN down projection. ``wo`` as
    :func:`matmul` takes it."""
    fp = (plan or DEFAULT_PLAN).decode_fusion
    wo, w_scale = _wparts(wo)
    if fp.backend != "cuda":
        return ref.oproj_residual_ref(o, wo, resid, w_scale=w_scale)
    b, s, qd = o.shape
    out = oproj_residual_fused(o.reshape(b * s, qd), wo,
                               resid.reshape(b * s, -1), w_scale=w_scale)
    return out.reshape(resid.shape)


def ffn_norm(x, norm_scale, w_gate, w_up, *, activation: str = "swiglu",
             eps: float = 1e-6,
             plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Fused MLP ingest: rmsnorm → gate/up → act(g)·u, x (B, S, D) ->
    (B, S, F). The ffn_norm kernel on ``"cuda"``; on ``"torch"`` the
    oracle composes whichever split chain the plan's ``fused_ffn`` knob
    selects, so the fused granularities stay bitwise split. Feed the
    result to :func:`oproj_residual` with ``w_down`` for the whole
    seam. Weights as :func:`matmul` takes them."""
    p = plan or DEFAULT_PLAN
    w_gate, wg_scale = _wparts(w_gate)
    w_up, wu_scale = _wparts(w_up)
    kw = dict(activation=activation, eps=eps, wg_scale=wg_scale,
              wu_scale=wu_scale)
    if p.decode_fusion.backend != "cuda":
        return ref.ffn_norm_ref(x, norm_scale, w_gate, w_up,
                                fused=p.fused_ffn.fused, **kw)
    b, s, d = x.shape
    out = ffn_norm_fused(x.reshape(b * s, d), norm_scale, w_gate, w_up,
                         **kw)
    return out.reshape(b, s, -1)


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


def attention_decode_paged(q, k_pool, v_pool, block_tables, lengths, *,
                           phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
                           plan: Optional[ExecutionPlan] = None,
                           groups: Optional[DecodeGroups] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode attention over a block-paged pool (q (B,HQ,D), pools (NP,
    PS, HK, D), block_tables (B, NB)), governed by the plan's ``paged``
    entry. On ``"cuda"`` the paged kernels read each row's pages in place
    (T1, then the flag-gated recompute); on ``"torch"`` the pages are
    gathered into a dense view for the reference math — bitwise the
    dense path's when ``NB * PS`` equals the dense ``max_seq``.

    ``groups`` (a :class:`~repro_torch.kernels.group_attention.
    DecodeGroups`) selects the prefix-shared grouped path: on ``"cuda"``
    with the unified scheme the two-stage grouped kernels read each
    group's shared pages once; the sync scheme and the overflow
    recompute run the ungrouped sync kernel, which is exact. On
    ``"torch"`` the dense view is gathered through the group plan, so
    grouped and ungrouped results are bitwise equal.

    ``k_scale`` / ``v_scale`` ((NP, HK) f32 steps) mark the pools as
    int8 / fp8 codes. On ``"cuda"`` every kernel above runs its quantized
    body, which dequantizes each page as it reads it; on ``"torch"`` the
    pool-level dequantized view (:func:`ref.dequantize_pool_ref`) feeds
    the same reference math, as in the JAX package."""
    pp = (plan or DEFAULT_PLAN).paged
    unified = _unified(phi_cfg, pp.scheme)
    if pp.backend != "cuda":
        if k_scale is not None:
            k_pool = ref.dequantize_pool_ref(k_pool, k_scale)
            v_pool = ref.dequantize_pool_ref(v_pool, v_scale)
        args = (q, k_pool, v_pool, block_tables, lengths)
        if groups is None:
            safe_ref = ref.attention_decode_paged_ref
            fast_ref = ref.attention_decode_paged_unified_max_ref
        else:
            args += (groups,)
            safe_ref = ref.attention_decode_grouped_ref
            fast_ref = ref.attention_decode_grouped_unified_max_ref
        if not unified:
            return safe_ref(*args)
        out, stat = fast_ref(*args, phi=phi_cfg.phi)
        if not pp.fallback:
            return out
        return torch.where(_overflow(stat, phi_cfg), safe_ref(*args), out)

    qkw = dict(k_scale=k_scale, v_scale=v_scale)
    if not unified:
        return paged_decode_attention_sync(q, k_pool, v_pool, block_tables,
                                           lengths, **qkw)
    if groups is None:
        out, stat = paged_decode_attention_unified_max(
            q, k_pool, v_pool, block_tables, lengths, phi=phi_cfg.phi, **qkw)
    else:
        out, stat = grouped_paged_decode_attention_unified_max(
            q, k_pool, v_pool, block_tables, lengths, groups,
            phi=phi_cfg.phi, **qkw)
    if not pp.fallback:
        return out
    return paged_decode_attention_sync(q, k_pool, v_pool, block_tables,
                                       lengths, out=out,
                                       flag=_overflow(stat, phi_cfg), **qkw)


def attention_chunk_paged(q, k_pool, v_pool, block_tables, lengths, *,
                          phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
                          plan: Optional[ExecutionPlan] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          chunk_lens: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Paged twin of :func:`attention_chunk` (lengths before the chunk;
    the chunk's KV already in the pool), governed by the plan's ``paged``
    entry. ``gather_chunk="fused"`` on ``"cuda"`` runs the fused chunk
    kernels over the pool in place, with the scheme and recompute of
    ``plan.paged``; every other combination gathers the given tables
    into a dense view and runs :func:`attention_chunk`, as the JAX
    package does. A quantized pool (``k_scale`` / ``v_scale``) runs the
    fused kernels' quantized bodies, or gathers from the pool-level
    dequantized view. ``chunk_lens`` (the step's valid tokens per row)
    keeps the fused kernels from reading pool rows past each sequence's
    last valid position; it changes only rows the caller drops."""
    pp = (plan or DEFAULT_PLAN).paged
    if pp.backend == "cuda" and pp.gather_chunk == "fused":
        qkw = dict(k_scale=k_scale, v_scale=v_scale, chunk_lens=chunk_lens)
        if not _unified(phi_cfg, pp.scheme):
            return paged_chunk_attention_sync(q, k_pool, v_pool,
                                              block_tables, lengths, **qkw)
        out, stat = paged_chunk_attention_unified_max(
            q, k_pool, v_pool, block_tables, lengths, phi=phi_cfg.phi, **qkw)
        if not pp.fallback:
            return out
        return paged_chunk_attention_sync(q, k_pool, v_pool, block_tables,
                                          lengths, out=out,
                                          flag=_overflow(stat, phi_cfg),
                                          **qkw)
    if k_scale is not None:
        k_pool = ref.dequantize_pool_ref(k_pool, k_scale)
        v_pool = ref.dequantize_pool_ref(v_pool, v_scale)
    k = ref.gather_paged_kv(k_pool, block_tables)
    v = ref.gather_paged_kv(v_pool, block_tables)
    return attention_chunk(q, k, v, lengths, phi_cfg=phi_cfg, plan=plan)
