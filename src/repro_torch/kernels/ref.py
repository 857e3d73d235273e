"""Plain PyTorch reference math for the main path — the ``"torch"`` plan
backend, and the oracles the kernel tests hold the port to.

Shapes follow the JAX package's conventions:
  * prefill attention:  q,k,v = (batch, seq, heads, head_dim)  (kv heads may differ)
  * decode attention:   q = (batch, q_heads, head_dim),
                        k,v = (batch, kv_len, kv_heads, head_dim)
  * chunk attention:    q = (batch, chunk, q_heads, head_dim), caches as decode
  * flat gemm / gemv:   x = (M, K), w = (K, N)
All softmax math runs in float32; outputs come back in q's dtype.
"""
from __future__ import annotations

import torch


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Max-stabilized softmax over the last axis (a row of -inf gives NaN,
    as in the JAX oracle)."""
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, scale: float):
    """q (B, Q, HK, G, D), k (B, S, HK, D) -> f32 scores (B, HK, G, Q, S)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def prefill_mask(sq: int, sk: int, causal: bool, window: int, device):
    """(Sq, Sk) validity: query i sits at key position i + Sk - Sq."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
    if window:
        mask &= (qi - ki) < window
    return mask


# ---------------------------------------------------------------------------
# Attention oracles
# ---------------------------------------------------------------------------


def attention_prefill_ref(q, k, v, *, causal: bool = True,
                          scale: float | None = None,
                          sliding_window: int = 0) -> torch.Tensor:
    """Full (quadratic) softmax attention, f32 internals."""
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    s = _grouped_scores(q.reshape(b, sq, hk, g, d), k, scale)
    if causal or sliding_window:
        mask = prefill_mask(sq, sk, causal, sliding_window, q.device)
        s = s.masked_fill(~mask, float("-inf"))
    p = _softmax(s)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def attention_prefill_chunked(q, k, v, *, causal: bool = True,
                              scale: float | None = None,
                              sliding_window: int = 0,
                              phi: float | None = 0.0,
                              block_q: int = 512) -> torch.Tensor:
    """Blockwise prefill attention: a loop over query blocks keeps live
    memory at (B, H, block_q, Sk). With ``phi`` set this is the T1
    unified-max scheme; ``phi=None`` uses the per-row max."""
    b, sq, hq, d = q.shape
    _, sk, hk, _ = k.shape
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, hk, g, d)
    mask = prefill_mask(sq, sk, causal, sliding_window, q.device)
    outs = []
    for lo in range(0, sq, block_q):
        hi = min(lo + block_q, sq)
        s = _grouped_scores(qg[:, lo:hi], k, scale)
        m4 = mask[lo:hi]
        if phi is not None:
            e = torch.where(m4, torch.exp(s - phi), torch.zeros_like(s))
        else:
            m = s.masked_fill(~m4, float("-inf")).amax(dim=-1, keepdim=True)
            e = torch.where(m4, torch.exp(s - m), torch.zeros_like(s))
        den = e.sum(dim=-1)                                  # (B,HK,G,Q)
        num = torch.einsum("bhgqk,bkhd->bqhgd", e, v.float())
        den_q = den.permute(0, 3, 1, 2)[..., None]           # (B,Q,HK,G,1)
        outs.append((num / den_q).reshape(b, hi - lo, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _decode_scores(q, k_cache, scale):
    """q (B, HQ, D), k (B, S, HK, D) -> f32 (B, HK, G, S)."""
    b, hq, d = q.shape
    hk = k_cache.shape[2]
    qg = q.reshape(b, hk, hq // hk, d).float()
    return torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale


def attention_decode_ref(q, k_cache, v_cache, lengths, *,
                         scale: float | None = None) -> torch.Tensor:
    """One-new-token attention against a KV cache (max-stabilized).

    q: (B, HQ, D); k_cache/v_cache: (B, S, HK, D); lengths: (B,)."""
    b, hq, d = q.shape
    s_max = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = _decode_scores(q, k_cache, scale)
    valid = (torch.arange(s_max, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    s = s.masked_fill(~valid, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1)
    num = torch.einsum("bhgk,bkhd->bhgd", e, v_cache.float())
    return (num / den[..., None]).reshape(b, hq, d).to(q.dtype)


def attention_decode_unified_max_ref(q, k_cache, v_cache, lengths, *,
                                     phi: float,
                                     scale: float | None = None):
    """T1 oracle: returns ``(out, stat)`` with ``stat (B,)`` the max
    |s − φ| over valid positions (the two-sided overflow statistic)."""
    b, hq, d = q.shape
    s_max = k_cache.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s = _decode_scores(q, k_cache, scale)
    valid = (torch.arange(s_max, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    centered = s - phi
    e = torch.where(valid, torch.exp(centered), torch.zeros_like(centered))
    num = torch.einsum("bhgk,bkhd->bhgd", e, v_cache.float())
    den = e.sum(dim=-1)
    stat = torch.where(valid, centered.abs(),
                       torch.zeros_like(centered)).amax(dim=(1, 2, 3))
    out = (num / den[..., None]).reshape(b, hq, d).to(q.dtype)
    return out, stat


def _chunk_attention(q, k_cache, v_cache, lengths, phi, scale):
    """Chunk attention math: (out, stat) with stat the per-batch max
    |s − φ| over valid positions, or zeros when ``phi`` is None."""
    b, c, hq, d = q.shape
    s_max, hk = k_cache.shape[1], k_cache.shape[2]
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    s = _grouped_scores(q.reshape(b, c, hk, g, d), k_cache, scale)
    lengths = lengths.to(q.device)
    qpos = lengths[:, None] + torch.arange(c, device=q.device)[None, :]
    valid = (torch.arange(s_max, device=q.device)[None, None, None, None, :]
             <= qpos[:, None, None, :, None])                # (B,1,1,C,S)
    if phi is not None:
        centered = s - phi
        e = torch.where(valid, torch.exp(centered), torch.zeros_like(s))
        stat = torch.where(valid, centered.abs(),
                           torch.zeros_like(s)).amax(dim=(1, 2, 3, 4))
    else:
        m = s.masked_fill(~valid, float("-inf")).amax(dim=-1, keepdim=True)
        e = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
        stat = torch.zeros((b,), dtype=torch.float32, device=q.device)
    den = e.sum(dim=-1)                                      # (B,HK,G,C)
    num = torch.einsum("bhgck,bkhd->bchgd", e, v_cache.float())
    den_q = den.permute(0, 3, 1, 2)[..., None]               # (B,C,HK,G,1)
    o = (num / den_q).reshape(b, c, hq, d)
    return o.to(q.dtype), stat


def attention_chunk_ref(q, k_cache, v_cache, lengths, *,
                        phi: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention: query i of row b sits at absolute
    position ``lengths[b] + i`` and sees cache positions ``<=`` it (the
    chunk's own KV must already be in the cache). ``phi`` picks the T1
    scheme; None is the safe per-row max."""
    out, _ = _chunk_attention(q, k_cache, v_cache, lengths, phi, scale)
    return out


def attention_chunk_unified_max_ref(q, k_cache, v_cache, lengths, *,
                                    phi: float,
                                    scale: float | None = None):
    """T1 chunk-attention oracle returning ``(out, stat)``."""
    return _chunk_attention(q, k_cache, v_cache, lengths, phi, scale)


# ---------------------------------------------------------------------------
# GEMM oracles
# ---------------------------------------------------------------------------


def flat_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), result in x.dtype — the library GEMM (ImplC).
    cuBLAS and the CPU BLAS both accumulate bf16 products in f32."""
    return torch.matmul(x, w.to(x.dtype))


def gemv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same math as :func:`flat_gemm_ref`; kept separate as the ImplA
    oracle."""
    return flat_gemm_ref(x, w)


# ---------------------------------------------------------------------------
# Norm / rope oracles (expression copies of models.layers)
# ---------------------------------------------------------------------------


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope_ref(x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.to(x.device)[..., None].float() * freq
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
