"""Plain PyTorch reference math for the main path — the ``"torch"`` plan
backend, and the oracles the kernel tests hold the port to.

Shapes follow the JAX package's conventions:
  * prefill attention:  q,k,v = (batch, seq, heads, head_dim)  (kv heads may differ)
  * decode attention:   q = (batch, q_heads, head_dim),
                        k,v = (batch, kv_len, kv_heads, head_dim)
  * chunk attention:    q = (batch, chunk, q_heads, head_dim), caches as decode
  * paged attention:    pools = (num_pages, page_size, kv_heads, head_dim),
                        block_tables = (batch, pages_per_seq) int32
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
# Paged (block-table) attention oracles
# ---------------------------------------------------------------------------


def dequantize_pool_ref(pool: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """f32 view of a quantized page pool: codes (NP, PS, HK, D) times the
    (NP, HK) f32 steps, the JAX package's oracle expression. It is the
    kernels' per-element dequant too, so gathering before or after it
    gives the same values, and every paged oracle here can take the
    dequantized pool through its existing math."""
    return pool.float() * scales[:, None, :, None]


def gather_paged_kv(pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """The dense per-sequence view of a paged KV pool.

    pool: (NP, PS, HK, D); block_tables: (B, NB) int32. Returns (B, NB*PS,
    HK, D). Unassigned entries hold the sentinel ``NP`` and are clamped to
    a real page, as the JAX package's ``mode="clip"`` take does; whatever
    that page holds is masked off by the caller's lengths."""
    b, nb = block_tables.shape
    idx = block_tables.long().clamp(0, pool.shape[0] - 1).reshape(-1)
    return pool[idx].reshape(b, nb * pool.shape[1], *pool.shape[2:])


def attention_decode_paged_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               scale: float | None = None) -> torch.Tensor:
    """Safe decode attention over a paged cache: the gathered view through
    :func:`attention_decode_ref` — bitwise the dense result whenever
    ``NB * PS`` equals the dense ``max_seq``."""
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    return attention_decode_ref(q, k, v, lengths, scale=scale)


def attention_decode_paged_unified_max_ref(q, k_pool, v_pool, block_tables,
                                           lengths, *, phi: float,
                                           scale: float | None = None):
    """T1 oracle over a paged cache: ``(out, stat (B,))``."""
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    return attention_decode_unified_max_ref(q, k, v, lengths, phi=phi,
                                            scale=scale)


# ---------------------------------------------------------------------------
# Grouped (prefix-shared) decode oracles
# ---------------------------------------------------------------------------


def gather_grouped_kv(pool: torch.Tensor, block_tables: torch.Tensor,
                      groups) -> torch.Tensor:
    """The dense per-sequence KV view reconstructed *through* the group
    plan (``groups``: a :class:`~repro_torch.kernels.group_attention.
    DecodeGroups`). Row b's positions below ``prefix_len[b]`` come from
    its group's table, the rest from its own table: the two stages'
    data sources. A grouped row's table leads with its group's pages, so
    the view is elementwise equal to :func:`gather_paged_kv`, while the
    group operands decide what is read."""
    b, nb = block_tables.shape
    ps = pool.shape[1]
    ng, lp = groups.tables.shape
    width = nb * ps
    tail = gather_paged_kv(pool, block_tables)           # (B, NB*PS, ...)
    gkv = gather_paged_kv(pool, groups.tables)           # (NG, LP*PS, ...)
    if lp * ps < width:
        pad = gkv.new_zeros((ng, width - lp * ps, *gkv.shape[2:]))
        gkv = torch.cat([gkv, pad], dim=1)
    else:
        gkv = gkv[:, :width]
    pref = gkv[groups.gid.long().clamp(0, ng - 1)]
    pos = torch.arange(width, device=pool.device)
    use_pref = (pos[None, :, None, None]
                < groups.prefix_len.to(pool.device)[:, None, None, None])
    return torch.where(use_pref, pref, tail)


def attention_decode_grouped_ref(q, k_pool, v_pool, block_tables, lengths,
                                 groups, *,
                                 scale: float | None = None) -> torch.Tensor:
    """Safe grouped decode oracle: the grouped gather feeds the same
    dense math, so grouped == ungrouped bitwise."""
    k = gather_grouped_kv(k_pool, block_tables, groups)
    v = gather_grouped_kv(v_pool, block_tables, groups)
    return attention_decode_ref(q, k, v, lengths, scale=scale)


def attention_decode_grouped_unified_max_ref(q, k_pool, v_pool, block_tables,
                                             lengths, groups, *, phi: float,
                                             scale: float | None = None):
    """T1 grouped decode oracle: ``(out, stat (B,))``."""
    k = gather_grouped_kv(k_pool, block_tables, groups)
    v = gather_grouped_kv(v_pool, block_tables, groups)
    return attention_decode_unified_max_ref(q, k, v, lengths, phi=phi,
                                            scale=scale)


# ---------------------------------------------------------------------------
# GEMM oracles
# ---------------------------------------------------------------------------


def flat_gemm_ref(x: torch.Tensor, w: torch.Tensor, *,
                  w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """(M, K) @ (K, N), result in x.dtype — the library GEMM (ImplC).
    cuBLAS and the CPU BLAS both accumulate bf16 products in f32.

    ``w_scale`` ((N,) f32 per-output-channel steps, ``models/wquant.py``)
    marks ``w`` as int8 / fp8 codes: the product runs on the codes cast
    to x's dtype (exact: int8 ±127 and every e4m3 value are bf16 values),
    accumulated in f32, the step multiplies the f32 accumulator and the
    result rounds once. ``w_scale=None`` is the unchanged expression (the
    bitwise bf16 path)."""
    if w_scale is None:
        return torch.matmul(x, w.to(x.dtype))
    acc = torch.matmul(x.float(), w.to(x.dtype).float())
    return (acc * w_scale.float()).to(x.dtype)


def gemv_ref(x: torch.Tensor, w: torch.Tensor, *,
             w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Same math as :func:`flat_gemm_ref`; kept separate as the ImplA
    oracle."""
    return flat_gemm_ref(x, w, w_scale=w_scale)


def ffn_activation(g: torch.Tensor, activation: str) -> torch.Tensor:
    """The gated FFN's nonlinearity: silu for swiglu, tanh-approximate
    gelu (``jax.nn.gelu``'s default) for geglu."""
    if activation == "swiglu":
        return torch.nn.functional.silu(g)
    return torch.nn.functional.gelu(g, approximate="tanh")


def fused_ffn_up_ref(x: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, *, activation: str = "swiglu",
                     wg_scale: torch.Tensor | None = None,
                     wu_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Oracle of the fused FFN-up: ``act(x @ w_gate) * (x @ w_up)`` with
    the activation on the unrounded f32 products and one rounding to x's
    dtype at the end. Per-output-channel weight steps (``wg_scale`` /
    ``wu_scale``) apply on the f32 products before the activation."""
    g = torch.matmul(x.float(), w_gate.float())
    if wg_scale is not None:
        g = g * wg_scale.float()
    u = torch.matmul(x.float(), w_up.float())
    if wu_scale is not None:
        u = u * wu_scale.float()
    return (ffn_activation(g, activation) * u).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Decode-fusion stage oracles (expression copies of the split chain)
# ---------------------------------------------------------------------------


def decode_ingest_ref(x, norm_scale, wq, wk, wv, positions, *,
                      num_heads: int, num_kv_heads: int, head_dim: int,
                      rope_theta: float = 1e4, eps: float = 1e-6,
                      use_rope: bool = True, bq=None, bk=None, bv=None,
                      wq_scale=None, wk_scale=None, wv_scale=None):
    """Oracle of the fused decode ingest: rmsnorm → QKV → bias → rope,
    composed of exactly the split chain's expressions in the same order
    (norm, three GEMMs flattened to (B·S, D) and reshaped back, bias
    add, head reshape, rope on q and k), so the fused granularities are
    bitwise split on the ``"torch"`` backend. Weight steps (``w*_scale``)
    apply on the f32 accumulators before the rounding and the bias add.
    x (B, 1, D), positions (B,); returns q (B, 1, HQ, Dh), k / v
    (B, 1, HK, Dh)."""
    b, s, d = x.shape
    h = rmsnorm_ref(x, norm_scale, eps)
    h2 = h.reshape(b * s, d)
    q = flat_gemm_ref(h2, wq, w_scale=wq_scale).reshape(b, s, wq.shape[-1])
    k = flat_gemm_ref(h2, wk, w_scale=wk_scale).reshape(b, s, wk.shape[-1])
    v = flat_gemm_ref(h2, wv, w_scale=wv_scale).reshape(b, s, wv.shape[-1])
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(b, s, num_heads, head_dim)
    k = k.reshape(b, s, num_kv_heads, head_dim)
    v = v.reshape(b, s, num_kv_heads, head_dim)
    if use_rope:
        pos = positions[:, None]
        q = rope_ref(q, pos, rope_theta)
        k = rope_ref(k, pos, rope_theta)
    return q, k, v


def oproj_residual_ref(o, wo, resid, *, w_scale=None):
    """Oracle of the fused attention epilogue ``resid + o @ wo``: the
    split chain's GEMM (flattened, reshaped back) and residual add; the
    weight step (``w_scale``) applies on the f32 accumulator before the
    rounding and the add. o (B, S, Q), wo (Q, D), resid (B, S, D)."""
    b, s, qd = o.shape
    return resid + flat_gemm_ref(o.reshape(b * s, qd), wo,
                                 w_scale=w_scale).reshape(b, s, wo.shape[-1])


def ffn_norm_ref(x, norm_scale, w_gate, w_up, *, activation: str = "swiglu",
                 eps: float = 1e-6, fused: bool = True, wg_scale=None,
                 wu_scale=None):
    """Oracle of the fused MLP ingest: rmsnorm → gate/up → act(g)·u.
    ``fused`` mirrors whichever split chain the plan's ``fused_ffn``
    knob selects: :func:`fused_ffn_up_ref` (activation on the f32
    products) or two GEMMs rounded to the activation dtype before the
    activation. Weight steps (``wg_scale`` / ``wu_scale``) apply where
    those chains apply them. x (B, S, D); returns (B, S, F)."""
    b, s, d = x.shape
    f = w_gate.shape[-1]
    h = rmsnorm_ref(x, norm_scale, eps)
    if fused:
        return fused_ffn_up_ref(h.reshape(b * s, d), w_gate, w_up,
                                activation=activation, wg_scale=wg_scale,
                                wu_scale=wu_scale).reshape(b, s, f)
    g = flat_gemm_ref(h.reshape(b * s, d), w_gate,
                      w_scale=wg_scale).reshape(b, s, f)
    u = flat_gemm_ref(h.reshape(b * s, d), w_up,
                      w_scale=wu_scale).reshape(b, s, f)
    return ffn_activation(g, activation) * u
