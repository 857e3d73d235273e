"""Fused paged chunk-prefill attention (kernel: ``csrc/chunk_attention.cu``).

Replaces ``repro/kernels/chunk_attention.py::paged_chunk_attention_unified_max``
and ``::paged_chunk_attention_sync``: a ``(B, C)`` query chunk attends
causally to its sequences' KV read in place from the block pool — no
dense ``(B, NB*PS)`` view is materialized. Layouts as in the JAX
package: q ``(B, C, HQ, D)``, pools ``(NP, PS, HK, D)``, block tables
``(B, NB)`` int32 (unassigned entries hold the sentinel ``NP``; every
entry read is clamped to the pool), ``lengths`` the positions *before*
the chunk; out ``(B, C, HQ, D)``. Query row ``i`` of row ``b`` sits at
absolute position ``lengths[b] + i`` and sees keys at positions ``<=``
it; the chunk's own KV must already be in the pool. Rows past a
sequence's ``chunk_lens`` come out as garbage the caller drops, and rows
with no valid key as zeros.

``stat`` is ``(B, HK)``: the max of ``s − φ`` over every valid entry of
all C·G query rows of a kv head, rows past ``chunk_lens`` included, as
in the JAX kernel, so the overflow decision agrees with it. The CUDA
kernel writes one maximum per (query tile, query head) and the wrapper
takes the amax over tiles and over each kv head's G query heads.

On a CPU tensor the wrappers run the plain versions, which regroup q to
``(B, HK, C·G, D)`` and walk one logical page per step through
:mod:`repro_torch.kernels.merge`, exactly as the TPU kernel's grid does.
Each wrapper counts its kernel launches in ``.launches``.

A quantized pool (int8 / float8_e4m3fn codes with ``k_scale`` /
``v_scale``, the (NP, HK) f32 steps) runs the kernels' quantized bodies,
counted in :data:`paged_chunk_attention_unified_max_quant` /
:data:`paged_chunk_attention_sync_quant`; the plain versions dequantize
each page as they read it (``codes.float() * step``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, merge
from repro_torch.kernels.decode_attention import (check_paged_inputs,
                                                  code_flag, page_values)

KERNEL_BLOCK_Q = 32      # query rows per CUDA block (csrc kBQ)

# B, C, HQ, HK, NB, PS, NP, D, qsb, qss, qsh, sp, ss, sh, scale
_DIMS = [_build.I32] * 8 + [_build.I64] * 6 + [_build.F32]
_SIG = {
    "paged_chunk_attention_unified_max_bf16":
        [_build.VP] * 7 + _DIMS + [_build.F32, _build.VP],
    "paged_chunk_attention_sync_bf16": [_build.VP] * 7 + _DIMS + [_build.VP],
    # + k_step, v_step pointers and the code-type flag (1 = fp8)
    "paged_chunk_attention_unified_max_q8":
        [_build.VP] * 9 + _DIMS + [_build.F32, _build.I32, _build.VP],
    "paged_chunk_attention_sync_q8":
        [_build.VP] * 9 + _DIMS + [_build.I32, _build.VP],
}

# the quantized bodies' launches, apart from the bf16 kernels'
paged_chunk_attention_unified_max_quant = _build.LaunchCounter(
    "paged_chunk_attention_unified_max_quant")
paged_chunk_attention_sync_quant = _build.LaunchCounter(
    "paged_chunk_attention_sync_quant")


def _regroup_q(q: torch.Tensor, hk: int):
    """(B, C, HQ, D) -> (B, HK, C*G, D); row r of a tile is chunk
    position r // G."""
    b, c, hq, d = q.shape
    g = hq // hk
    return (q.reshape(b, c, hk, g, d).permute(0, 2, 1, 3, 4)
             .reshape(b, hk, c * g, d)), g


def _ungroup_out(out: torch.Tensor, c: int, g: int) -> torch.Tensor:
    """(B, HK, C*G, D) -> (B, C, HQ, D)."""
    b, hk, _, d = out.shape
    return (out.reshape(b, hk, c, g, d).permute(0, 2, 1, 3, 4)
               .reshape(b, c, hk * g, d))


def _pages(q, k_pool, v_pool, block_tables, lengths, scale, k_scale=None,
           v_scale=None):
    """Yield per-page (scores (B,HK,CG,PS) f32, v (B,HK,PS,D), valid) with
    the in-chunk causal mask of the TPU kernel's ``_chunk_mask``;
    quantized pages are dequantized as they are read."""
    b, c, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    qg, g = _regroup_q(q.float() * scale, hk)
    bt = block_tables.to(q.device).long().clamp(0, num_pages - 1)
    rows = torch.arange(c * g, device=q.device) // g
    q_pos = lengths.to(q.device).long()[:, None] + rows[None, :]   # (B, CG)
    for i in range(bt.shape[1]):
        kt = page_values(k_pool, bt[:, i], k_scale).float().permute(
            0, 2, 1, 3)                                       # (B,HK,PS,D)
        s = torch.matmul(qg, kt.transpose(-1, -2))           # (B,HK,CG,PS)
        k_pos = i * ps + torch.arange(ps, device=q.device)
        valid = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        yield (s, page_values(v_pool, bt[:, i], v_scale).permute(0, 2, 1, 3),
               valid.expand_as(s))


def paged_chunk_attention_unified_max_plain(q, k_pool, v_pool, block_tables,
                                            lengths, *, phi: float = 0.0,
                                            scale: float | None = None,
                                            k_scale=None, v_scale=None):
    """Plain version: ``(out (B,C,HQ,D), stat (B,HK))``."""
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, c * hq // hk, d), device=q.device)
    den = torch.zeros((b, hk, c * hq // hk, 1), device=q.device)
    msc = torch.full((b, hk), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale, k_scale, v_scale):
        acc, den, msc = merge.unified_accumulate(acc, den, msc, s - phi, v,
                                                 valid)
    out = merge.finalize(acc, den, guard_zero=True)
    return _ungroup_out(out, c, hq // hk).to(q.dtype), msc


def paged_chunk_attention_sync_plain(q, k_pool, v_pool, block_tables,
                                     lengths, *, scale: float | None = None,
                                     k_scale=None, v_scale=None):
    """Plain version of the online-max scheme: ``out (B, C, HQ, D)``."""
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, c * hq // hk, d), device=q.device)
    den = torch.zeros((b, hk, c * hq // hk, 1), device=q.device)
    m = torch.full((b, hk, c * hq // hk, 1), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale, k_scale, v_scale):
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
        acc, den, m = merge.sync_accumulate(acc, den, m, s, v, valid=valid)
    out = merge.finalize(acc, den, guard_zero=True)
    return _ungroup_out(out, c, hq // hk).to(q.dtype)


def _dims(q, k_pool, bt):
    b, c, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    return [b, c, hq, hk, bt.shape[1], ps, num_pages, d,
            *q.stride()[:3], *k_pool.stride()[:3]]


def paged_chunk_attention_unified_max(q, k_pool, v_pool, block_tables,
                                      lengths, *, phi: float = 0.0,
                                      scale: float | None = None,
                                      k_scale=None, v_scale=None):
    """T1 fused chunk attention over the pool: ``(out, stat (B, HK))``.
    With ``k_scale`` / ``v_scale`` the pools hold codes."""
    if not q.is_cuda:
        return paged_chunk_attention_unified_max_plain(
            q, k_pool, v_pool, block_tables, lengths, phi=phi, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    bt, lens = check_paged_inputs("paged chunk attention", q, k_pool,
                                  v_pool, block_tables, lengths, k_scale,
                                  v_scale)
    fp8 = code_flag(k_pool, k_scale)
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, hq, -(-c // KERNEL_BLOCK_Q)), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("chunk_attention", _SIG)
    args = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(bt), _build.ptr(lens), _build.ptr(out),
            _build.ptr(part), *_dims(q, k_pool, bt), scale, phi)
    if fp8 is not None:
        entry = "paged_chunk_attention_unified_max_q8"
        code = getattr(lib, entry)(*args, _build.ptr(k_scale),
                                   _build.ptr(v_scale), *rest, fp8,
                                   _build.stream_of(q))
        counter = paged_chunk_attention_unified_max_quant
    else:
        entry = "paged_chunk_attention_unified_max_bf16"
        code = getattr(lib, entry)(*args, *rest, _build.stream_of(q))
        counter = paged_chunk_attention_unified_max
    _build.check(lib, entry, code)
    counter.launches += 1
    return out, part.amax(dim=-1).reshape(b, hk, hq // hk).amax(dim=-1)


def paged_chunk_attention_sync(q, k_pool, v_pool, block_tables, lengths, *,
                               scale: float | None = None,
                               out: torch.Tensor | None = None,
                               flag: torch.Tensor | None = None,
                               k_scale=None, v_scale=None):
    """Online-max fused chunk attention. With ``out`` and a one-element
    bool ``flag`` this is the overflow recompute: ``out`` is overwritten
    only where ``flag`` is set (read by the kernel at entry on the
    card). With ``k_scale`` / ``v_scale`` the pools hold codes."""
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = paged_chunk_attention_sync_plain(
            q, k_pool, v_pool, block_tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
        return res if out is None else torch.where(flag, res, out)
    bt, lens = check_paged_inputs("paged chunk attention", q, k_pool,
                                  v_pool, block_tables, lengths, k_scale,
                                  v_scale)
    fp8 = code_flag(k_pool, k_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("paged_chunk_attention_sync: out must be a "
                         "contiguous (B, C, HQ, D) tensor of q's dtype")
    lib = _build.load("chunk_attention", _SIG)
    args = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(bt), _build.ptr(lens), _build.ptr(out),
            _build.ptr(flag) if flag is not None else None,
            *_dims(q, k_pool, bt), scale)
    if fp8 is not None:
        entry = "paged_chunk_attention_sync_q8"
        code = getattr(lib, entry)(*args, _build.ptr(k_scale),
                                   _build.ptr(v_scale), *rest, fp8,
                                   _build.stream_of(q))
        counter = paged_chunk_attention_sync_quant
    else:
        entry = "paged_chunk_attention_sync_bf16"
        code = getattr(lib, entry)(*args, *rest, _build.stream_of(q))
        counter = paged_chunk_attention_sync
    _build.check(lib, entry, code)
    counter.launches += 1
    return out


paged_chunk_attention_unified_max.launches = 0
paged_chunk_attention_sync.launches = 0
