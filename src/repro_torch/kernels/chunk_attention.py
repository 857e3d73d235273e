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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, merge
from repro_torch.kernels.decode_attention import check_paged_inputs

KERNEL_BLOCK_Q = 32      # query rows per CUDA block (csrc kBQ)

# B, C, HQ, HK, NB, PS, NP, D, qsb, qss, qsh, sp, ss, sh, scale
_DIMS = [_build.I32] * 8 + [_build.I64] * 6 + [_build.F32]
_SIG = {
    "paged_chunk_attention_unified_max_bf16":
        [_build.VP] * 7 + _DIMS + [_build.F32, _build.VP],
    "paged_chunk_attention_sync_bf16": [_build.VP] * 7 + _DIMS + [_build.VP],
}


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


def _pages(q, k_pool, v_pool, block_tables, lengths, scale):
    """Yield per-page (scores (B,HK,CG,PS) f32, v (B,HK,PS,D), valid) with
    the in-chunk causal mask of the TPU kernel's ``_chunk_mask``."""
    b, c, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    qg, g = _regroup_q(q.float() * scale, hk)
    bt = block_tables.to(q.device).long().clamp(0, num_pages - 1)
    rows = torch.arange(c * g, device=q.device) // g
    q_pos = lengths.to(q.device).long()[:, None] + rows[None, :]   # (B, CG)
    for i in range(bt.shape[1]):
        kt = k_pool[bt[:, i]].float().permute(0, 2, 1, 3)   # (B,HK,PS,D)
        s = torch.matmul(qg, kt.transpose(-1, -2))           # (B,HK,CG,PS)
        k_pos = i * ps + torch.arange(ps, device=q.device)
        valid = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        yield s, v_pool[bt[:, i]].permute(0, 2, 1, 3), valid.expand_as(s)


def paged_chunk_attention_unified_max_plain(q, k_pool, v_pool, block_tables,
                                            lengths, *, phi: float = 0.0,
                                            scale: float | None = None):
    """Plain version: ``(out (B,C,HQ,D), stat (B,HK))``."""
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, c * hq // hk, d), device=q.device)
    den = torch.zeros((b, hk, c * hq // hk, 1), device=q.device)
    msc = torch.full((b, hk), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale):
        acc, den, msc = merge.unified_accumulate(acc, den, msc, s - phi, v,
                                                 valid)
    out = merge.finalize(acc, den, guard_zero=True)
    return _ungroup_out(out, c, hq // hk).to(q.dtype), msc


def paged_chunk_attention_sync_plain(q, k_pool, v_pool, block_tables,
                                     lengths, *, scale: float | None = None):
    """Plain version of the online-max scheme: ``out (B, C, HQ, D)``."""
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, c * hq // hk, d), device=q.device)
    den = torch.zeros((b, hk, c * hq // hk, 1), device=q.device)
    m = torch.full((b, hk, c * hq // hk, 1), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale):
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
                                      scale: float | None = None):
    """T1 fused chunk attention over the pool: ``(out, stat (B, HK))``."""
    if not q.is_cuda:
        return paged_chunk_attention_unified_max_plain(
            q, k_pool, v_pool, block_tables, lengths, phi=phi, scale=scale)
    bt, lens = check_paged_inputs("paged chunk attention", q, k_pool,
                                  v_pool, block_tables, lengths)
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, hq, -(-c // KERNEL_BLOCK_Q)), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("chunk_attention", _SIG)
    entry = "paged_chunk_attention_unified_max_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(bt),
        _build.ptr(lens), _build.ptr(out), _build.ptr(part),
        *_dims(q, k_pool, bt), scale, phi, _build.stream_of(q))
    _build.check(lib, entry, code)
    paged_chunk_attention_unified_max.launches += 1
    return out, part.amax(dim=-1).reshape(b, hk, hq // hk).amax(dim=-1)


def paged_chunk_attention_sync(q, k_pool, v_pool, block_tables, lengths, *,
                               scale: float | None = None,
                               out: torch.Tensor | None = None,
                               flag: torch.Tensor | None = None):
    """Online-max fused chunk attention. With ``out`` and a one-element
    bool ``flag`` this is the overflow recompute: ``out`` is overwritten
    only where ``flag`` is set (read by the kernel at entry on the
    card)."""
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = paged_chunk_attention_sync_plain(
            q, k_pool, v_pool, block_tables, lengths, scale=scale)
        return res if out is None else torch.where(flag, res, out)
    bt, lens = check_paged_inputs("paged chunk attention", q, k_pool,
                                  v_pool, block_tables, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("paged_chunk_attention_sync: out must be a "
                         "contiguous (B, C, HQ, D) tensor of q's dtype")
    lib = _build.load("chunk_attention", _SIG)
    entry = "paged_chunk_attention_sync_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(bt),
        _build.ptr(lens), _build.ptr(out),
        _build.ptr(flag) if flag is not None else None,
        *_dims(q, k_pool, bt), scale, _build.stream_of(q))
    _build.check(lib, entry, code)
    paged_chunk_attention_sync.launches += 1
    return out


paged_chunk_attention_unified_max.launches = 0
paged_chunk_attention_sync.launches = 0
