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
in the JAX kernel, so the overflow decision agrees with it.

The CUDA path is two launches, counted as one call: a split kernel on the
grid ``(ceil(C / 64), HQ, B * NSPLIT)`` (``KERNEL_BLOCK_Q`` = 64 query rows
of one head per block, walking 64-key tiles on the tensor cores over one
split of ``SPLIT_KEYS`` = 256 absolute key positions, ``NSPLIT =
ceil(NB * PS / 256)`` from the table's width), and a combine kernel that
folds each row's own splits in ascending order. The split kernel writes
f32 partials into scratch this wrapper allocates with ``torch.empty``:
``acc (B * NSPLIT, C, HQ, D)``, ``den (B * NSPLIT, C, HQ)`` and, for the
online-max scheme, the running max beside them (unified-max: the
per-(q tile, head, split) max of ``s − φ`` instead). The combine writes
``out`` and, unified, ``stat``: the max over tiles, splits and each kv
head's G query heads, with no reduction left to the host.
:func:`paged_chunk_attention_split_plain` is the CPU counterpart of that
split and combine.

``chunk_lens`` (optional, ``(B,)``) bounds each sequence's valid keys at
``lengths[b] + chunk_lens[b]``: the kernels never read a pool row from
there on (a ragged chunk leaves those rows stale or unwritten), so no
such row reaches a valid row's output. It changes only rows past
``chunk_lens``, which the caller drops, and their share of ``stat``; the
plain versions, which the wrappers run on CPU tensors, read every row to
C as the JAX kernel does.

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
from repro_torch.kernels.flash_prefill import check_aligned_rows

KERNEL_BLOCK_Q = 64      # query rows per CUDA block (attn_tile.cuh kBQ)
SPLIT_KEYS = 256         # absolute key positions per split (csrc kSplit)

# B, C, HQ, HK, NB, PS, NP, D, NSPLIT, qsb, qss, qsh, sp, ss, sh, scale
_DIMS = [_build.I32] * 9 + [_build.I64] * 6 + [_build.F32]
# q, k, v, bt, lengths, chunk_lens, out, stat / flag, acc, den, aux
_PTRS = [_build.VP] * 11
_SIG = {
    "paged_chunk_attention_unified_max_bf16":
        _PTRS + _DIMS + [_build.F32, _build.VP],
    "paged_chunk_attention_sync_bf16": _PTRS + _DIMS + [_build.VP],
    # + k_step, v_step pointers and the code-type flag (1 = fp8)
    "paged_chunk_attention_unified_max_q8":
        _PTRS + [_build.VP] * 2 + _DIMS + [_build.F32, _build.I32,
                                           _build.VP],
    "paged_chunk_attention_sync_q8":
        _PTRS + [_build.VP] * 2 + _DIMS + [_build.I32, _build.VP],
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


def paged_chunk_attention_split_plain(q, k_pool, v_pool, block_tables,
                                     lengths, *, unified_max: bool = True,
                                     phi: float = 0.0,
                                     scale: float | None = None,
                                     k_scale=None, v_scale=None,
                                     chunk_lens=None):
    """The CUDA path's split and combine, emulated: the keys cut at the
    absolute multiples of ``SPLIT_KEYS``, one partial per split through
    :mod:`merge`'s accumulate steps, the partials folded in ascending
    order with :func:`merge.merge_unified` or the guarded
    :func:`merge.merge_lse`, then ``finalize(guard_zero=True)``. Keys at
    or past ``lengths + chunk_lens`` are masked for every row and read as
    zeros, as the kernel zero-fills them instead of reading the pool.
    Returns ``(out, stat (B, HK))`` for the unified-max scheme, ``out``
    for the online-max one."""
    b, c, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    nb = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    qg, g = _regroup_q(q.float() * scale, hk)                 # (B,HK,CG,D)
    bt = block_tables.to(q.device).long().clamp(0, num_pages - 1)
    len0 = lengths.to(q.device).long().clamp_min(0)
    cl = (torch.full_like(len0, c) if chunk_lens is None else
          chunk_lens.to(q.device).long().clamp(0, c))
    kend = (len0 + cl).clamp(max=nb * ps)                      # (B,)
    read = (torch.arange(nb * ps, device=q.device)[None, :]
            < kend[:, None])[:, None, :, None]             # (B,1,NB*PS,1)
    keys = [torch.where(read, torch.cat(
        [page_values(pool, bt[:, i], st) for i in range(nb)],
        dim=1).float().permute(0, 2, 1, 3), 0.0)         # (B,HK,NB*PS,D)
        for pool, st in ((k_pool, k_scale), (v_pool, v_scale))]
    q_pos = len0[:, None] + torch.arange(c * g, device=q.device) // g
    part = None
    for k0 in range(0, nb * ps, SPLIT_KEYS):
        k1 = min(k0 + SPLIT_KEYS, nb * ps)
        key = torch.arange(k0, k1, device=q.device)
        s = torch.matmul(qg, keys[0][:, :, k0:k1].transpose(-1, -2))
        valid = ((key[None, None, :] <= q_pos[:, :, None])
                 & (key[None, None, :] < kend[:, None, None]))[:, None]
        valid = valid.expand_as(s)
        v = keys[1][:, :, k0:k1]
        acc = torch.zeros(qg.shape, device=q.device)
        den = torch.zeros(qg.shape[:-1] + (1,), device=q.device)
        if unified_max:
            msc = torch.full((b, hk), float("-inf"), device=q.device)
            p = merge.unified_accumulate(acc, den, msc, s - phi, v, valid)
            part = p if part is None else merge.merge_unified(part, p)
        else:
            m = torch.full_like(den, float("-inf"))
            s = torch.where(valid, s, torch.full_like(s, float("-inf")))
            p = merge.sync_accumulate(acc, den, m, s, v, valid=valid)
            part = p if part is None else merge.merge_lse(part, p)
    out = _ungroup_out(merge.finalize(part[0], part[1], guard_zero=True), c,
                       g).to(q.dtype)
    return (out, part[2]) if unified_max else out


def _dims(q, k_pool, bt, nsplit):
    b, c, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    return [b, c, hq, hk, bt.shape[1], ps, num_pages, d, nsplit,
            *q.stride()[:3], *k_pool.stride()[:3]]


def _launch_operands(q, k_pool, v_pool, block_tables, lengths, chunk_lens,
                     k_scale, v_scale, unified):
    """Check the operands of a CUDA launch; returns the contiguous int32
    (tables, lengths, chunk_lens or None), NSPLIT and the f32 scratch
    (acc, den, aux) of the split kernel."""
    bt, lens = check_paged_inputs("paged chunk attention", q, k_pool,
                                  v_pool, block_tables, lengths, k_scale,
                                  v_scale)
    check_aligned_rows("paged chunk attention", q)
    b, c, hq, d = q.shape
    cl = None
    if chunk_lens is not None:
        if chunk_lens.shape != (b,):
            raise ValueError(f"paged chunk attention: chunk_lens must be "
                             f"({b},), got {tuple(chunk_lens.shape)}")
        cl = chunk_lens.to(device=q.device, dtype=torch.int32).contiguous()
    nsplit = -(-bt.shape[1] * k_pool.shape[1] // SPLIT_KEYS)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b * nsplit, c, hq, d), **f32)
    den = torch.empty((b * nsplit, c, hq), **f32)
    aux = torch.empty((b, hq, -(-c // KERNEL_BLOCK_Q), nsplit) if unified
                      else (b * nsplit, c, hq), **f32)
    return bt, lens, cl, nsplit, (acc, den, aux)


@_build.forward_only
def paged_chunk_attention_unified_max(q, k_pool, v_pool, block_tables,
                                      lengths, *, phi: float = 0.0,
                                      scale: float | None = None,
                                      k_scale=None, v_scale=None,
                                      chunk_lens=None):
    """T1 fused chunk attention over the pool: ``(out, stat (B, HK))``.
    With ``k_scale`` / ``v_scale`` the pools hold codes; ``chunk_lens``
    bounds the keys the kernel reads (module docstring)."""
    if not q.is_cuda:
        return paged_chunk_attention_unified_max_plain(
            q, k_pool, v_pool, block_tables, lengths, phi=phi, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    bt, lens, cl, nsplit, scratch = _launch_operands(
        q, k_pool, v_pool, block_tables, lengths, chunk_lens, k_scale,
        v_scale, True)
    fp8 = code_flag(k_pool, k_scale)
    b, c, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=q.device)
    stat = torch.empty((b, hk), dtype=torch.float32, device=q.device)
    lib = _build.load("chunk_attention", _SIG)
    args = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(bt), _build.ptr(lens),
            _build.ptr(cl) if cl is not None else None, _build.ptr(out),
            _build.ptr(stat), *map(_build.ptr, scratch),
            *_dims(q, k_pool, bt, nsplit), scale, phi)
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
    return out, stat


@_build.forward_only
def paged_chunk_attention_sync(q, k_pool, v_pool, block_tables, lengths, *,
                               scale: float | None = None,
                               out: torch.Tensor | None = None,
                               flag: torch.Tensor | None = None,
                               k_scale=None, v_scale=None, chunk_lens=None):
    """Online-max fused chunk attention. With ``out`` and a one-element
    bool ``flag`` this is the overflow recompute: ``out`` is overwritten
    only where ``flag`` is set (read by both kernels at entry on the
    card). With ``k_scale`` / ``v_scale`` the pools hold codes;
    ``chunk_lens`` bounds the keys the kernel reads."""
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = paged_chunk_attention_sync_plain(
            q, k_pool, v_pool, block_tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
        return res if out is None else torch.where(flag, res, out)
    bt, lens, cl, nsplit, scratch = _launch_operands(
        q, k_pool, v_pool, block_tables, lengths, chunk_lens, k_scale,
        v_scale, False)
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
    rest = (_build.ptr(bt), _build.ptr(lens),
            _build.ptr(cl) if cl is not None else None, _build.ptr(out),
            _build.ptr(flag) if flag is not None else None,
            *map(_build.ptr, scratch), *_dims(q, k_pool, bt, nsplit), scale)
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
