"""Causal / sliding-window flash attention for prefill
(kernel: ``csrc/flash_prefill.cu``).

Replaces ``repro/kernels/flash_prefill.py::flash_prefill`` in both
softmax schemes. Layouts as in the JAX package: q ``(B, Sq, HQ, D)``,
k/v ``(B, Sk, HK, D)`` (any strides with a contiguous head_dim), GQA by
``kv_head = h // G``; out ``(B, Sq, HQ, D)``.

One deliberate difference from the TPU kernel: ``stat`` is the max
centered logit over *every* query row. The TPU kernel keeps only the
last query tile's (its stat block is shared across query tiles and
reset per tile), so an overflow in an earlier tile never triggered the
recompute. Here each CUDA block writes its tile's max into a
``(B, HQ, n_q_tiles)`` buffer and the wrapper takes one ``amax``.

On a CPU tensor the wrappers run the plain versions, which loop over
``block_q`` x ``block_k`` tiles through :mod:`repro_torch.kernels.merge`
like the TPU kernel's grid (ragged edges masked, not asserted). Each
wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, merge
from repro_torch.kernels.ref import prefill_mask

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
KERNEL_BLOCK_Q = 32      # query rows per CUDA block (csrc kBQ)

_NEG_INF = -1e30         # sync-scheme mask value, as in the reference

_DIMS = [_build.I32] * 6 + [_build.I64] * 9 + [_build.I32, _build.I32,
                                               _build.F32]
_SIG = {
    "flash_prefill_unified_max_bf16":
        [_build.VP] * 5 + _DIMS + [_build.F32, _build.VP],
    "flash_prefill_sync_bf16": [_build.VP] * 5 + _DIMS + [_build.VP],
}


def _tiles(q, k, v, scale, causal, window, block_q, block_k):
    """Yield (q-tile bounds, per-k-tile (scores, v, valid) iterator)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    qh = (q.float() * scale).permute(0, 2, 1, 3)                # (B,HQ,Sq,D)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)      # (B,HQ,Sk,D)
    mask = prefill_mask(sq, sk, causal, window, q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)

        def pieces(q0=q0, q1=q1):
            for k0 in range(0, sk, block_k):
                k1 = min(k0 + block_k, sk)
                s = torch.matmul(qh[:, :, q0:q1], kh[:, :, k0:k1]
                                 .transpose(-1, -2))            # (B,HQ,BQ,BK)
                valid = mask[q0:q1, k0:k1].expand_as(s)
                yield s, vh[:, :, k0:k1], valid
        yield q0, q1, pieces()


def flash_prefill_unified_max_plain(q, k, v, *, causal=True, phi=0.0,
                                    scale=None, sliding_window=0,
                                    block_q=DEFAULT_BLOCK_Q,
                                    block_k=DEFAULT_BLOCK_K):
    """Plain version: ``(out, stat (B, HQ))``, stat over all query rows."""
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    stat = torch.full((b, hq), float("-inf"), device=q.device)
    for q0, q1, pieces in _tiles(q, k, v, scale, causal, sliding_window,
                                 block_q, block_k):
        acc = torch.zeros((b, hq, q1 - q0, d), device=q.device)
        den = torch.zeros((b, hq, q1 - q0, 1), device=q.device)
        msc = torch.full((b, hq), float("-inf"), device=q.device)
        for s, vt, valid in pieces:
            acc, den, msc = merge.unified_accumulate(acc, den, msc, s - phi,
                                                     vt, valid)
        out[:, :, q0:q1] = merge.finalize(acc, den, guard_zero=True).to(
            q.dtype)
        stat = torch.maximum(stat, msc)
    return out.permute(0, 2, 1, 3), stat


def flash_prefill_sync_plain(q, k, v, *, causal=True, scale=None,
                             sliding_window=0, block_q=DEFAULT_BLOCK_Q,
                             block_k=DEFAULT_BLOCK_K):
    """Plain version of the online-max scheme: ``out (B, Sq, HQ, D)``."""
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    for q0, q1, pieces in _tiles(q, k, v, scale, causal, sliding_window,
                                 block_q, block_k):
        acc = torch.zeros((b, hq, q1 - q0, d), device=q.device)
        den = torch.zeros((b, hq, q1 - q0, 1), device=q.device)
        m = torch.full((b, hq, q1 - q0, 1), _NEG_INF, device=q.device)
        for s, vt, valid in pieces:
            s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
            acc, den, m = merge.sync_accumulate(acc, den, m, s, vt,
                                                valid=valid)
        out[:, :, q0:q1] = merge.finalize(acc, den, guard_zero=True).to(
            q.dtype)
    return out.permute(0, 2, 1, 3)


def _check_inputs(q, k, v):
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or hq % k.shape[2]:
        raise ValueError(f"flash_prefill shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_prefill kernel takes bf16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("flash_prefill inputs on different devices")
        if t.stride(3) != 1:
            raise ValueError("flash_prefill kernel needs a contiguous "
                             "head_dim")
    if d not in (32, 64, 128):
        raise ValueError(f"flash_prefill kernel takes head_dim 32/64/128, "
                         f"got {d}")


def _dims(q, k, v, causal, window):
    b, sq, hq, d = q.shape
    return [b, sq, k.shape[1], hq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window)]


def flash_prefill_unified_max(q, k, v, *, causal=True, phi=0.0, scale=None,
                              sliding_window=0, block_q=DEFAULT_BLOCK_Q,
                              block_k=DEFAULT_BLOCK_K):
    """T1 prefill attention: ``(out, stat (B, HQ))``. ``block_q``/
    ``block_k`` shape only the CPU emulation."""
    if not q.is_cuda:
        return flash_prefill_unified_max_plain(
            q, k, v, causal=causal, phi=phi, scale=scale,
            sliding_window=sliding_window, block_q=block_q, block_k=block_k)
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    n_qt = -(-sq // KERNEL_BLOCK_Q)
    part = torch.empty((b, hq, n_qt), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_prefill", _SIG)
    entry = "flash_prefill_unified_max_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(part), *_dims(q, k, v, causal, sliding_window), scale,
        phi, _build.stream_of(q))
    _build.check(lib, entry, code)
    flash_prefill_unified_max.launches += 1
    return out, part.amax(dim=-1)


def flash_prefill_sync(q, k, v, *, causal=True, scale=None,
                       sliding_window=0, block_q=DEFAULT_BLOCK_Q,
                       block_k=DEFAULT_BLOCK_K,
                       out: torch.Tensor | None = None,
                       flag: torch.Tensor | None = None):
    """Online-max prefill attention. With ``out`` and a one-element bool
    ``flag`` this is the overflow recompute: ``out`` is overwritten only
    where ``flag`` is set (read by the kernel at entry on the card)."""
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = flash_prefill_sync_plain(
            q, k, v, causal=causal, scale=scale,
            sliding_window=sliding_window, block_q=block_q, block_k=block_k)
        return res if out is None else torch.where(flag, res, out)
    _check_inputs(q, k, v)
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if out is None:
        out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("flash_prefill_sync: out must be a contiguous "
                         "(B, Sq, HQ, D) tensor of q's dtype")
    lib = _build.load("flash_prefill", _SIG)
    entry = "flash_prefill_sync_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(flag) if flag is not None else None,
        *_dims(q, k, v, causal, sliding_window), scale, _build.stream_of(q))
    _build.check(lib, entry, code)
    flash_prefill_sync.launches += 1
    return out


def flash_prefill(q, k, v, *, causal=True, unified_max=True, phi=0.0,
                  scale=None, sliding_window=0, block_q=DEFAULT_BLOCK_Q,
                  block_k=DEFAULT_BLOCK_K):
    """The reference's single entry: ``out`` (sync) or ``(out, stat)``
    (unified-max)."""
    if unified_max:
        return flash_prefill_unified_max(
            q, k, v, causal=causal, phi=phi, scale=scale,
            sliding_window=sliding_window, block_q=block_q, block_k=block_k)
    return flash_prefill_sync(q, k, v, causal=causal, scale=scale,
                              sliding_window=sliding_window,
                              block_q=block_q, block_k=block_k)


flash_prefill_unified_max.launches = 0
flash_prefill_sync.launches = 0
