"""T1 — GQA decode attention over the dense KV cache
(kernel: ``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_unified_max``
and ``::decode_attention_sync``. Inputs keep the JAX kernels' layout —
q ``(B, HQ, D)``, caches ``(B, HK, S, D)``, lengths ``(B,)`` — but the
caches may be any strided view whose head_dim is contiguous: the model
passes ``cache.transpose(1, 2)`` of its ``(B, S, HK, D)`` slot cache and
the kernel reads it in place, where the reference transposes (and, in
eager PyTorch, would copy) the whole cache per layer per tick.

On a CUDA tensor each wrapper launches its kernel (grid (B, HK), one
block per sequence and kv head; see the source's header); on a CPU
tensor it runs the plain version, which walks the cache in ``block_k``
tiles through :mod:`repro_torch.kernels.merge` exactly like the TPU
kernel's grid. ``block_k`` only shapes that emulation: the CUDA kernel
walks 32-key warp chunks and its result does not depend on it. Each
wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, merge

DEFAULT_BLOCK_K = 512

_COMMON = [_build.VP] * 4                     # q, k, v, lengths
_DIMS = [_build.I32] * 5 + [_build.I64] * 3   # B, HK, G, S, D, sb, ss, sh
_SIG = {
    "decode_attention_unified_max_bf16":
        _COMMON + [_build.VP, _build.VP] + _DIMS
        + [_build.F32, _build.F32, _build.VP],
    "decode_attention_sync_bf16":
        _COMMON + [_build.VP, _build.VP] + _DIMS + [_build.F32, _build.VP],
}


def _blocks(q, k_cache, v_cache, lengths, scale, block_k):
    """Yield per-tile (scores (B,HK,G,BK) f32, v (B,HK,BK,D), valid)."""
    b, hq, d = q.shape
    hk, s_max = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hk, hq // hk, d).float() * scale
    lengths = lengths.to(q.device)
    for lo in range(0, s_max, block_k):
        hi = min(lo + block_k, s_max)
        kt = k_cache[:, :, lo:hi].float()
        s = torch.matmul(qg, kt.transpose(-1, -2))        # (B,HK,G,BK)
        offs = torch.arange(lo, hi, device=q.device)
        valid = (offs[None, :] < lengths[:, None])[:, None, None, :]
        yield s, v_cache[:, :, lo:hi], valid.expand_as(s)


def decode_attention_unified_max_plain(q, k_cache, v_cache, lengths, *,
                                       phi: float = 0.0,
                                       scale: float | None = None,
                                       block_k: int = DEFAULT_BLOCK_K):
    """Plain version: ``(out (B,HQ,D), stat (B,HK) = max(s − φ))``."""
    b, hq, d = q.shape
    hk = k_cache.shape[1]
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, hk, g, 1), dtype=torch.float32, device=q.device)
    msc = torch.full((b, hk), float("-inf"), device=q.device)
    for s, v, valid in _blocks(q, k_cache, v_cache, lengths, scale,
                               block_k):
        acc, den, msc = merge.unified_accumulate(acc, den, msc, s - phi, v,
                                                 valid)
    out = merge.finalize(acc, den, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype), msc


def decode_attention_sync_plain(q, k_cache, v_cache, lengths, *,
                                scale: float | None = None,
                                block_k: int = DEFAULT_BLOCK_K):
    """Plain version of the online-max scheme: ``out (B, HQ, D)``."""
    b, hq, d = q.shape
    hk = k_cache.shape[1]
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, hk, g, 1), dtype=torch.float32, device=q.device)
    m = torch.full((b, hk, g, 1), float("-inf"), device=q.device)
    for s, v, valid in _blocks(q, k_cache, v_cache, lengths, scale,
                               block_k):
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
        acc, den, m = merge.sync_accumulate(acc, den, m, s, v)
    out = merge.finalize(acc, den, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype)


def _check_inputs(q, k_cache, v_cache, lengths):
    b, hq, d = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d or hq % k_cache.shape[1]:
        raise ValueError(f"decode attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    for t in (q, k_cache, v_cache):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode attention kernel takes bf16, got "
                            f"{t.dtype}")
        if t.device != q.device:
            raise ValueError("decode attention inputs on different devices")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1:
        raise ValueError("decode attention kernel needs k and v with equal "
                         "strides and a contiguous head_dim")
    if any(s % 8 for s in k_cache.stride()[:3]) \
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode attention kernel needs 16-byte aligned "
                         "cache rows")
    if d not in (32, 64, 128):
        raise ValueError(f"decode attention kernel takes head_dim 32/64/128, "
                         f"got {d}")
    return (q.contiguous(), lengths.to(device=q.device,
                                       dtype=torch.int32).contiguous())


def _dims(q, k_cache):
    b, hq, d = q.shape
    hk, s_max = k_cache.shape[1], k_cache.shape[2]
    sb, sh, ss, _ = k_cache.stride()
    return [b, hk, hq // hk, s_max, d, sb, ss, sh]


def decode_attention_unified_max(q, k_cache, v_cache, lengths, *,
                                 phi: float = 0.0,
                                 scale: float | None = None,
                                 block_k: int = DEFAULT_BLOCK_K):
    """T1 decode attention. Returns ``(out (B,HQ,D), stat (B,HK))`` with
    ``stat`` the max of ``s − φ`` over valid positions (the overflow
    statistic the recompute fallback tests). ``block_k`` shapes only the
    plain version on CPU tensors; the kernel does not take it."""
    if not q.is_cuda:
        return decode_attention_unified_max_plain(
            q, k_cache, v_cache, lengths, phi=phi, scale=scale,
            block_k=block_k)
    q, lens = _check_inputs(q, k_cache, v_cache, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    stat = torch.empty((q.shape[0], k_cache.shape[1]), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("decode_attention", _SIG)
    entry = "decode_attention_unified_max_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(lens), _build.ptr(out), _build.ptr(stat),
        *_dims(q, k_cache), scale, phi, _build.stream_of(q))
    _build.check(lib, entry, code)
    decode_attention_unified_max.launches += 1
    return out, stat


def decode_attention_sync(q, k_cache, v_cache, lengths, *,
                          scale: float | None = None,
                          block_k: int = DEFAULT_BLOCK_K,
                          out: torch.Tensor | None = None,
                          flag: torch.Tensor | None = None):
    """Online-max decode attention — the overflow recompute and the
    paper's synchronized baseline.

    With ``out`` and a one-element bool ``flag`` tensor this is the
    recompute: the result replaces ``out`` where ``flag`` is set and
    ``out`` is returned untouched otherwise. On the card the kernel reads
    the flag at entry, so the decision never leaves the device.
    ``block_k`` shapes only the plain version on CPU tensors.
    """
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = decode_attention_sync_plain(q, k_cache, v_cache, lengths,
                                          scale=scale, block_k=block_k)
        return res if out is None else torch.where(flag, res, out)
    q, lens = _check_inputs(q, k_cache, v_cache, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("decode_attention_sync: out must be a contiguous "
                         "(B, HQ, D) tensor of q's dtype")
    lib = _build.load("decode_attention", _SIG)
    entry = "decode_attention_sync_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(lens), _build.ptr(out),
        _build.ptr(flag) if flag is not None else None,
        *_dims(q, k_cache), scale, _build.stream_of(q))
    _build.check(lib, entry, code)
    decode_attention_sync.launches += 1
    return out


decode_attention_unified_max.launches = 0
decode_attention_sync.launches = 0
