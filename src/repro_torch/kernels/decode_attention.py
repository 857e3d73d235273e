"""T1 — GQA decode attention over the dense KV cache or the block-paged
pool (kernels: ``csrc/decode_attention.cu`` on ``csrc/decode_split.cuh``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_unified_max``,
``::decode_attention_sync``, ``::paged_decode_attention_unified_max`` and
``::paged_decode_attention_sync``. Dense inputs keep the JAX kernels' layout —
q ``(B, HQ, D)``, caches ``(B, HK, S, D)``, lengths ``(B,)`` — but the
caches may be any strided view whose head_dim is contiguous: the model
passes ``cache.transpose(1, 2)`` of its ``(B, S, HK, D)`` slot cache and
the kernel reads it in place, where the reference transposes (and, in
eager PyTorch, would copy) the whole cache per layer per tick. The paged
entries take pools ``(NP, PS, HK, D)`` and block tables ``(B, NB)``
int32 whose unassigned entries hold the sentinel ``NP``; every table
entry read is clamped to the pool. Dense and paged run one CUDA kernel
body, so on the same KV the paged result is bitwise the dense one.

On a CUDA tensor each wrapper launches the split-KV pair (two launches,
counted once in ``.launches``): a split kernel on the grid
``(ceil(NSPLIT / 4), HK, B)``, one warp per absolute ``SPLIT_KEYS`` = 64
key split (``NSPLIT = ceil(S / 64)``, or ``ceil(NB * PS / 64)`` paged,
from static shapes: the host reads nothing of ``lengths``), the kv head's
G query heads as the rows of one tensor-core fragment (G <= ``MAX_G``);
and a combine kernel that folds each row's splits in ascending order. The
split kernel writes f32 partials into scratch the wrapper allocates with
``torch.empty`` (so a CUDA graph capture owns it): ``acc (B, NSPLIT, HQ,
D)``, ``den`` and ``aux (B, NSPLIT, HQ)`` — 4 (D + 2) bytes per query
head per 64 keys. The online-max pair reads the recompute flag at entry.
:func:`decode_attention_split_plain` and
:func:`paged_decode_attention_split_plain` are the CPU emulations of that
split and combine.

On a CPU tensor a wrapper runs the plain version, which walks the cache
in ``block_k`` tiles through :mod:`repro_torch.kernels.merge` exactly
like the TPU kernel's grid (the paged plain versions walk one page per
step, as the TPU kernel's grid does). ``block_k`` only shapes that plain
version: the kernel's splits are fixed and its result does not depend on
it.

The paged entries also take a quantized pool: int8 or float8_e4m3fn codes
with ``k_scale`` / ``v_scale``, the (NP, HK) f32 step of every (page, kv
head). On a CUDA tensor they launch the kernels' quantized bodies, which
turn each code into its exact bf16 value with the K step on the score
and the V step on P, and count those launches in
:data:`paged_decode_attention_unified_max_quant` /
:data:`paged_decode_attention_sync_quant`; the plain versions dequantize
each gathered page (``codes.float() * step``). The steps are the only
signal: codes without them, or steps beside bf16 pools, raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, merge, quant, ref

DEFAULT_BLOCK_K = 512
SPLIT_KEYS = 64          # absolute key positions per split (csrc kSplit)
MAX_G = 16               # query heads per kv head: one m16 fragment

# q, k, v, lengths, out, stat / flag, acc, den, aux
_PTRS = [_build.VP] * 9
# B, HK, G, S, D, NSPLIT, sb, ss, sh
_DIMS = [_build.I32] * 6 + [_build.I64] * 3
# B, HK, G, NB, PS, NP, D, NSPLIT, sp, ss, sh
_PDIMS = [_build.I32] * 8 + [_build.I64] * 3
_SIG = {
    "decode_attention_unified_max_bf16":
        _PTRS + _DIMS + [_build.F32, _build.F32, _build.VP],
    "decode_attention_sync_bf16": _PTRS + _DIMS + [_build.F32, _build.VP],
    # + bt
    "paged_decode_attention_unified_max_bf16":
        _PTRS + [_build.VP] + _PDIMS + [_build.F32, _build.F32, _build.VP],
    "paged_decode_attention_sync_bf16":
        _PTRS + [_build.VP] + _PDIMS + [_build.F32, _build.VP],
    # + bt, k_step, v_step pointers and the code-type flag (1 = fp8)
    "paged_decode_attention_unified_max_q8":
        _PTRS + [_build.VP] * 3 + _PDIMS
        + [_build.F32, _build.F32, _build.I32, _build.VP],
    "paged_decode_attention_sync_q8":
        _PTRS + [_build.VP] * 3 + _PDIMS + [_build.F32, _build.I32,
                                            _build.VP],
    # q, k, v, lengths, num, den, aux, scratch acc, den, aux; + start
    "decode_attention_partial_unified_max_bf16":
        [_build.VP] * 10 + _DIMS + [_build.I32, _build.F32, _build.F32,
                                    _build.VP],
    "decode_attention_partial_sync_bf16":
        [_build.VP] * 10 + _DIMS + [_build.I32, _build.F32, _build.VP],
}

# the quantized bodies' launches, apart from the bf16 kernels'
paged_decode_attention_unified_max_quant = _build.LaunchCounter(
    "paged_decode_attention_unified_max_quant")
paged_decode_attention_sync_quant = _build.LaunchCounter(
    "paged_decode_attention_sync_quant")


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


# ---------------------------------------------------------------------------
# The CUDA path's split and combine, emulated
# ---------------------------------------------------------------------------


def split_fold(qg, k, v, valid, *, unified_max: bool, phi: float = 0.0):
    """One split's partial of every query row, as the split kernel forms
    it: ``qg (..., R, D)`` f32 scaled query rows, ``k`` / ``v`` ``(...,
    L, D)`` f32 with every key it must not read at zero (the kernel
    zero-fills them), ``valid (..., R, L)``. Each row is folded by itself,
    as an mma.sync output row depends on its own A row only: products
    summed along D and along the keys, never a matmul, whose CPU kernels
    pick their summation order by the batch's shape. So a row's bits do
    not depend on the rows beside it (the grouped pair's contract). The
    weights are :func:`merge.unified_accumulate`'s and
    :func:`merge.sync_accumulate`'s. Returns ``(acc (..., R, D), den (...,
    R, 1), aux (..., R))``: aux is the row's max of ``s − φ`` over its
    valid keys (unified max) or its running max (online max), ``-inf``
    where it has none."""
    s = (qg.unsqueeze(-2) * k.unsqueeze(-3)).sum(-1)          # (..., R, L)
    neg = torch.full_like(s, float("-inf"))
    if unified_max:
        cen = s - phi
        aux = torch.where(valid, cen, neg).amax(dim=-1)
        e = torch.where(valid, torch.exp(cen), torch.zeros_like(cen))
    else:
        aux = torch.where(valid, s, neg).amax(dim=-1)
        shift = torch.where(torch.isfinite(aux), aux, torch.zeros_like(aux))
        e = torch.where(valid, torch.exp(s - shift[..., None]),
                        torch.zeros_like(s))
    acc = (e.unsqueeze(-1) * v.unsqueeze(-3)).sum(-2)        # (..., R, D)
    return acc, e.sum(dim=-1, keepdim=True), aux


def split_combine(parts, n, *, unified_max: bool):
    """Fold each row's splits ``0 .. n - 1`` in ascending order, as the
    combine kernel does: ``parts`` is the list of per-split ``(acc, den,
    aux)`` of :func:`split_fold`, ``n`` the rows' split counts
    (broadcastable to aux's shape). Unified-max partials add
    (:func:`merge.merge_unified`); online-max ones merge by the guarded
    :func:`merge.merge_lse` (an empty split adds nothing). Returns ``(out
    (..., R, D) f32, aux (..., R))``, a row with no split giving zeros."""
    acc, den, aux = split_accumulate(parts, n, unified_max=unified_max)
    return merge.finalize(acc, den, guard_zero=True), aux


def split_accumulate(parts, n, *, unified_max: bool):
    """:func:`split_combine`'s fold without the division: ``(acc (..., R,
    D), den (..., R, 1), aux (..., R))``, a row with no split giving 0, 0
    and -inf."""
    acc = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][1])
    aux = torch.full_like(parts[0][2], float("-inf"))
    n = torch.as_tensor(n, device=acc.device)
    for i, (a, d, x) in enumerate(parts):
        if unified_max:
            a2, d2, x2 = merge.merge_unified((acc, den, aux), (a, d, x))
        else:
            a2, d2, x2 = merge.merge_lse((acc, den, aux[..., None]),
                                         (a, d, x[..., None]))
            x2 = x2[..., 0]
        take = (i < n).expand_as(aux)
        acc = torch.where(take[..., None], a2, acc)
        den = torch.where(take[..., None], d2, den)
        aux = torch.where(take, x2, aux)
    return acc, den, aux


def split_parts(qg, k, v, lens, *, unified_max: bool, phi: float = 0.0):
    """Every split's partials of ``qg (B, HK, G, D)`` over the keys ``k``
    / ``v`` ``(B, HK, S, D)`` (f32, zero at and past ``lens``), cut at the
    absolute multiples of ``SPLIT_KEYS``; keys at or past ``lens (B,)``
    are masked."""
    b, hk, g, _ = qg.shape
    s_max = k.shape[2]
    parts = []
    for k0 in range(0, s_max, SPLIT_KEYS):
        k1 = min(k0 + SPLIT_KEYS, s_max)
        pos = torch.arange(k0, k1, device=qg.device)
        valid = (pos[None, :] < lens[:, None])[:, None, None, :].expand(
            b, hk, g, k1 - k0)
        parts.append(split_fold(qg, k[:, :, k0:k1], v[:, :, k0:k1], valid,
                                unified_max=unified_max, phi=phi))
    return parts


def split_counts(lens):
    """Each row's split count, ``ceil(lens / SPLIT_KEYS)``, as (B, 1, 1)."""
    return (-(-lens // SPLIT_KEYS))[:, None, None]


def _split_result(q, parts, lens, unified_max):
    b, hq, d = q.shape
    out, aux = split_combine(parts, split_counts(lens),
                             unified_max=unified_max)
    out = out.reshape(b, hq, d).to(q.dtype)
    return (out, aux.amax(dim=-1)) if unified_max else out


def decode_attention_split_plain(q, k_cache, v_cache, lengths, *,
                                 unified_max: bool = True, phi: float = 0.0,
                                 scale: float | None = None):
    """The dense CUDA path's split and combine, emulated on ``(B, HK, S,
    D)`` caches: :func:`split_fold` per 64-key split, folded in order by
    :func:`split_combine`. Keys at or past ``lengths`` (clamped to S) are
    read as zeros, as the kernel zero-fills them. Returns ``(out, stat (B,
    HK))`` for the unified-max scheme, ``out`` for the online-max one."""
    b, hq, d = q.shape
    hk, s_max = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hk, hq // hk, d).float() * scale
    lens = lengths.to(q.device).long().clamp(0, s_max)
    read = (torch.arange(s_max, device=q.device)[None, :]
            < lens[:, None])[:, None, :, None]
    k, v = (torch.where(read, c.float(), 0.0) for c in (k_cache, v_cache))
    parts = split_parts(qg, k, v, lens, unified_max=unified_max, phi=phi)
    return _split_result(q, parts, lens, unified_max)


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
    check_heads("decode attention", hq, k_cache.shape[1])
    return (q.contiguous(), lengths.to(device=q.device,
                                       dtype=torch.int32).contiguous())


def check_heads(what, hq, hk):
    """The split kernel holds a kv head's G = HQ/HK query heads in one
    16-row tensor-core fragment."""
    if hq // hk > MAX_G:
        raise ValueError(f"{what} kernel takes at most {MAX_G} query heads "
                         f"per kv head, got {hq // hk}")


def split_scratch(b, s_max, hq, d, device):
    """NSPLIT and the split kernel's f32 scratch ``(acc (B, NSPLIT, HQ,
    D), den, aux (B, NSPLIT, HQ))`` for ``s_max`` key positions."""
    nsplit = -(-s_max // SPLIT_KEYS)
    f32 = dict(dtype=torch.float32, device=device)
    return nsplit, (torch.empty((b, nsplit, hq, d), **f32),
                    torch.empty((b, nsplit, hq), **f32),
                    torch.empty((b, nsplit, hq), **f32))


def _dims(q, k_cache, nsplit):
    b, hq, d = q.shape
    hk, s_max = k_cache.shape[1], k_cache.shape[2]
    sb, sh, ss, _ = k_cache.stride()
    return [b, hk, hq // hk, s_max, d, nsplit, sb, ss, sh]


@_build.forward_only
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
    b, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stat = torch.empty((b, k_cache.shape[1]), dtype=torch.float32,
                       device=q.device)
    nsplit, scratch = split_scratch(b, k_cache.shape[2], hq, d, q.device)
    lib = _build.load("decode_attention", _SIG)
    entry = "decode_attention_unified_max_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(lens), _build.ptr(out), _build.ptr(stat),
        *map(_build.ptr, scratch), *_dims(q, k_cache, nsplit), scale, phi,
        _build.stream_of(q))
    _build.check(lib, entry, code)
    decode_attention_unified_max.launches += 1
    return out, stat


@_build.forward_only
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
    b, hq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("decode_attention_sync: out must be a contiguous "
                         "(B, HQ, D) tensor of q's dtype")
    nsplit, scratch = split_scratch(b, k_cache.shape[2], hq, d, q.device)
    lib = _build.load("decode_attention", _SIG)
    entry = "decode_attention_sync_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(lens), _build.ptr(out),
        _build.ptr(flag) if flag is not None else None,
        *map(_build.ptr, scratch), *_dims(q, k_cache, nsplit), scale,
        _build.stream_of(q))
    _build.check(lib, entry, code)
    decode_attention_sync.launches += 1
    return out


# ---------------------------------------------------------------------------
# Shard partials: one rank's slice of a sequence-split cache (slice 8a)
# ---------------------------------------------------------------------------


def local_lengths(lengths, start: int, s_loc: int):
    """Each row's key count on the slice of positions ``start .. start +
    s_loc - 1``: ``clamp(lengths - start, 0, s_loc)``."""
    return (lengths.long() - start).clamp(0, s_loc)


def decode_attention_partial_plain(q, k_loc, v_loc, lengths, start: int, *,
                                   unified_max: bool = True,
                                   phi: float = 0.0,
                                   scale: float | None = None):
    """Plain version of the shard partial: the split kernel's splits over
    the slice ``k_loc`` / ``v_loc`` ``(B, HK, S_loc, D)`` (key positions
    ``start`` on; ``lengths (B,)`` global), folded by
    :func:`split_accumulate` without the division. Returns ``(num (B, HQ,
    D), den (B, HQ), aux (B, HQ))`` in f32: aux is the row's max of ``s −
    φ`` (unified max) or of ``s`` (online max, num and den then relative
    to it); a row with no key on the slice gives 0, 0 and -inf."""
    b, hq, d = q.shape
    hk, s_loc = k_loc.shape[1], k_loc.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hk, hq // hk, d).float() * scale
    lens = local_lengths(lengths.to(q.device), start, s_loc)
    read = (torch.arange(s_loc, device=q.device)[None, :]
            < lens[:, None])[:, None, :, None]
    k, v = (torch.where(read, c.float(), 0.0) for c in (k_loc, v_loc))
    parts = split_parts(qg, k, v, lens, unified_max=unified_max, phi=phi)
    acc, den, aux = split_accumulate(parts, split_counts(lens),
                                     unified_max=unified_max)
    return acc.reshape(b, hq, d), den.reshape(b, hq), aux.reshape(b, hq)


def _partial(entry, counter, q, k_loc, v_loc, lengths, start, scale, *phi):
    q, lens = _check_inputs(q, k_loc, v_loc, lengths)
    b, hq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    num = torch.empty((b, hq, d), **f32)
    den, aux = torch.empty((b, hq), **f32), torch.empty((b, hq), **f32)
    nsplit, scratch = split_scratch(b, k_loc.shape[2], hq, d, q.device)
    lib = _build.load("decode_attention", _SIG)
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_loc), _build.ptr(v_loc),
        _build.ptr(lens), _build.ptr(num), _build.ptr(den), _build.ptr(aux),
        *map(_build.ptr, scratch), *_dims(q, k_loc, nsplit), int(start),
        scale, *phi, _build.stream_of(q))
    _build.check(lib, entry, code)
    counter.launches += 1
    return num, den, aux


@_build.forward_only
def decode_attention_partial_unified_max(q, k_loc, v_loc, lengths,
                                         start: int, *, phi: float = 0.0,
                                         scale: float | None = None):
    """Row 3 as a shard partial: ``(num (B, HQ, D), den (B, HQ),
    max_centered (B, HQ))`` f32 of this rank's slice ``k_loc`` / ``v_loc``
    ``(B, HK, S_loc, D)`` (key positions ``start`` on) under the unified
    max; ``lengths (B,)`` are global, and the kernel forms each row's
    local length on the device. Partials of the slices add
    (``core.softmax.combine_async``)."""
    if not q.is_cuda:
        return decode_attention_partial_plain(
            q, k_loc, v_loc, lengths, start, unified_max=True, phi=phi,
            scale=scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _partial("decode_attention_partial_unified_max_bf16",
                    decode_attention_partial_unified_max, q, k_loc, v_loc,
                    lengths, start, scale, phi)


@_build.forward_only
def decode_attention_partial_sync(q, k_loc, v_loc, lengths, start: int, *,
                                  scale: float | None = None):
    """Row 4 as a shard partial: ``(num (B, HQ, D), den (B, HQ), m (B,
    HQ))`` f32 of this rank's slice under the online max (num and den
    relative to the slice's max m), as
    :func:`decode_attention_partial_unified_max` takes it. It always runs:
    no overflow flag gates it. Partials join by the synchronized combine
    (``core.softmax.combine_sync``)."""
    if not q.is_cuda:
        return decode_attention_partial_plain(
            q, k_loc, v_loc, lengths, start, unified_max=False, scale=scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _partial("decode_attention_partial_sync_bf16",
                    decode_attention_partial_sync, q, k_loc, v_loc, lengths,
                    start, scale)


# ---------------------------------------------------------------------------
# Paged (block-table) entries
# ---------------------------------------------------------------------------


def page_values(pool, pages, steps=None):
    """The pool's pages ``pages`` (B,) as (B, PS, HK, D): values of a bf16
    pool, or a quantized pool's codes dequantized as the kernels do
    (:func:`ref.dequantize_pool_ref` on the gathered pages)."""
    if steps is None:
        return pool[pages]
    # gather the bytes: 1-byte codes move as uint8 on every device
    codes = pool.view(torch.uint8)[pages].view(pool.dtype)
    return ref.dequantize_pool_ref(codes, steps[pages])


def _pages(q, k_pool, v_pool, block_tables, lengths, scale, k_scale=None,
           v_scale=None):
    """Yield per-page (scores (B,HK,G,PS) f32, v (B,HK,PS,D), valid), one
    logical page of every row's table per step (the TPU grid's page
    axis); sentinel entries clamp to the pool's last page. Quantized
    pages are dequantized as they are read."""
    b, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    qg = q.reshape(b, hk, hq // hk, d).float() * scale
    bt = block_tables.to(q.device).long().clamp(0, num_pages - 1)
    lengths = lengths.to(q.device)
    for i in range(bt.shape[1]):
        kt = page_values(k_pool, bt[:, i], k_scale).float().permute(
            0, 2, 1, 3)                                       # (B,HK,PS,D)
        s = torch.matmul(qg, kt.transpose(-1, -2))           # (B,HK,G,PS)
        offs = i * ps + torch.arange(ps, device=q.device)
        valid = (offs[None, :] < lengths[:, None])[:, None, None, :]
        yield (s, page_values(v_pool, bt[:, i], v_scale).permute(0, 2, 1, 3),
               valid.expand_as(s))


def paged_decode_attention_unified_max_plain(q, k_pool, v_pool,
                                             block_tables, lengths, *,
                                             phi: float = 0.0,
                                             scale: float | None = None,
                                             k_scale=None, v_scale=None):
    """Plain version: ``(out (B,HQ,D), stat (B,HK) = max(s − φ))``."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, hq // hk, d), dtype=torch.float32,
                      device=q.device)
    den = torch.zeros((b, hk, hq // hk, 1), dtype=torch.float32,
                      device=q.device)
    msc = torch.full((b, hk), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale, k_scale, v_scale):
        acc, den, msc = merge.unified_accumulate(acc, den, msc, s - phi, v,
                                                 valid)
    out = merge.finalize(acc, den, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype), msc


def paged_decode_attention_sync_plain(q, k_pool, v_pool, block_tables,
                                      lengths, *,
                                      scale: float | None = None,
                                      k_scale=None, v_scale=None):
    """Plain version of the online-max scheme: ``out (B, HQ, D)``."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    acc = torch.zeros((b, hk, hq // hk, d), dtype=torch.float32,
                      device=q.device)
    den = torch.zeros((b, hk, hq // hk, 1), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hk, hq // hk, 1), float("-inf"), device=q.device)
    for s, v, valid in _pages(q, k_pool, v_pool, block_tables, lengths,
                              scale, k_scale, v_scale):
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
        acc, den, m = merge.sync_accumulate(acc, den, m, s, v)
    out = merge.finalize(acc, den, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_keys(q, k_pool, v_pool, block_tables, lengths, k_scale=None,
               v_scale=None):
    """The (B, HK, NB*PS, D) f32 keys and values a paged split kernel
    reads through its tables (dequantized codes for a quantized pool),
    zero at and past each row's length, and the lengths clamped to the
    table's width."""
    num_pages, ps = k_pool.shape[:2]
    nb = block_tables.shape[1]
    bt = block_tables.to(q.device).long().clamp(0, num_pages - 1)
    lens = lengths.to(q.device).long().clamp(0, nb * ps)
    read = (torch.arange(nb * ps, device=q.device)[None, :]
            < lens[:, None])[:, None, :, None]
    k, v = (torch.where(read, torch.cat(
        [page_values(pool, bt[:, i], st) for i in range(nb)],
        dim=1).float().permute(0, 2, 1, 3), 0.0)
        for pool, st in ((k_pool, k_scale), (v_pool, v_scale)))
    return k, v, lens


def paged_decode_attention_split_plain(q, k_pool, v_pool, block_tables,
                                       lengths, *, unified_max: bool = True,
                                       phi: float = 0.0,
                                       scale: float | None = None,
                                       k_scale=None, v_scale=None):
    """The paged CUDA path's split and combine, emulated: as
    :func:`decode_attention_split_plain` on the keys the block tables
    name (:func:`paged_keys`); the splits are cut on the table's logical
    positions, so on the same KV this is bitwise the dense emulation."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hk, hq // hk, d).float() * scale
    k, v, lens = paged_keys(q, k_pool, v_pool, block_tables, lengths,
                            k_scale, v_scale)
    parts = split_parts(qg, k, v, lens, unified_max=unified_max, phi=phi)
    return _split_result(q, parts, lens, unified_max)


def code_flag(k_pool, k_scale):
    """The quantized C entries' code-type flag of a checked pool: None
    for bf16 values (the bf16 entries), 0 for int8 codes, 1 for fp8."""
    if k_scale is None:
        return None
    return int(not quant.spec_for_dtype(k_pool.dtype).is_int)


def check_pools(what, q, k_pool, v_pool, k_scale=None, v_scale=None):
    """Validate q and the (NP, PS, HK, D) pools for a paged kernel: bf16
    pools, or 1-byte code pools with their (NP, HK) f32 steps."""
    num_pages, ps, hk, d = k_pool.shape
    if k_pool.shape != v_pool.shape or q.shape[-1] != d \
            or q.shape[-2] % hk:
        raise ValueError(f"{what} shapes q {tuple(q.shape)} pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both k_scale and v_scale, or "
                         "neither")
    spec = quant.spec_for_dtype(k_pool.dtype)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 q, got {q.dtype}")
    if k_scale is None:
        if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bf16 pools (or codes with "
                            f"k_scale / v_scale), got {k_pool.dtype}")
    else:
        if spec is None or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"{what} kernel with steps takes int8 / "
                            f"float8_e4m3fn code pools, got {k_pool.dtype} / "
                            f"{v_pool.dtype}")
        for t in (k_scale, v_scale):
            if t.shape != (num_pages, hk) or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.device != q.device:
                raise ValueError(f"{what}: steps must be contiguous f32 "
                                 f"(NP, HK) = {(num_pages, hk)} tensors on "
                                 f"q's device, got {tuple(t.shape)} "
                                 f"{t.dtype}")
    for t in (k_pool, v_pool):
        if t.device != q.device:
            raise ValueError(f"{what} inputs on different devices")
    if k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1 \
            or q.stride(-1) != 1:
        raise ValueError(f"{what} kernel needs k and v pools with equal "
                         "strides and a contiguous head_dim")
    vec = 16 // k_pool.element_size()       # elements per 16-byte load
    if any(s % vec for s in k_pool.stride()[:3]) \
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs 16-byte aligned pool rows")
    if d not in (32, 64, 128):
        raise ValueError(f"{what} kernel takes head_dim 32/64/128, got {d}")


def check_paged_inputs(what, q, k_pool, v_pool, block_tables, lengths,
                       k_scale=None, v_scale=None):
    """Validate pool / table operands for a paged kernel; returns the
    contiguous int32 (block_tables, lengths) on q's device."""
    check_pools(what, q, k_pool, v_pool, k_scale, v_scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError(f"{what} shapes q {tuple(q.shape)} tables "
                         f"{tuple(block_tables.shape)}")
    if block_tables.shape[1] < 1:
        raise ValueError(f"{what} kernel needs at least one table column")
    return (block_tables.to(device=q.device, dtype=torch.int32).contiguous(),
            lengths.to(device=q.device, dtype=torch.int32).contiguous())


def _paged_dims(q, k_pool, bt, nsplit):
    b, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    sp, ss, sh, _ = k_pool.stride()
    return [b, hk, hq // hk, bt.shape[1], ps, num_pages, d, nsplit, sp, ss,
            sh]


def _paged_launch(q, k_pool, v_pool, block_tables, lengths, k_scale,
                  v_scale):
    """Check a paged launch's operands; returns the contiguous q, int32
    tables and lengths, the code-type flag, the dims and the scratch."""
    bt, lens = check_paged_inputs("paged decode attention", q, k_pool,
                                  v_pool, block_tables, lengths, k_scale,
                                  v_scale)
    q = q.contiguous()
    b, hq, d = q.shape
    check_heads("paged decode attention", hq, k_pool.shape[2])
    nsplit, scratch = split_scratch(b, bt.shape[1] * k_pool.shape[1], hq, d,
                                    q.device)
    return (q, bt, lens, code_flag(k_pool, k_scale),
            _paged_dims(q, k_pool, bt, nsplit), scratch)


@_build.forward_only
def paged_decode_attention_unified_max(q, k_pool, v_pool, block_tables,
                                       lengths, *, phi: float = 0.0,
                                       scale: float | None = None,
                                       k_scale=None, v_scale=None):
    """T1 decode attention over a paged pool: ``(out (B,HQ,D), stat
    (B,HK))`` as :func:`decode_attention_unified_max`. With ``k_scale``
    / ``v_scale`` the pools hold codes (the quantized body)."""
    if not q.is_cuda:
        return paged_decode_attention_unified_max_plain(
            q, k_pool, v_pool, block_tables, lengths, phi=phi, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    q, bt, lens, fp8, dims, scratch = _paged_launch(
        q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out = torch.empty_like(q)
    stat = torch.empty((q.shape[0], k_pool.shape[2]), dtype=torch.float32,
                       device=q.device)
    lib = _build.load("decode_attention", _SIG)
    parts = map(_build.ptr, scratch)
    if fp8 is not None:
        entry = "paged_decode_attention_unified_max_q8"
        code = getattr(lib, entry)(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(bt),
            _build.ptr(lens), _build.ptr(out), _build.ptr(stat), *parts,
            *dims, scale, phi, fp8, _build.stream_of(q))
        _build.check(lib, entry, code)
        paged_decode_attention_unified_max_quant.launches += 1
        return out, stat
    entry = "paged_decode_attention_unified_max_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(bt), _build.ptr(lens), _build.ptr(out), _build.ptr(stat),
        *parts, *dims, scale, phi, _build.stream_of(q))
    _build.check(lib, entry, code)
    paged_decode_attention_unified_max.launches += 1
    return out, stat


@_build.forward_only
def paged_decode_attention_sync(q, k_pool, v_pool, block_tables, lengths, *,
                                scale: float | None = None,
                                out: torch.Tensor | None = None,
                                flag: torch.Tensor | None = None,
                                k_scale=None, v_scale=None):
    """Online-max paged decode attention; ``out``/``flag`` make it the
    overflow recompute, as in :func:`decode_attention_sync`. With
    ``k_scale`` / ``v_scale`` the pools hold codes."""
    if (out is None) != (flag is None):
        raise ValueError("pass both out= and flag=, or neither")
    if not q.is_cuda:
        res = paged_decode_attention_sync_plain(
            q, k_pool, v_pool, block_tables, lengths, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
        return res if out is None else torch.where(flag, res, out)
    q, bt, lens, fp8, dims, scratch = _paged_launch(
        q, k_pool, v_pool, block_tables, lengths, k_scale, v_scale)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or not out.is_contiguous() \
            or out.dtype != q.dtype:
        raise ValueError("paged_decode_attention_sync: out must be a "
                         "contiguous (B, HQ, D) tensor of q's dtype")
    lib = _build.load("decode_attention", _SIG)
    flag_p = _build.ptr(flag) if flag is not None else None
    parts = map(_build.ptr, scratch)
    if fp8 is not None:
        entry = "paged_decode_attention_sync_q8"
        code = getattr(lib, entry)(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(bt),
            _build.ptr(lens), _build.ptr(out), flag_p, *parts, *dims, scale,
            fp8, _build.stream_of(q))
        _build.check(lib, entry, code)
        paged_decode_attention_sync_quant.launches += 1
        return out
    entry = "paged_decode_attention_sync_bf16"
    code = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
        _build.ptr(bt), _build.ptr(lens), _build.ptr(out), flag_p, *parts,
        *dims, scale, _build.stream_of(q))
    _build.check(lib, entry, code)
    paged_decode_attention_sync.launches += 1
    return out


decode_attention_unified_max.launches = 0
decode_attention_sync.launches = 0
decode_attention_partial_unified_max.launches = 0
decode_attention_partial_sync.launches = 0
paged_decode_attention_unified_max.launches = 0
paged_decode_attention_sync.launches = 0
