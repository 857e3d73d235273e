"""Grouped prefix-shared decode attention, T1 unified max (kernels:
``csrc/group_attention.cu``, two launches).

Replaces ``repro/kernels/group_attention.py::
grouped_paged_decode_attention_unified_max``. Requests whose block tables
lead with the same run of shared pages form a group (a
:class:`DecodeGroups` operand, built by the slot manager's group plan);
the shared run is read once per ``(group, kv head)`` for every member's
query rows instead of once per request:

  * stage 1 (:func:`group_prefix_partials`) folds the prefix keys into
    unnormalised unified-max partials, one per query row and per warp of
    the ungrouped kernel's chunk walk: ``num (NG, HK, 4, M·G, D)``,
    ``den`` and ``stat`` ``(NG, HK, 4, M·G)``;
  * stage 2 (:func:`group_tail_merge`) seeds each row with its own
    partials (empty for a solo row), folds in the row's private tail and
    normalises: ``(out (B, HQ, D), stat (B, HK))``.

Keeping the partials per warp is what makes the kernels bitwise the
ungrouped paged kernel (row 5) on the same pool: every row sees the same
floating-point operations in the same order (see the source's header).
``stat`` is per row, the max of ``s − φ`` over the row's prefix and tail
keys, as the ungrouped kernel reports it (the JAX kernel gives every
member the group-wide max; the overflow flag is the same).

On a CUDA tensor each stage wrapper launches its kernel and counts the
launch in ``.launches``; on a CPU tensor it runs its plain version, which
emulates the warp split (key position ``p`` belongs to warp
``(p // 32) % 4``).

A quantized pool (int8 / float8_e4m3fn codes with ``k_scale`` /
``v_scale``, the (NP, HK) f32 steps) runs both stages' quantized bodies,
counted in :data:`group_prefix_partials_quant` /
:data:`group_tail_merge_quant`; they dequantize as the ungrouped
quantized kernel does, so the pair stays bitwise it. The plain versions
read the pool's dequantized view (``codes.float() * step``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, merge
from repro_torch.kernels.decode_attention import (check_paged_inputs,
                                                  check_pools, code_flag)
from repro_torch.kernels.ref import dequantize_pool_ref, gather_paged_kv

WARPS = 4          # warp partials per row (the ungrouped kernel's warps)
CHUNK = 32         # keys per warp chunk
MAX_G = 16         # query heads per kv head the tail kernel holds


class DecodeGroups(NamedTuple):
    """Device operands of one tick's shared-prefix group plan (int32).

    NG / LP / M are power-of-two padded (group count, prefix pages,
    members); B is the slot count. Padding groups have ``n_pages ==
    num_members == g_prefix_len == 0``; padded table entries hold the
    pool's sentinel ``NP`` and padded member rows the sentinel ``B``
    (consumers clamp). Solo rows have ``gid == NG`` and ``prefix_len ==
    0``."""

    tables: torch.Tensor        # (NG, LP) physical pages of shared runs
    n_pages: torch.Tensor       # (NG,) live pages per group
    g_prefix_len: torch.Tensor  # (NG,) shared tokens per group
    num_members: torch.Tensor   # (NG,)
    member_rows: torch.Tensor   # (NG, M) batch row of each member
    gid: torch.Tensor           # (B,) group of each row (NG = solo)
    member: torch.Tensor        # (B,) rank of the row within its group
    prefix_len: torch.Tensor    # (B,) shared tokens of each row (0 = solo)

    def to(self, device) -> "DecodeGroups":
        return DecodeGroups(*(t.to(device=device, dtype=torch.int32)
                              .contiguous() for t in self))


# one library, loaded once with every entry's argument types
_SIG = {"group_prefix_bf16": [_build.VP] * 10 + [_build.I32] * 9
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.VP],
        "group_tail_bf16": [_build.VP] * 13 + [_build.I32] * 9
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.VP],
        # + k_step, v_step pointers and the code-type flag (1 = fp8)
        "group_prefix_q8": [_build.VP] * 12 + [_build.I32] * 9
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.I32, _build.VP],
        "group_tail_q8": [_build.VP] * 15 + [_build.I32] * 9
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.I32, _build.VP]}

# the quantized bodies' launches, apart from the bf16 kernels'
group_prefix_partials_quant = _build.LaunchCounter(
    "group_prefix_partials_quant")
group_tail_merge_quant = _build.LaunchCounter("group_tail_merge_quant")


def _gather(pool, tables, steps=None):
    """f32 (R, NB*PS, HK, D) view of a pool through ``tables``: values of
    a bf16 pool, or a quantized pool's ``codes.float() * step``."""
    if steps is not None:
        pool = dequantize_pool_ref(pool, steps)
    return gather_paged_kv(pool, tables).float()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def group_prefix_plain(q, k_pool, v_pool, groups: DecodeGroups, *,
                       phi: float = 0.0, scale: float | None = None,
                       k_scale=None, v_scale=None):
    """Plain stage 1: per-warp unified-max partials of every member row
    over its group's first ``g_prefix_len`` keys (rows past
    ``num_members * G`` get the empty partial)."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    g = hq // hk
    ng, lp = groups.tables.shape
    m = groups.member_rows.shape[1]
    scale = scale if scale is not None else d ** -0.5
    rows = groups.member_rows.long().clamp(0, b - 1)              # (NG, M)
    qs = (q.reshape(b, hk, g, d).float() * scale)[rows]           # NG,M,HK,G,D
    qs = qs.permute(0, 2, 1, 3, 4).reshape(ng, hk, m * g, d)
    k = _gather(k_pool, groups.tables, k_scale)                   # NG,S,HK,D
    v = _gather(v_pool, groups.tables, v_scale)
    centered = torch.einsum("nhrd,nshd->nhrs", qs, k) - phi
    pos = torch.arange(k.shape[1], device=q.device)
    plen = groups.g_prefix_len.to(q.device).long()
    live = groups.num_members.to(q.device).long().clamp(0, m) * g
    valid = ((pos[None, None, None, :] < plen[:, None, None, None])
             & (torch.arange(m * g, device=q.device)[None, None, :, None]
                < live[:, None, None, None]))
    warp = (pos // CHUNK) % WARPS
    vt = v.permute(0, 2, 1, 3)                                    # NG,HK,S,D
    num, den, stat = [], [], []
    for w in range(WARPS):
        vw = valid & (warp == w)[None, None, None, :]
        e = torch.where(vw, torch.exp(centered), torch.zeros_like(centered))
        num.append(torch.matmul(e, vt))
        den.append(e.sum(dim=-1))
        stat.append(torch.where(vw, centered, torch.full_like(
            centered, float("-inf"))).amax(dim=-1))
    return (torch.stack(num, dim=2), torch.stack(den, dim=2),
            torch.stack(stat, dim=2))


def _row_seeds(groups: DecodeGroups, num, den, stat, g: int):
    """Each row's own stage-1 partials summed over the warps: ``(acc
    (B,HK,G,D), den (B,HK,G,1), msc (B,HK), prefix_len (B,))``; solo
    rows get the empty partial and prefix length 0."""
    ng, hk, _, mg, d = num.shape
    gid = groups.gid.long()
    mem = groups.member.long()
    plen = groups.prefix_len.long()
    seeded = ((plen > 0) & (gid >= 0) & (gid < ng) & (mem >= 0)
              & ((mem + 1) * g <= mg)).to(num.device)
    rows = (mem.clamp(0, mg // g - 1)[:, None] * g
            + torch.arange(g, device=gid.device)[None, :]).to(num.device)
    gc = gid.clamp(0, ng - 1).to(num.device)
    b = gid.shape[0]
    idx = rows[:, None, None, :].expand(b, hk, WARPS, g)
    acc = torch.gather(num[gc], 3, idx[..., None].expand(
        b, hk, WARPS, g, d)).sum(dim=2)
    dsum = torch.gather(den[gc], 3, idx).sum(dim=2)[..., None]
    msc = torch.gather(stat[gc], 3, idx).amax(dim=(2, 3))
    keep = seeded[:, None, None, None]
    acc = torch.where(keep, acc, torch.zeros_like(acc))
    dsum = torch.where(keep, dsum, torch.zeros_like(dsum))
    msc = torch.where(seeded[:, None], msc, torch.full_like(
        msc, float("-inf")))
    return acc, dsum, msc, torch.where(seeded, plen.to(num.device),
                                       torch.zeros_like(plen.to(num.device)))


def group_tail_plain(q, k_pool, v_pool, block_tables, lengths,
                     groups: DecodeGroups, num, den, stat, *,
                     phi: float = 0.0, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """Plain stage 2: each row's stage-1 partials plus its keys
    ``[prefix_len, length)``, normalised: ``(out (B,HQ,D), stat
    (B,HK))``."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    acc, dsum, msc, plen = _row_seeds(groups, num, den, stat, g)
    k = _gather(k_pool, block_tables, k_scale)                     # B,S,HK,D
    v = _gather(v_pool, block_tables, v_scale)
    qg = q.reshape(b, hk, g, d).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    pos = torch.arange(k.shape[1], device=q.device)
    lens = lengths.to(q.device).long()
    valid = ((pos[None, :] >= plen[:, None]) & (pos[None, :] < lens[:, None])
             )[:, None, None, :].expand_as(s)
    acc, dsum, msc = merge.unified_accumulate(
        acc, dsum, msc, s - phi, v.permute(0, 2, 1, 3), valid)
    out = merge.finalize(acc, dsum, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype), msc


def grouped_paged_decode_attention_unified_max_plain(
        q, k_pool, v_pool, block_tables, lengths, groups: DecodeGroups, *,
        phi: float = 0.0, scale: float | None = None, k_scale=None,
        v_scale=None):
    """Plain version of both stages: ``(out (B,HQ,D), stat (B,HK))``."""
    qkw = dict(phi=phi, scale=scale, k_scale=k_scale, v_scale=v_scale)
    parts = group_prefix_plain(q, k_pool, v_pool, groups, **qkw)
    return group_tail_plain(q, k_pool, v_pool, block_tables, lengths,
                            groups, *parts, **qkw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_groups(groups: DecodeGroups, b: int, device) -> DecodeGroups:
    ng, lp = groups.tables.shape
    if lp < 1 or groups.member_rows.dim() != 2 \
            or groups.member_rows.shape[0] != ng \
            or groups.member_rows.shape[1] < 1 \
            or any(t.shape != (ng,) for t in (groups.n_pages,
                                               groups.g_prefix_len,
                                               groups.num_members)) \
            or any(t.shape != (b,) for t in (groups.gid, groups.member,
                                              groups.prefix_len)):
        raise ValueError(
            "grouped decode: DecodeGroups shapes tables "
            f"{tuple(groups.tables.shape)} member_rows "
            f"{tuple(groups.member_rows.shape)} gid {tuple(groups.gid.shape)}"
            f" for a batch of {b}")
    return groups.to(device)


def _pool_dims(k_pool):
    num_pages, ps, hk, d = k_pool.shape
    sp, ss, sh, _ = k_pool.stride()
    return num_pages, ps, hk, d, sp, ss, sh


def group_prefix_partials(q, k_pool, v_pool, groups: DecodeGroups, *,
                          phi: float = 0.0, scale: float | None = None,
                          k_scale=None, v_scale=None):
    """Stage 1: ``(num (NG,HK,4,M·G,D), den, stat (NG,HK,4,M·G))`` f32.
    With ``k_scale`` / ``v_scale`` the pools hold codes."""
    if not q.is_cuda:
        return group_prefix_plain(q, k_pool, v_pool, groups, phi=phi,
                                  scale=scale, k_scale=k_scale,
                                  v_scale=v_scale)
    check_pools("grouped decode attention", q, k_pool, v_pool, k_scale,
                v_scale)
    fp8 = code_flag(k_pool, k_scale)
    gr = _check_groups(groups, q.shape[0], q.device)
    q = q.contiguous()
    b, hq, d = q.shape
    num_pages, ps, hk, _, sp, ss, sh = _pool_dims(k_pool)
    g = hq // hk
    ng, lp = gr.tables.shape
    m = gr.member_rows.shape[1]
    scale = scale if scale is not None else d ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    num = torch.empty((ng, hk, WARPS, m * g, d), **f32)
    den = torch.empty((ng, hk, WARPS, m * g), **f32)
    stat = torch.empty((ng, hk, WARPS, m * g), **f32)
    lib = _build.load("group_attention", _SIG)
    pools = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(gr.tables), _build.ptr(gr.g_prefix_len),
            _build.ptr(gr.num_members), _build.ptr(gr.member_rows),
            _build.ptr(num), _build.ptr(den), _build.ptr(stat),
            b, hk, g, ng, lp, m, ps, num_pages, d, sp, ss, sh, scale, phi)
    if fp8 is not None:
        entry, counter = "group_prefix_q8", group_prefix_partials_quant
        code = lib.group_prefix_q8(*pools, _build.ptr(k_scale),
                                   _build.ptr(v_scale), *rest, fp8,
                                   _build.stream_of(q))
    else:
        entry, counter = "group_prefix_bf16", group_prefix_partials
        code = lib.group_prefix_bf16(*pools, *rest, _build.stream_of(q))
    _build.check(lib, entry, code)
    counter.launches += 1
    return num, den, stat


def group_tail_merge(q, k_pool, v_pool, block_tables, lengths,
                     groups: DecodeGroups, num, den, stat, *,
                     phi: float = 0.0, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """Stage 2: ``(out (B,HQ,D), stat (B,HK))`` from stage 1's
    partials and each row's private tail. With ``k_scale`` / ``v_scale``
    the pools hold codes."""
    if not q.is_cuda:
        return group_tail_plain(q, k_pool, v_pool, block_tables, lengths,
                                groups, num, den, stat, phi=phi, scale=scale,
                                k_scale=k_scale, v_scale=v_scale)
    bt, lens = check_paged_inputs("grouped decode attention", q, k_pool,
                                  v_pool, block_tables, lengths, k_scale,
                                  v_scale)
    fp8 = code_flag(k_pool, k_scale)
    gr = _check_groups(groups, q.shape[0], q.device)
    q = q.contiguous()
    b, hq, d = q.shape
    num_pages, ps, hk, _, sp, ss, sh = _pool_dims(k_pool)
    g = hq // hk
    if g > MAX_G:
        raise ValueError(f"grouped decode kernel takes at most {MAX_G} query "
                         f"heads per kv head, got {g}")
    ng, mg = num.shape[0], num.shape[3]
    for t, shape in ((num, (ng, hk, WARPS, mg, d)),
                     (den, (ng, hk, WARPS, mg)), (stat, (ng, hk, WARPS, mg))):
        if t.shape != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError("grouped decode: stage-1 partials must be "
                             "contiguous f32 tensors of group_prefix_"
                             "partials' shapes")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stat_out = torch.empty((b, hk), dtype=torch.float32, device=q.device)
    lib = _build.load("group_attention", _SIG)
    pools = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(bt), _build.ptr(lens), _build.ptr(gr.gid),
            _build.ptr(gr.member), _build.ptr(gr.prefix_len),
            _build.ptr(num), _build.ptr(den), _build.ptr(stat),
            _build.ptr(out), _build.ptr(stat_out), b, hk, g, bt.shape[1], ps,
            num_pages, ng, mg, d, sp, ss, sh, scale, phi)
    if fp8 is not None:
        entry, counter = "group_tail_q8", group_tail_merge_quant
        code = lib.group_tail_q8(*pools, _build.ptr(k_scale),
                                 _build.ptr(v_scale), *rest, fp8,
                                 _build.stream_of(q))
    else:
        entry, counter = "group_tail_bf16", group_tail_merge
        code = lib.group_tail_bf16(*pools, *rest, _build.stream_of(q))
    _build.check(lib, entry, code)
    counter.launches += 1
    return out, stat_out


def grouped_paged_decode_attention_unified_max(
        q, k_pool, v_pool, block_tables, lengths, groups: DecodeGroups, *,
        phi: float = 0.0, scale: float | None = None, k_scale=None,
        v_scale=None):
    """Two-stage grouped decode attention over a paged pool: ``(out
    (B,HQ,D), stat (B,HK))`` as
    :func:`~repro_torch.kernels.decode_attention.
    paged_decode_attention_unified_max` returns them. With ``k_scale`` /
    ``v_scale`` the pools hold codes."""
    qkw = dict(phi=phi, scale=scale, k_scale=k_scale, v_scale=v_scale)
    parts = group_prefix_partials(q, k_pool, v_pool, groups, **qkw)
    return group_tail_merge(q, k_pool, v_pool, block_tables, lengths,
                            groups, *parts, **qkw)


group_prefix_partials.launches = 0
group_tail_merge.launches = 0
