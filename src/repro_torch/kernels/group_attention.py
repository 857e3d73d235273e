"""Grouped prefix-shared decode attention, T1 unified max (kernels:
``csrc/group_attention.cu`` on ``csrc/decode_split.cuh``, three launches).

Replaces ``repro/kernels/group_attention.py::
grouped_paged_decode_attention_unified_max``. Requests whose block tables
lead with the same run of shared pages form a group (a
:class:`DecodeGroups` operand, built by the slot manager's group plan);
the shared run is read once per ``(group, kv head)`` for every member's
query rows instead of once per request. Both stages cut the keys at the
ungrouped paged kernel's (row 5's) absolute ``SPLIT_KEYS`` = 64 key
splits:

  * stage 1 (:func:`group_prefix_partials`, one launch on the grid
    ``(NWS, HK, NG)``, one block per split reading its tile once, a warp
    per 16 member rows) forms the unnormalised unified-max partial of
    every whole prefix split (keys ``64 s .. 64 s + 63`` all below
    ``g_prefix_len``) for each of the group's M·G member rows (member m's
    head g is row ``m G + g``): ``num (NG, NWS, HK, M·G, D)``,
    ``den`` and ``stat`` ``(NG, NWS, HK, M·G)`` with ``NWS = max(1, LP·PS
    // 64)`` from the static table width. Member slots past
    ``num_members`` carry the empty partial (0, 0, -inf); the kernel
    leaves the splits at or past the prefix's whole-split end unwritten
    (nothing reads them), where the plain version gives the empty
    partial;
  * stage 2 (:func:`group_tail_merge`, two launches counted once) is row
    5's split kernel over each row's own table from the first split at or
    past its prefix's whole-split end (solo rows: from 0) and row 5's
    combine, which folds each row's splits in ascending order, taking
    those below that start from its group's stage-1 partials at its member
    slot: ``(out (B, HQ, D), stat (B, HK))``.

Where the prefix ends inside a split (page size below 64), stage 2 reads
the prefix's last partial split, at most 63 keys, once per member row; at
64-key pages every shared page is read once per group. A split's partial
of a row depends only on its q row and its keys, so the pair is bitwise
the ungrouped paged kernel (row 5) on the same pool, for every prefix
length (see the sources' headers). ``stat`` is per row, the max of ``s −
φ`` over the row's prefix and rest, as the ungrouped kernel reports it
(the JAX kernel gives every member the group-wide max; the overflow flag
is the same).

On a CUDA tensor each stage wrapper launches its kernels and counts one
launch per call in ``.launches``; on a CPU tensor it runs its plain
version: stage 1 is the per-split fold of
:func:`~repro_torch.kernels.decode_attention.split_fold`, stage 2 folds a
row's group partials in order, then its remaining keys in one piece
through :mod:`repro_torch.kernels.merge`.
:func:`grouped_paged_decode_attention_split_plain` emulates the whole
CUDA path (its stage 2 split per split as well); it is bitwise
:func:`~repro_torch.kernels.decode_attention.
paged_decode_attention_split_plain` on f32 inputs.

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
from repro_torch.kernels.decode_attention import (
    SPLIT_KEYS, check_heads, check_paged_inputs, check_pools, code_flag,
    paged_keys, split_combine, split_counts, split_fold, split_parts,
    split_scratch)
from repro_torch.kernels.ref import dequantize_pool_ref, gather_paged_kv


class DecodeGroups(NamedTuple):
    """Device operands of one tick's shared-prefix group plan (int32).

    NG / LP / M are power-of-two padded (group count, prefix pages,
    members); B is the slot count. Padding groups have ``n_pages ==
    num_members == g_prefix_len == 0``; padded table entries hold the
    pool's sentinel ``NP`` and padded member rows the sentinel ``B``
    (consumers clamp). Solo rows have ``gid == NG`` and ``prefix_len ==
    0``. Stage 1's partials are laid out per 64-key split of the tables'
    ``LP * PS`` positions and per member slot (module docstring)."""

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


# one library, loaded once with every entry's argument types: pointers,
# then B, HK, G, NG, LP, M, PS, NP, D, NWS (stage 1) or B, HK, G, NB, PS,
# NP, NG, MG, D, NWS, NSPLIT (stage 2), then sp, ss, sh, scale, phi
_SIG = {"group_prefix_bf16": [_build.VP] * 10 + [_build.I32] * 10
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.VP],
        "group_tail_bf16": [_build.VP] * 16 + [_build.I32] * 11
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.VP],
        # + k_step, v_step pointers and the code-type flag (1 = fp8)
        "group_prefix_q8": [_build.VP] * 12 + [_build.I32] * 10
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.I32, _build.VP],
        "group_tail_q8": [_build.VP] * 18 + [_build.I32] * 11
        + [_build.I64] * 3 + [_build.F32, _build.F32, _build.I32, _build.VP]}

# the quantized bodies' launches, apart from the bf16 kernels'
group_prefix_partials_quant = _build.LaunchCounter(
    "group_prefix_partials_quant")
group_tail_merge_quant = _build.LaunchCounter("group_tail_merge_quant")


def prefix_splits(lp: int, ps: int) -> int:
    """NWS: the 64-key splits stage 1 lays out for ``LP`` table columns of
    ``PS``-row pages (at least one, so no scratch axis is empty)."""
    return max(1, lp * ps // SPLIT_KEYS)


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
    """Plain stage 1: the unified-max partial of every whole prefix split
    of every member row, one :func:`split_fold` per split: ``(num (NG,
    NWS, HK, M·G, D), den, stat (NG, NWS, HK, M·G))``. Member slots past
    ``num_members`` and splits at or past ``g_prefix_len // 64`` hold the
    empty partial (0, 0, -inf)."""
    b, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    g = hq // hk
    ng, lp = groups.tables.shape
    m = groups.member_rows.shape[1]
    nws = prefix_splits(lp, ps)
    scale = scale if scale is not None else d ** -0.5
    rows = groups.member_rows.to(q.device).long().clamp(0, b - 1)  # (NG, M)
    qs = (q.reshape(b, hk, g, d).float() * scale)[rows]           # NG,M,HK,G,D
    qs = qs.permute(0, 2, 1, 3, 4).reshape(ng, hk, m * g, d)
    plen = groups.g_prefix_len.to(q.device).long().clamp(0, lp * ps)
    live = groups.num_members.to(q.device).long().clamp(0, m) * g
    live_rows = (torch.arange(m * g, device=q.device)[None, :]
                 < live[:, None])                                # (NG, MG)
    k, v = (_gather(pool, groups.tables.to(q.device), st).permute(0, 2, 1, 3)
            for pool, st in ((k_pool, k_scale), (v_pool, v_scale)))
    num = torch.zeros((ng, nws, hk, m * g, d), device=q.device)
    den = torch.zeros((ng, nws, hk, m * g), device=q.device)
    stat = torch.full((ng, nws, hk, m * g), float("-inf"), device=q.device)
    for i in range(min(nws, lp * ps // SPLIT_KEYS)):
        k0, k1 = i * SPLIT_KEYS, (i + 1) * SPLIT_KEYS
        whole = k1 <= plen                                          # (NG,)
        valid = (live_rows & whole[:, None])[:, None, :, None].expand(
            ng, hk, m * g, SPLIT_KEYS)
        kw, vw = (torch.where(whole[:, None, None, None], t[:, :, k0:k1], 0.0)
                  for t in (k, v))
        acc, dn, aux = split_fold(qs, kw, vw, valid, unified_max=True,
                                  phi=phi)
        num[:, i], den[:, i], stat[:, i] = acc, dn[..., 0], aux
    return num, den, stat


def _seeded(groups: DecodeGroups, g: int, ng: int, mg: int, nws: int,
            s_max: int, device):
    """Each row's group, member slot (clamped) and first own split (0 for
    a solo row): the split below which its partials come from stage 1."""
    gid = groups.gid.to(device).long()
    mem = groups.member.to(device).long()
    plen = groups.prefix_len.to(device).long()
    seeded = ((plen > 0) & (gid >= 0) & (gid < ng) & (mem >= 0)
              & ((mem + 1) * g <= mg))
    first = torch.where(seeded, (plen.clamp(max=s_max) // SPLIT_KEYS)
                        .clamp(max=nws), torch.zeros_like(plen))
    return gid.clamp(0, ng - 1), mem.clamp(0, mg // g - 1), first


def _group_split(num, den, stat, gid, mem, g, i):
    """Split i of stage 1's partials at each row's member slot, as (acc
    (B, HK, G, D), den (B, HK, G, 1), aux (B, HK, G))."""
    idx = (mem[:, None] * g + torch.arange(g, device=num.device)[None, :])
    hk = num.shape[2]
    idx = idx[:, None, :].expand(-1, hk, -1)                   # (B, HK, G)
    acc = torch.gather(num[gid, i], 2, idx[..., None].expand(
        -1, -1, -1, num.shape[-1]))
    return (acc, torch.gather(den[gid, i], 2, idx)[..., None],
            torch.gather(stat[gid, i], 2, idx))


def group_tail_plain(q, k_pool, v_pool, block_tables, lengths,
                     groups: DecodeGroups, num, den, stat, *,
                     phi: float = 0.0, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """Plain stage 2: each row's stage-1 partials below its first own
    split, folded in order (:func:`merge.merge_unified`), plus its keys
    from that split to its length in one piece, normalised: ``(out
    (B,HQ,D), stat (B,HK))``."""
    b, hq, d = q.shape
    num_pages, ps, hk, _ = k_pool.shape
    g = hq // hk
    ng, nws, _, mg, _ = num.shape
    scale = scale if scale is not None else d ** -0.5
    k, v, lens = paged_keys(q, k_pool, v_pool, block_tables, lengths,
                            k_scale, v_scale)
    gid, mem, first = _seeded(groups, g, ng, mg, nws, k.shape[2], q.device)
    part = (torch.zeros((b, hk, g, d), device=q.device),
            torch.zeros((b, hk, g, 1), device=q.device),
            torch.full((b, hk, g), float("-inf"), device=q.device))
    for i in range(nws):
        merged = merge.merge_unified(part, _group_split(num, den, stat, gid,
                                                        mem, g, i))
        take = (i < first)[:, None, None]
        part = tuple(torch.where(take if t.dim() == 3 else take[..., None],
                                 n, t) for n, t in zip(merged, part))
    acc, dsum, msc = part
    qg = q.reshape(b, hk, g, d).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k)
    pos = torch.arange(k.shape[2], device=q.device)
    valid = ((pos[None, :] >= first[:, None] * SPLIT_KEYS)
             & (pos[None, :] < lens[:, None]))[:, None, None, :].expand_as(s)
    acc, dsum, smax = merge.unified_accumulate(acc, dsum, msc.amax(dim=-1),
                                               s - phi, v, valid)
    out = merge.finalize(acc, dsum, guard_zero=True)
    return out.reshape(b, hq, d).to(q.dtype), smax


def grouped_paged_decode_attention_unified_max_plain(
        q, k_pool, v_pool, block_tables, lengths, groups: DecodeGroups, *,
        phi: float = 0.0, scale: float | None = None, k_scale=None,
        v_scale=None):
    """Plain version of both stages: ``(out (B,HQ,D), stat (B,HK))``."""
    qkw = dict(phi=phi, scale=scale, k_scale=k_scale, v_scale=v_scale)
    parts = group_prefix_plain(q, k_pool, v_pool, groups, **qkw)
    return group_tail_plain(q, k_pool, v_pool, block_tables, lengths,
                            groups, *parts, **qkw)


def grouped_paged_decode_attention_split_plain(
        q, k_pool, v_pool, block_tables, lengths, groups: DecodeGroups, *,
        phi: float = 0.0, scale: float | None = None, k_scale=None,
        v_scale=None):
    """The CUDA path's three launches, emulated: stage 1's per-split
    partials (:func:`group_prefix_plain`), each row's own splits from its
    first own split on (:func:`split_fold`, as row 5's split kernel), and
    the combine's ordered fold (:func:`split_combine`) taking the splits
    below that start from the group's partials at the row's member slot.
    Returns ``(out (B, HQ, D), stat (B, HK))``; on f32 inputs it is
    bitwise :func:`paged_decode_attention_split_plain`."""
    b, hq, d = q.shape
    hk = k_pool.shape[2]
    g = hq // hk
    scale = scale if scale is not None else d ** -0.5
    num, den, stat = group_prefix_plain(q, k_pool, v_pool, groups, phi=phi,
                                        scale=scale, k_scale=k_scale,
                                        v_scale=v_scale)
    ng, nws, _, mg, _ = num.shape
    qg = q.reshape(b, hk, g, d).float() * scale
    k, v, lens = paged_keys(q, k_pool, v_pool, block_tables, lengths,
                            k_scale, v_scale)
    gid, mem, first = _seeded(groups, g, ng, mg, nws, k.shape[2], q.device)
    parts = split_parts(qg, k, v, lens, unified_max=True, phi=phi)
    for i in range(min(nws, len(parts))):
        grp = _group_split(num, den, stat, gid, mem, g, i)
        take = (i < first)[:, None, None]
        parts[i] = tuple(
            torch.where(take if t.dim() == 3 else take[..., None], x, t)
            for x, t in zip(grp, parts[i]))
    out, aux = split_combine(parts, split_counts(lens), unified_max=True)
    return out.reshape(b, hq, d).to(q.dtype), aux.amax(dim=-1)


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


@_build.forward_only
def group_prefix_partials(q, k_pool, v_pool, groups: DecodeGroups, *,
                          phi: float = 0.0, scale: float | None = None,
                          k_scale=None, v_scale=None):
    """Stage 1: ``(num (NG, NWS, HK, M·G, D), den, stat (NG, NWS, HK,
    M·G))`` f32, the whole prefix splits' partials of every member slot
    (module docstring). With ``k_scale`` / ``v_scale`` the pools hold
    codes."""
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
    nws = prefix_splits(lp, ps)
    scale = scale if scale is not None else d ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    num = torch.empty((ng, nws, hk, m * g, d), **f32)
    den = torch.empty((ng, nws, hk, m * g), **f32)
    stat = torch.empty((ng, nws, hk, m * g), **f32)
    lib = _build.load("group_attention", _SIG)
    pools = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(gr.tables), _build.ptr(gr.g_prefix_len),
            _build.ptr(gr.num_members), _build.ptr(gr.member_rows),
            _build.ptr(num), _build.ptr(den), _build.ptr(stat),
            b, hk, g, ng, lp, m, ps, num_pages, d, nws, sp, ss, sh, scale,
            phi)
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


@_build.forward_only
def group_tail_merge(q, k_pool, v_pool, block_tables, lengths,
                     groups: DecodeGroups, num, den, stat, *,
                     phi: float = 0.0, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """Stage 2: ``(out (B,HQ,D), stat (B,HK))`` from stage 1's
    partials and each row's own splits from its first own split on (its
    split kernel and the combine, one counted launch). With ``k_scale`` /
    ``v_scale`` the pools hold codes."""
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
    check_heads("grouped decode attention", hq, hk)
    ng, nws, mg = num.shape[0], num.shape[1], num.shape[3]
    for t, shape in ((num, (ng, nws, hk, mg, d)),
                     (den, (ng, nws, hk, mg)), (stat, (ng, nws, hk, mg))):
        if t.shape != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError("grouped decode: stage-1 partials must be "
                             "contiguous f32 tensors of group_prefix_"
                             "partials' shapes")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    stat_out = torch.empty((b, hk), dtype=torch.float32, device=q.device)
    nsplit, scratch = split_scratch(b, bt.shape[1] * ps, hq, d, q.device)
    lib = _build.load("group_attention", _SIG)
    pools = (_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool))
    rest = (_build.ptr(bt), _build.ptr(lens), _build.ptr(gr.gid),
            _build.ptr(gr.member), _build.ptr(gr.prefix_len),
            _build.ptr(num), _build.ptr(den), _build.ptr(stat),
            _build.ptr(out), _build.ptr(stat_out), *map(_build.ptr, scratch),
            b, hk, g, bt.shape[1], ps, num_pages, ng, mg, d, nws, nsplit,
            sp, ss, sh, scale, phi)
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
