"""The split-KV decode path of the port (rows 3-6 and the grouped pair of
row 11 of the kernel table) on the CPU, through its emulations of the
CUDA split and combine.

  * ``decode_attention_split_plain`` and
    ``paged_decode_attention_split_plain`` (64-key absolute splits, each
    folded on its own, then folded in order) against the unsplit plain
    versions and the JAX package's Pallas kernels run as its own tests run
    them (``interpret=True``): values, int8 and fp8 codes, both schemes,
    page sizes 16 and 64, G = 4 and 7 query heads per kv head, D = 64.
  * The paged emulation bitwise the dense one on the same KV; the grouped
    emulation (``grouped_paged_decode_attention_split_plain``) bitwise the
    paged one for prefixes shorter than, equal to, longer than and not a
    multiple of a 64-key split, on values and codes.
  * Nothing past ``lengths`` is read: NaN in every pool row or cache
    position past a row's length, and a table twice as wide, change no
    bit of any emulation.
  * What a CUDA launch allocates: NSPLIT and the scratch shapes, NWS, and
    the refusal of G above one 16-row fragment.

Tolerances: TOL["float32"] (f32 q and values or dequantized codes; only
the summation order differs). The CUDA kernels are held to the unsplit
plain versions on the card by ``chip_smoke.py``, and there paged = dense
and grouped = paged bit for bit as here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import decode_attention as jda
from repro.kernels import group_attention as jga
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import group_attention as tga
from repro_torch.kernels import quant as tquant
from repro_torch.serving import kvquant as tkvquant

HK, D = 2, 64


def _close(got: torch.Tensor, want):
    if isinstance(want, torch.Tensor):
        want = want.numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL["float32"])


def _f32(a: np.ndarray):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _codes(kind, pools):
    """The port's pools as int8 / fp8 codes with (NP, HK) steps, carried
    to JAX bit for bit; values unchanged for kind "values"."""
    if kind == "values":
        return [((jp, None), (tp, None)) for jp, tp in pools]
    spec = tquant.INT8 if kind == "int8" else tquant.FP8
    out = []
    for _, tp in pools:
        codes, steps = tkvquant.quantize_pages(tp, spec)
        raw = jnp.asarray(codes.view(torch.uint8).numpy())
        jc = raw.view(jnp.int8 if kind == "int8" else jnp.float8_e4m3fn)
        out.append(((jc, jnp.asarray(steps.numpy())), (codes, steps)))
    return out


def _paged(rng, *, ps, lengths, nb, g, kind="values", spare=3):
    """Random pages laid out for ``lengths`` in shuffled order (sentinel
    NP past each row's pages), q for G heads per kv head, and the pools
    as ``kind``. Returns (jax, port) operand tuples (q, (k, k_scale), (v,
    v_scale), tables, lengths); the scales are None for values."""
    b = len(lengths)
    pages = [-(-n // ps) for n in lengths]
    num_pages = sum(pages) + spare
    vals = [_f32(rng.normal(size=(num_pages, ps, HK, D))) for _ in range(2)]
    perm = rng.permutation(num_pages)
    bt = np.full((b, nb), num_pages, np.int32)
    lo = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[lo:lo + n]
        lo += n
    q = _f32(rng.normal(size=(b, HK * g, D)))
    (jk, tk), (jv, tv) = _codes(kind, vals)
    jops = (q[0], jk, jv, *_ints(bt)[:1], _ints(lengths)[0])
    tops = (q[1], tk, tv, _ints(bt)[1], _ints(lengths)[1])
    return jops, tops


def _kw(pool_pair_k, pool_pair_v):
    return ({} if pool_pair_k[1] is None else
            dict(k_scale=pool_pair_k[1], v_scale=pool_pair_v[1]))


# ---------------------------------------------------------------------------
# Rows 3-4: dense decode
# ---------------------------------------------------------------------------


# lengths either side of and on the split boundary, one key, and the whole
# cache (S = 200: the last split holds 8 keys)
_DENSE_LENGTHS = [1, 63, 64, 65, 200]


@pytest.mark.parametrize("g", [4, 7])
def test_dense_split_emulation_matches_plain_and_pallas(g):
    rng = np.random.default_rng(40 + g)
    b, s_max = len(_DENSE_LENGTHS), 200
    jq, tq = _f32(rng.normal(size=(b, HK * g, D)))
    jk, tk = _f32(rng.normal(size=(b, HK, s_max, D)))
    jv, tv = _f32(rng.normal(size=(b, HK, s_max, D)))
    jl, tl = _ints(_DENSE_LENGTHS)
    got, stat = tda.decode_attention_split_plain(tq, tk, tv, tl, phi=0.5)
    plain, plain_stat = tda.decode_attention_unified_max_plain(
        tq, tk, tv, tl, phi=0.5)
    want, want_stat = jda.decode_attention_unified_max(
        jq, jk, jv, jl, phi=0.5, interpret=True)
    for w, ws in ((plain, plain_stat), (want, want_stat)):
        _close(got, w)
        _close(stat, ws)
    got = tda.decode_attention_split_plain(tq, tk, tv, tl, unified_max=False)
    _close(got, tda.decode_attention_sync_plain(tq, tk, tv, tl))
    _close(got, jda.decode_attention_sync(jq, jk, jv, jl, interpret=True))


# ---------------------------------------------------------------------------
# Rows 5-6: paged decode, values and codes
# ---------------------------------------------------------------------------


_PAGED_LENGTHS = [1, 63, 64, 65, 150]


@pytest.mark.parametrize("ps,g", [(16, 7), (64, 4)])
@pytest.mark.parametrize("kind", ["values", "int8", "fp8"])
def test_paged_split_emulation_matches_plain_and_pallas(kind, ps, g):
    rng = np.random.default_rng(50 + ps + g)
    nb = -(-max(_PAGED_LENGTHS) // ps) + 1
    (jq, jk, jv, jbt, jl), (tq, tk, tv, tbt, tl) = _paged(
        rng, ps=ps, lengths=_PAGED_LENGTHS, nb=nb, g=g, kind=kind)
    jkw, tkw = _kw(jk, jv), _kw(tk, tv)
    args = (tq, tk[0], tv[0], tbt, tl)
    got, stat = tda.paged_decode_attention_split_plain(*args, phi=0.5,
                                                       **tkw)
    plain, plain_stat = tda.paged_decode_attention_unified_max_plain(
        *args, phi=0.5, **tkw)
    want, want_stat = jda.paged_decode_attention_unified_max(
        jq, jk[0], jv[0], jbt, jl, phi=0.5, interpret=True, **jkw)
    for w, ws in ((plain, plain_stat), (want, want_stat)):
        _close(got, w)
        _close(stat, ws)
    got = tda.paged_decode_attention_split_plain(*args, unified_max=False,
                                                 **tkw)
    assert torch.isfinite(got).all()
    _close(got, tda.paged_decode_attention_sync_plain(*args, **tkw))
    _close(got, jda.paged_decode_attention_sync(
        jq, jk[0], jv[0], jbt, jl, interpret=True, **jkw))


@pytest.mark.parametrize("unified_max", [True, False],
                         ids=["unified", "sync"])
def test_paged_split_emulation_bitwise_dense(unified_max):
    """The same KV in shuffled 16-row pages and in a dense cache: one
    split structure on logical positions, so the same bits."""
    rng = np.random.default_rng(60)
    lengths = [5, 64, 100, 0]
    _, (tq, (kp, _), (vp, _), tbt, tl) = _paged(
        rng, ps=16, lengths=lengths, nb=8, g=7)

    def dense(pool):
        return torch.stack([torch.cat([
            pool[int(p)] if p < pool.shape[0] else torch.zeros_like(pool[0])
            for p in row]) for row in tbt]).transpose(1, 2)

    kd, vd = dense(kp), dense(vp)
    paged = tda.paged_decode_attention_split_plain(
        tq, kp, vp, tbt, tl, unified_max=unified_max, phi=0.25)
    dense = tda.decode_attention_split_plain(
        tq, kd, vd, tl, unified_max=unified_max, phi=0.25)
    for a, b in zip(*((paged, dense) if unified_max
                      else ((paged,), (dense,)))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Row 11: the grouped pair on the same splits
# ---------------------------------------------------------------------------


def _groups(b, num_pages, specs):
    """JAX and port DecodeGroups from ``specs`` = [(prefix pages,
    prefix_len, member rows)], padded to powers of two with the slot
    manager's sentinels."""
    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p

    ng = pow2(len(specs))
    lp = pow2(max(len(pg) for pg, _, _ in specs))
    m = pow2(max(len(ms) for _, _, ms in specs))
    arrs = dict(tables=np.full((ng, lp), num_pages, np.int32),
                n_pages=np.zeros(ng, np.int32),
                g_prefix_len=np.zeros(ng, np.int32),
                num_members=np.zeros(ng, np.int32),
                member_rows=np.full((ng, m), b, np.int32),
                gid=np.full(b, ng, np.int32), member=np.zeros(b, np.int32),
                prefix_len=np.zeros(b, np.int32))
    for gi, (pages, plen, members) in enumerate(specs):
        arrs["tables"][gi, :len(pages)] = pages
        arrs["n_pages"][gi] = len(pages)
        arrs["g_prefix_len"][gi] = plen
        arrs["num_members"][gi] = len(members)
        arrs["member_rows"][gi, :len(members)] = members
        for r, i in enumerate(members):
            arrs["gid"][i], arrs["member"][i] = gi, r
            arrs["prefix_len"][i] = plen
    fields = tga.DecodeGroups._fields
    return (jga.DecodeGroups(*(jnp.asarray(arrs[f]) for f in fields)),
            tga.DecodeGroups(*(torch.from_numpy(arrs[f]) for f in fields)))


def _grouped(rng, *, ps, plen, g, kind="values"):
    """Rows 0, 1 and 3 share a ``plen``-key prefix (its pages shared in
    their tables, the last one ending mid-page where plen is not a page
    multiple), row 2 is solo; tails end mid-page. Returns the jax / port
    operands and DecodeGroups."""
    b = 4
    tails = [37, 70, 0, 1]
    shared = -(-plen // ps)
    lengths = [plen + t for t in tails]
    lengths[2] = 90
    own = [-(-n // ps) - (shared if i != 2 else 0)
           for i, n in enumerate(lengths)]
    num_pages = shared + sum(own) + 3
    nb = max(-(-n // ps) for n in lengths) + 1
    perm = [int(p) for p in rng.permutation(num_pages)]
    prefix_pages, rest = perm[:shared], perm[shared:]
    bt = np.full((b, nb), num_pages, np.int32)
    for i, n in enumerate(own):
        mine, rest = rest[:n], rest[n:]
        row = (prefix_pages if i != 2 else []) + mine
        bt[i, :len(row)] = row
    vals = [_f32(rng.normal(size=(num_pages, ps, HK, D))) for _ in range(2)]
    q = _f32(rng.normal(size=(b, HK * g, D)))
    (jk, tk), (jv, tv) = _codes(kind, vals)
    jg, tg = _groups(b, num_pages, [(prefix_pages, plen, [0, 1, 3])])
    return ((q[0], jk, jv, *_ints(bt)[:1], _ints(lengths)[0], jg),
            (q[1], tk, tv, _ints(bt)[1], _ints(lengths)[1], tg))


# prefixes shorter than, equal to, longer than and not a multiple of a split
_PREFIXES = [40, 64, 160, 192]


@pytest.mark.parametrize("plen", _PREFIXES)
@pytest.mark.parametrize("ps", [16, 64])
def test_grouped_split_emulation_bitwise_paged(ps, plen):
    """The grouped pair's three launches, emulated, against row 5's split
    and combine on the same pool: bitwise out and stat, for values and
    for int8 codes (f32 arithmetic on both sides)."""
    for kind, g in (("values", 7), ("int8", 4)):
        rng = np.random.default_rng(ps + plen)
        _, (tq, tk, tv, tbt, tl, tg) = _grouped(rng, ps=ps, plen=plen, g=g,
                                                kind=kind)
        kw = _kw(tk, tv)
        args = (tq, tk[0], tv[0], tbt, tl)
        got = tga.grouped_paged_decode_attention_split_plain(
            *args, tg, phi=0.25, **kw)
        want = tda.paged_decode_attention_split_plain(*args, phi=0.25, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), kind
        # stage 1 did the prefix's whole splits: none below 64 keys
        num, den, _ = tga.group_prefix_plain(tq, tk[0], tv[0], tg,
                                             phi=0.25, **kw)
        whole = plen // tda.SPLIT_KEYS
        assert bool((den[0, :whole, :, :3 * g] > 0).all())
        assert not den[0, whole:].any()


@pytest.mark.parametrize("plen", [40, 160])
def test_grouped_split_emulation_matches_pallas(plen):
    """The grouped emulation and the two plain stages against the JAX
    two-stage kernel (out; its stat is the group-wide max, the port's the
    ungrouped kernel's per row)."""
    rng = np.random.default_rng(70 + plen)
    (jq, jk, jv, jbt, jl, jg), (tq, tk, tv, tbt, tl, tg) = _grouped(
        rng, ps=16, plen=plen, g=7)
    want, _ = jga.grouped_paged_decode_attention_unified_max(
        jq, jk[0], jv[0], jbt, jl, jg, phi=0.25, interpret=True)
    _, want_stat = jda.paged_decode_attention_unified_max(
        jq, jk[0], jv[0], jbt, jl, phi=0.25, interpret=True)
    for got, stat in (tga.grouped_paged_decode_attention_split_plain(
            tq, tk[0], tv[0], tbt, tl, tg, phi=0.25),
            tga.grouped_paged_decode_attention_unified_max_plain(
                tq, tk[0], tv[0], tbt, tl, tg, phi=0.25)):
        _close(got, want)
        _close(stat, want_stat)


# ---------------------------------------------------------------------------
# Nothing past lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unified_max", [True, False],
                         ids=["unified", "sync"])
def test_split_emulations_never_read_past_lengths(unified_max):
    """NaN in every pool row that holds no position below its row's
    length (and in every spare page), or in a dense cache past each
    length, and a table twice as wide: no bit of the dense, paged or
    grouped emulation moves. A row of length 0 comes out as zeros."""
    rng = np.random.default_rng(80)
    _, (tq, (kp, _), (vp, _), tbt, tl, tg) = _grouped(rng, ps=16, plen=100,
                                                      g=7)
    tl = tl.clone()
    tl[2] = 0
    ps, num_pages = kp.shape[1], kp.shape[0]
    live = torch.zeros(num_pages, ps, dtype=torch.bool)
    for row, n in zip(tbt.tolist(), tl.tolist()):
        for pos in range(n):
            live[row[pos // ps], pos % ps] = True
    dirty = [torch.where(live[:, :, None, None], p,
                         torch.full_like(p, float("nan"))) for p in (kp, vp)]
    wide = torch.cat([tbt, torch.full_like(tbt, num_pages)], dim=1)

    def paged(k, v, bt):
        res = tda.paged_decode_attention_split_plain(
            tq, k, v, bt, tl, unified_max=unified_max, phi=0.25)
        return res if unified_max else (res,)

    clean = paged(kp, vp, tbt)
    for k, v, bt in ((*dirty, tbt), (*dirty, wide)):
        assert all(torch.equal(a, b) for a, b in zip(paged(k, v, bt), clean))
    assert not clean[0][2].any()
    if unified_max:
        assert bool(torch.isneginf(clean[1][2]).all())
        grouped = tga.grouped_paged_decode_attention_split_plain(
            tq, *dirty, tbt, tl, tg, phi=0.25)
        assert all(torch.equal(a, b) for a, b in zip(grouped, clean))
    s_max = tbt.shape[1] * ps
    dense = [torch.stack([torch.cat([p[int(pg)] for pg in row.clamp(
        max=num_pages - 1)]) for row in tbt]).transpose(1, 2)
        for p in (kp, vp)]
    past = (torch.arange(s_max)[None, :] >= tl[:, None])[:, None, :, None]
    dense_dirty = [torch.where(past, torch.full_like(c, float("nan")), c)
                   for c in dense]

    def run_dense(k, v):
        res = tda.decode_attention_split_plain(
            tq, k, v, tl, unified_max=unified_max, phi=0.25)
        return res if unified_max else (res,)

    assert all(torch.equal(a, b) for a, b in zip(run_dense(*dense_dirty),
                                                 run_dense(*dense)))


# ---------------------------------------------------------------------------
# What a CUDA launch allocates and refuses
# ---------------------------------------------------------------------------


def test_split_launch_scratch_and_refusals():
    """NSPLIT = ceil(S / 64) with (B, NSPLIT, HQ[, D]) f32 scratch; stage
    1's NWS = max(1, LP * PS // 64); more than 16 query heads per kv head
    (one tensor-core fragment) is refused before any launch."""
    assert (tda.SPLIT_KEYS, tda.MAX_G) == (64, 16)
    for s_max, want in ((1, 1), (64, 1), (65, 2), (200, 4), (1024, 16)):
        nsplit, (acc, den, aux) = tda.split_scratch(3, s_max, 14, 64, "cpu")
        assert nsplit == want
        assert acc.shape == (3, want, 14, 64) and acc.dtype == torch.float32
        assert den.shape == aux.shape == (3, want, 14)
    assert [tga.prefix_splits(lp, ps) for lp, ps in
            ((1, 16), (2, 16), (4, 16), (3, 64), (5, 32))] == [1, 1, 1, 3, 2]
    tda.check_heads("t", 32, 2)
    with pytest.raises(ValueError, match="at most 16"):
        tda.check_heads("t", 34, 2)
    q = torch.zeros(2, 34, 64, dtype=torch.bfloat16)
    cache = torch.zeros(2, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 16"):
        tda._check_inputs(q, cache, cache, torch.ones(2))
