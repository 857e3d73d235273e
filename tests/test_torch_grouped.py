"""The port's grouped prefix-shared decode (row 11 of the kernel table)
on the CPU.

  * Kernel: the two stages' plain versions against the JAX package's
    two-stage Pallas kernel run the way its own tests run it
    (``interpret=True``), on ``DecodeGroups`` built from the same specs
    (mixed groups, a group of one, a prefix ending mid-page, solo rows,
    padding groups) and from both slot managers' group plans, and the
    ``ops`` front door with groups on both backends against the JAX front
    door, overflow recompute included.
  * Oracles: the port's grouped oracles equal its ungrouped ones bitwise.
  * Host side: ``shared_prefix_groups`` and ``group_plan`` of both
    packages agree on the same slot and refcount states, through COW
    forks and releases; the port's plan and operands are cached.
  * Engine: the port's grouped engine against the JAX grouped engine,
    token for token with equal group counters; grouped = ungrouped =
    dense inside the port; the serve CLI's ``--decode-group``.

Tolerances: TOL["float32"] for f32 inputs (same math, other summation
order), TOL["bfloat16"] for bf16 inputs. The CUDA kernels are held to
these plain versions, and bitwise to the ungrouped paged kernel, on the
card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.config import SoftmaxPhiConfig as JSoftmaxPhiConfig
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import decode_attention as jda
from repro.kernels import group_attention as jga
from repro.kernels import ops as jops
from repro.models.api import get_model as jget_model
from repro.serving import blockpool as jbp
from repro.serving import prefix as jprefix
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core.plan import make_plan
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import group_attention as tga
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.blockpool import BlockPool, PagedSlotManager
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix import PrefixIndex, shared_prefix_groups
from repro_torch.serving.request import SamplingParams

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCH = "qwen2-0.5b"
PS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs it in
    parallel workers beside other files, where more threads only
    contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dtype: str = "float32"):
    j = jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _close(got: torch.Tensor, want, dtype: str = "float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def _groups(b, num_pages, specs):
    """JAX and port DecodeGroups from ``specs`` = [(prefix pages,
    prefix_len, member rows)], every axis padded to a power of two and
    every sentinel placed as the slot manager places them."""
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
    for g, (pages, plen, members) in enumerate(specs):
        arrs["tables"][g, :len(pages)] = pages
        arrs["n_pages"][g] = len(pages)
        arrs["g_prefix_len"][g] = plen
        arrs["num_members"][g] = len(members)
        arrs["member_rows"][g, :len(members)] = members
        for r, i in enumerate(members):
            arrs["gid"][i], arrs["member"][i] = g, r
            arrs["prefix_len"][i] = plen
    fields = tga.DecodeGroups._fields
    return (jga.DecodeGroups(*(jnp.asarray(arrs[f]) for f in fields)),
            tga.DecodeGroups(*(torch.from_numpy(arrs[f]) for f in fields)))


def _fixture(dtype, *, seed=0, b=6, hq=8, hk=2, d=32, num_pages=32, nb=6):
    """Rows {0, 2, 4} lead with pages [3, 4], rows {1, 5} with page [7],
    row 3 is private. Row 4's tail is empty (length == prefix); the other
    tails end mid-page."""
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(b, hq, d)), dtype)
    kp = _pair(rng.normal(size=(num_pages, PS, hk, d)), dtype)
    vp = _pair(rng.normal(size=(num_pages, PS, hk, d)), dtype)
    bt = np.full((b, nb), num_pages, np.int32)
    bt[0, :4] = [3, 4, 10, 11]
    bt[1, :2] = [7, 12]
    bt[2, :3] = [3, 4, 13]
    bt[3, :2] = [15, 16]
    bt[4, :2] = [3, 4]
    bt[5, :3] = [7, 17, 18]
    lengths = np.array([3 * PS + 5, PS + 3, 2 * PS + 7, PS + 9, 2 * PS,
                        2 * PS + 1], np.int32)
    return (q, kp, vp, (jnp.asarray(bt), torch.from_numpy(bt)),
            (jnp.asarray(lengths), torch.from_numpy(lengths)))


_SPECS = {
    # 3-way and 2-way groups beside a solo row
    "mixed": [([3, 4], 2 * PS, [0, 2, 4]), ([7], PS, [1, 5])],
    # a degenerate one-member group beside solo rows
    "group_of_one": [([3, 4], 2 * PS, [0])],
    # the prefix ends inside its last page: stage 2 finishes that page
    "partial_last_page": [([3, 4], 2 * PS - 5, [0, 2])],
    # three groups pad NG to 4: a padding group with zero counts
    "padding_group": [([3, 4], 2 * PS, [0, 2]), ([7], PS, [1, 5]),
                      ([3], PS, [4])],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_SPECS))
def test_grouped_plain_matches_pallas(case, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jbt, tbt), (jl, tl) = _fixture(dtype)
    jg, tg = _groups(6, jk.shape[0], _SPECS[case])
    want, _ = jga.grouped_paged_decode_attention_unified_max(
        jq, jk, jv, jbt, jl, jg, phi=0.25, interpret=True)
    got, stat = tga.grouped_paged_decode_attention_unified_max(
        tq, tk, tv, tbt, tl, tg, phi=0.25)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)
    # the stat is per row, as the ungrouped kernel reports it (the JAX
    # grouped kernel broadcasts the group's max); the flag is the same
    _, want_stat = jda.paged_decode_attention_unified_max(
        jq, jk, jv, jbt, jl, phi=0.25, interpret=True)
    _close(stat, want_stat, dtype)
    # the two stages compose to the whole; stage 1 lays its partials out
    # per 64-key split of the group tables' positions (at least one)
    parts = tga.group_prefix_partials(tq, tk, tv, tg, phi=0.25)
    nws = tga.prefix_splits(jg.tables.shape[1], PS)
    assert [tuple(t.shape) for t in parts] == [
        (jg.tables.shape[0], nws, 2,
         jg.member_rows.shape[1] * 4) + s for s in ((32,), (), ())]
    out2, stat2 = tga.group_tail_merge(tq, tk, tv, tbt, tl, tg, *parts,
                                       phi=0.25)
    assert torch.equal(out2, got) and torch.equal(stat2, stat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_pallas_on_a_group_plan(dtype):
    """DecodeGroups as the slot managers build them: three slots share a
    two-page header, one slot is private, one slot is free. The JAX
    manager's plan feeds the JAX kernel, the port manager's (equal) plan
    the port's plain version, over the same pool and tables."""
    ps, num_pages = 16, 24
    jm, tm = _managers(num_pages=num_pages, page_size=ps, num_slots=5,
                       max_seq=80)
    rng = np.random.default_rng(21)
    header = rng.integers(1, 50, 2 * ps).astype(np.int32)
    prompts = [np.concatenate([header, rng.integers(1, 50, n).astype(
        np.int32)]) for n in (5, 17, 9)]
    prompts.insert(2, rng.integers(1, 50, 20).astype(np.int32))
    for rid, toks in enumerate(prompts):
        idx = _both(jm, tm, "try_assign", rid, len(toks), 8, tokens=toks)
        _both(jm, tm, "commit_prefix", idx, toks)
        jm.slots[idx].length = tm.slots[idx].length = len(toks)
    tplan = _same_plan(jm, tm, 2)
    assert tplan.n_grouped == 3
    jg = jm.group_plan(2).operands()
    tg = tplan.operands("cpu")
    bt = np.array(jm.block_tables())
    np.testing.assert_array_equal(bt, tm.block_tables("cpu").numpy())
    lengths = np.array([s.length + 1 if not s.free else 0
                        for s in tm.slots], np.int32)
    b, hq, hk, d = bt.shape[0], 8, 2, 32
    jq, tq = _pair(rng.normal(size=(b, hq, d)), dtype)
    jk, tk = _pair(rng.normal(size=(num_pages, ps, hk, d)), dtype)
    jv, tv = _pair(rng.normal(size=(num_pages, ps, hk, d)), dtype)
    want, _ = jga.grouped_paged_decode_attention_unified_max(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(lengths), jg, phi=0.25,
        interpret=True)
    got, _ = tga.grouped_paged_decode_attention_unified_max(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(lengths), tg,
        phi=0.25)
    _close(got, want, dtype)


def test_grouped_plain_equals_ungrouped_plain_in_f32():
    """The grouped split changes nothing but the order of f32 sums: the
    port's grouped plain version against its paged plain version."""
    q, kp, vp, bt, lengths = _fixture("float32", seed=3)
    _, tg = _groups(6, 32, _SPECS["mixed"])
    got, stat = tga.grouped_paged_decode_attention_unified_max(
        q[1], kp[1], vp[1], bt[1], lengths[1], tg, phi=0.0)
    want, wstat = tda.paged_decode_attention_unified_max(
        q[1], kp[1], vp[1], bt[1], lengths[1], phi=0.0)
    torch.testing.assert_close(got, want, **TOL["float32"])
    torch.testing.assert_close(stat, wstat, **TOL["float32"])


def test_stage_one_partials_follow_the_warp_chunks():
    """Stage 1 keeps one partial per 64-key split, the unit one warp of
    the split kernel computes (row 5's splits), and per member slot:
    ``(NG, NWS, HK, M·G)`` with NWS = LP·PS // 64. A prefix under 64 keys
    has no whole split and leaves stage 1 empty; a 64-key prefix fills
    split 0, a 100-key one split 0 only (stage 2 takes keys 64-99 from
    the rows' own tables), a 128-key one splits 0 and 1. Member slots
    past num_members and splits past the prefix stay empty (0, 0,
    -inf)."""
    q, kp, vp, _, _ = _fixture("float32", seed=5, nb=6)
    pages = [3, 4, 10, 11, 12, 13, 14, 16]
    g = 4                                        # HQ / HK
    for plen, busy in ((PS, set()), (4 * PS, {0}), (100, {0}),
                       (8 * PS, {0, 1})):
        _, tg = _groups(6, 32, [(pages, plen, [0, 2])])
        num, den, stat = tga.group_prefix_partials(q[1], kp[1], vp[1], tg)
        assert num.shape == (1, 2, 2, 2 * g, 32)
        assert den.shape == stat.shape == (1, 2, 2, 2 * g)
        for s in range(2):
            live = den[0, s, :, :2 * g]
            assert bool((live > 0).all()) == (s in busy)
            assert bool((live == 0).all()) == (s not in busy)
            assert bool(torch.isneginf(stat[0, s, :, :2 * g]).all()) == \
                (s not in busy)
        # member slots past num_members carry the empty partial
        _, tg = _groups(6, 32, [(pages, plen, [0, 2, 4])])
        num, den, stat = tga.group_prefix_partials(q[1], kp[1], vp[1], tg)
        assert num.shape[3] == 4 * g
        assert not den[0, :, :, 3 * g:].any()
        assert not num[0, :, :, 3 * g:].any()
        assert bool(torch.isneginf(stat[0, :, :, 3 * g:]).all())


def test_grouped_oracles_equal_ungrouped_bitwise():
    q, kp, vp, bt, lengths = _fixture("float32", seed=1)
    for case in ("mixed", "partial_last_page"):
        _, tg = _groups(6, 32, _SPECS[case])
        for pool in (kp[1], vp[1]):
            assert torch.equal(ref.gather_grouped_kv(pool, bt[1], tg),
                               ref.gather_paged_kv(pool, bt[1]))
        args = (q[1], kp[1], vp[1], bt[1], lengths[1])
        assert torch.equal(ref.attention_decode_grouped_ref(*args, tg),
                           ref.attention_decode_paged_ref(*args))
        got = ref.attention_decode_grouped_unified_max_ref(*args, tg,
                                                           phi=0.5)
        want = ref.attention_decode_paged_unified_max_ref(*args, phi=0.5)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("scale_q", [1.0, 30.0], ids=["t1", "recompute"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ops_grouped_decode_matches_jax(backend, scale_q):
    """The front door with groups: T1 on both backends, and with q scaled
    so that some s − φ leaves the band, the overflow recompute (the
    ungrouped sync kernel on "cuda")."""
    (jq, tq), (jk, tk), (jv, tv), (jbt, tbt), (jl, tl) = _fixture(
        "float32", seed=9)
    jq, tq = jq * scale_q, tq * scale_q
    jg, tg = _groups(6, jk.shape[0], _SPECS["mixed"])
    jphi = JSoftmaxPhiConfig(enabled=True, phi=0.5, band=(-2.0, 2.0))
    tphi = SoftmaxPhiConfig(enabled=True, phi=0.5, band=(-2.0, 2.0))
    jplan = jmake_plan("pallas" if backend == "cuda" else "xla")
    want = jops.attention_decode_paged(jq, jk, jv, jbt, jl, phi_cfg=jphi,
                                       plan=jplan, groups=jg)
    got = ops.attention_decode_paged(tq, tk, tv, tbt, tl, phi_cfg=tphi,
                                     plan=make_plan(backend), groups=tg)
    _close(got, want)
    ungrouped = ops.attention_decode_paged(tq, tk, tv, tbt, tl,
                                           phi_cfg=tphi,
                                           plan=make_plan(backend))
    if backend == "torch":
        assert torch.equal(got, ungrouped)
    else:
        torch.testing.assert_close(got, ungrouped, **TOL["float32"])


def test_grouped_wrappers_check_operands():
    q, kp, vp, bt, lengths = _fixture("float32")
    _, tg = _groups(6, 32, _SPECS["mixed"])
    bad = tg._replace(gid=tg.gid[:4])
    with pytest.raises(ValueError, match="DecodeGroups"):
        tga._check_groups(bad, 6, "cpu")
    assert all(t.dtype == torch.int32
               for t in tga._check_groups(tg, 6, "cpu"))


# ---------------------------------------------------------------------------
# Host side: shared_prefix_groups and the slot manager's group plan
# ---------------------------------------------------------------------------


def _managers(num_pages=16, page_size=4, num_slots=3, max_seq=32):
    jm = jbp.PagedSlotManager(num_slots, max_seq,
                              jbp.BlockPool(num_pages, page_size),
                              prefix_index=jprefix.PrefixIndex(page_size))
    tm = PagedSlotManager(num_slots, max_seq, BlockPool(num_pages, page_size),
                          prefix_index=PrefixIndex(page_size))
    return jm, tm


def _same_plan(jm, tm, threshold):
    jp, tp = jm.group_plan(threshold), tm.group_plan(threshold)
    assert (jp is None) == (tp is None)
    jg = jprefix.shared_prefix_groups(jm.slots, jm.pool.refcount)
    tgr = shared_prefix_groups(tm.slots, tm.pool.refcount)
    assert [(list(k), m) for k, m in jg] == [(list(k), m) for k, m in tgr]
    if tp is None:
        return None
    for f in ("gid", "member", "prefix_len", "tables", "n_pages",
              "g_prefix_len", "num_members", "member_rows"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert (tp.n_grouped, tp.pages_deduped) == (jp.n_grouped,
                                                jp.pages_deduped)
    return tp


def _both(jm, tm, method, *args, **kw):
    a = getattr(jm, method)(*args, **kw)
    b = getattr(tm, method)(*args, **kw)
    assert a == b, method
    return b


def test_group_plans_agree_through_fork_and_release():
    jm, tm = _managers()
    toks = np.arange(100, 109, dtype=np.int32)            # 2 full pages
    a = _both(jm, tm, "try_assign", 0, 9, 4, tokens=toks)
    _both(jm, tm, "commit_prefix", a, toks)
    b = _both(jm, tm, "try_assign", 1, 9, 4, tokens=toks)
    c = _both(jm, tm, "try_assign", 2, 9, 4, tokens=toks)
    for i in (a, b, c):
        jm.slots[i].length = tm.slots[i].length = 9
    plan = _same_plan(jm, tm, 2)
    assert plan.n_grouped == 3 and plan.pages_deduped == 4
    assert _same_plan(jm, tm, 7) is None                  # 3 x 2 < 7
    # a COW fork privatizes one member's first page: it leaves the group
    _both(jm, tm, "fork_for_write", b, 0, 4)
    plan = _same_plan(jm, tm, 2)
    assert plan.n_grouped == 2
    # releasing a member leaves a group of one: no plan
    _both(jm, tm, "release", c)
    assert _same_plan(jm, tm, 2) is None
    tm.check()


def test_group_plans_agree_on_random_lifecycles():
    """Seeded admissions with a common header, growth, forks and
    releases: both packages build the same plan after every event."""
    rng = np.random.default_rng(11)
    jm, tm = _managers(num_pages=40, page_size=4, num_slots=4, max_seq=48)
    header = np.arange(200, 212, dtype=np.int32)           # 3 pages
    live, rid, plans = {}, 0, 0
    for _ in range(60):
        op = rng.integers(4)
        free = [i for i, s in enumerate(tm.slots) if s.free]
        if op == 0 and free:
            toks = np.concatenate([header[:4 * int(rng.integers(1, 4))],
                                   rng.integers(1, 50, int(rng.integers(
                                       1, 6))).astype(np.int32)])
            idx = _both(jm, tm, "try_assign", rid, len(toks), 8,
                        tokens=toks)
            rid += 1
            if idx is not None:
                _both(jm, tm, "commit_prefix", idx, toks)
                jm.slots[idx].length = tm.slots[idx].length = len(toks)
                live[idx] = len(toks)
        elif op == 1 and live:
            idx = int(rng.choice(sorted(live)))
            n = live[idx] + 1
            if _both(jm, tm, "ensure", idx, n):
                _both(jm, tm, "fork_for_write", idx, n - 1, n)
                jm.slots[idx].length = tm.slots[idx].length = n
                live[idx] = n
        elif op == 2 and live:
            idx = int(rng.choice(sorted(live)))
            _both(jm, tm, "release", idx)
            del live[idx]
        plans += _same_plan(jm, tm, int(rng.integers(1, 4))) is not None
        tm.check()
    assert plans > 10


def test_group_plan_and_operands_cached_until_tables_change():
    _, tm = _managers()
    toks = np.arange(100, 109, dtype=np.int32)
    a = tm.try_assign(0, 9, 4, tokens=toks)
    tm.commit_prefix(a, toks)
    b = tm.try_assign(1, 9, 4, tokens=toks)
    for i in (a, b):
        tm.slots[i].length = 9
    plan = tm.group_plan(2)
    assert tm.group_plan(2) is plan
    ops_ = plan.operands("cpu")
    assert plan.operands("cpu") is ops_
    assert all(t.dtype == torch.int32 for t in ops_)
    np.testing.assert_array_equal(ops_.gid.numpy(), plan.gid)
    tm.ensure(a, 17)                                       # growth
    assert tm.group_plan(2) is not plan


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(scope="module")
def ref_model():
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **F32)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **F32)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _header_prompts(seed, header_len, tails, vocab=500):
    rng = np.random.default_rng(seed)
    header = rng.integers(1, vocab, size=header_len).astype(np.int32)
    return [np.concatenate([header, rng.integers(1, vocab, size=n).astype(
        np.int32)]) for n in tails]


_WORKLOADS = {
    "waves": dict(prompts=(11, 32, (3, 19, 8, 27, 12)),
                  budgets=[6, 3, 9, 1, 5],
                  kw=dict(num_slots=2, max_seq=128, page_size=16,
                          prefill_chunk=16)),
    "preempt": dict(prompts=(7, 16, (9, 10)), budgets=[26, 26],
                    kw=dict(num_slots=2, max_seq=80, page_size=16,
                            prefill_chunk=16, num_pages=5)),
}


@pytest.mark.parametrize("workload", ["waves", "preempt"])
def test_grouped_engine_matches_reference(ref_model, workload):
    jcfg, jparams, tcfg, tparams = ref_model
    w = _WORKLOADS[workload]
    prompts = _header_prompts(*w["prompts"])
    jeng = JEngine(jcfg, jparams, cache_kind="paged", prefix_sharing=True,
                   plan=jmake_plan(decode_group="grouped",
                                   group_threshold=1), **w["kw"])
    want = jeng.run([(p, JSamplingParams(max_new_tokens=m))
                     for p, m in zip(prompts, w["budgets"])])
    teng = Engine(tcfg, tparams, cache_kind="paged", prefix_sharing=True,
                  plan=make_plan("cuda", decode_group="grouped",
                                 fused_ffn=False, group_threshold=1),
                  device="cpu", **w["kw"])
    got = teng.run([(p, SamplingParams(max_new_tokens=m))
                    for p, m in zip(prompts, w["budgets"])])
    assert got == want
    assert teng.ticks == jeng.ticks
    assert teng.stats.grouped_requests > 0
    for field in ("grouped_requests", "prefix_kv_bytes_saved",
                  "preemptions", "shared_prefix_pages", "cow_forks"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    teng.slots.check()
    assert teng.pool.used_pages == 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_grouped_equals_ungrouped_equals_dense(ref_model, backend):
    """Greedy tokens are the same with grouped decode, without it and on
    the dense cache, also under preemption with sharing; grouping is
    refused silently where it cannot apply (no sharing)."""
    _, _, cfg, params = ref_model
    prompts = _header_prompts(13, 48, (9, 23, 5, 30))

    def run(**kw):
        eng = Engine(cfg, params, num_slots=4, max_seq=128,
                     prefill_chunk=16, device="cpu", **kw)
        return eng.run([(p, SamplingParams(max_new_tokens=6))
                        for p in prompts]), eng

    grouped = make_plan(backend, decode_group="grouped", fused_ffn=False,
                        group_threshold=1)
    plain = make_plan(backend, fused_ffn=False)
    base, _ = run(cache_kind="dense", plan=plain)
    paged = dict(cache_kind="paged", page_size=16)
    off, _ = run(plan=plain, prefix_sharing=True, **paged)
    on, eng = run(plan=grouped, prefix_sharing=True, **paged)
    assert off == base and on == base
    assert eng.stats.grouped_requests > 0
    assert eng.stats.prefix_kv_bytes_saved > 0
    alone, eng = run(plan=grouped, **paged)          # no sharing, no groups
    assert alone == base and eng.stats.grouped_requests == 0

    prompts2 = _header_prompts(17, 16, (9, 10))
    kw = dict(num_slots=2, max_seq=80, page_size=16, prefill_chunk=16,
              num_pages=5, cache_kind="paged", prefix_sharing=True,
              device="cpu")
    reqs = [(p, SamplingParams(max_new_tokens=26)) for p in prompts2]
    g = Engine(cfg, params, plan=grouped, **kw)
    u = Engine(cfg, params, plan=plain, **kw)
    assert g.run(list(reqs)) == u.run(list(reqs))
    assert g.stats.preemptions > 0 and g.stats.grouped_requests > 0
    g.slots.check()


def test_serve_cli_grouped_matches_off(capsys):
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--requests", "4", "--slots", "3",
            "--max-seq", "96", "--max-new", "4", "--prompt-len", "12",
            "--prefill-chunk", "16", "--cache-kind", "paged",
            "--page-size", "16", "--prefix-sharing", "--shared-prefix", "32"]
    outs = {}
    for mode in ("off", "grouped"):
        assert serve.main(base + ["--decode-group", mode]) == 0
        outs[mode] = capsys.readouterr().out
    reqs = {m: [ln for ln in o.splitlines() if ln.startswith("  req ")]
            for m, o in outs.items()}
    assert reqs["grouped"] == reqs["off"] and len(reqs["off"]) == 4
    assert "grouped decodes" in outs["grouped"]
    assert "prefix KV bytes saved" in outs["grouped"]
    assert "grouped decodes" not in outs["off"]
