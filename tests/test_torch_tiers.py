"""The port's tiered KV hierarchy (repro_torch.serving.{tiers, prefix,
blockpool, engine}) on the CPU.

  * The JAX package's tier tests (``tests/test_tiers.py``), ported: the
    store's capacity, LRU spill, disk round trip and true eviction; the
    prefix index's cross-tier lifecycle; the session-cache manager's
    retain -> reclaim / demote -> promote dataflow; and the engine's
    tokens through every tier, bitwise the never-demoted run's.
  * Parity against the JAX package: seeded random sequences of the same
    operations drive its TieredPool / PrefixIndex / PagedSlotManager and
    the port's, which must reach identical state (pages, hids, tiers,
    refcounts, LRU orders, stats); its Engine and the port's on smoke
    qwen2-0.5b (f32, its params carried across) give the same greedy
    tokens and tier counters over two rounds and a preempting pool.
  * One fault of the JAX package is repaired in the port and named here:
    a re-admission that finds the pool dry pins its matched session pages,
    its own reclaim drops their session refs, and its roll-back then
    frees them, discarding KV that was never demoted. The port gives the
    pin's ref back to the session cache. The parity tests hold the port
    to the JAX package with that one roll-back repaired
    (:func:`repair_reference_rollback`), and a test shows the fault.
  * Within the port: tokens bitwise across a tier round trip for bf16,
    int8 and fp8 pages (scale rows included), the disk tier's exact
    bytes for every leaf dtype, and a promotion that keeps every cache
    leaf's address under the looped granularity.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.serving.blockpool import BlockPool as JBlockPool
from repro.serving.blockpool import PagedSlotManager as JPagedSlotManager
from repro.serving.engine import Engine as JEngine
from repro.serving.prefix import PrefixIndex as JPrefixIndex
from repro.serving.request import SamplingParams as JSamplingParams
from repro.serving.tiers import TieredPool as JTieredPool
from repro_torch import configs
from repro_torch.kernels import quant
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import TieredPool as ExportedTieredPool
from repro_torch.serving.blockpool import BlockPool, PagedSlotManager
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix import PrefixIndex
from repro_torch.serving.request import SamplingParams
from repro_torch.serving.tiers import TieredPool

F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: under the
    suite's parallel workers, a pool of threads per process oversubscribes
    the cores and each parallel region waits on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# TieredPool store semantics (dummy slabs)
# ---------------------------------------------------------------------------


def _slab(tag):
    """A dummy page slab: content identity matters, structure does not."""
    return (torch.full((2, 4), float(tag)),
            torch.full((2, 4), -tag, dtype=torch.int32))


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_serving_package_exports_the_store():
    assert ExportedTieredPool is TieredPool


def test_tiered_pool_rejects_bad_capacities(tmp_path):
    with pytest.raises(ValueError, match=">= 0"):
        TieredPool(-1)
    with pytest.raises(ValueError, match="disk_dir"):
        TieredPool(4, disk_pages=2)          # disk capacity without a dir
    tp = TieredPool(2, disk_dir=str(tmp_path))
    assert tp.disk_pages == 0                # a dir alone is an unused tier


def test_host_tier_lru_spill_evicts_oldest():
    tp = TieredPool(2)
    a, b, c = tp.demote(_slab(1)), tp.demote(_slab(2)), tp.demote(_slab(3))
    assert tp.host_used == 2 and len(tp) == 2
    assert tp.ids() == {b, c}
    assert tp.stats.demoted == 3 and tp.stats.evicted == 1
    with pytest.raises(KeyError):
        tp.tier_of(a)
    tp.check()


def test_touch_refreshes_lru_recency():
    tp = TieredPool(2)
    a, _b = tp.demote(_slab(1)), tp.demote(_slab(2))
    tp.touch(a)
    c = tp.demote(_slab(3))                  # spills b, not a
    assert tp.ids() == {a, c}
    tp.check()


def test_zero_capacity_hierarchy_rejects_demotion():
    tp = TieredPool(0)
    assert tp.demote(_slab(1)) is None
    assert tp.stats.demoted == 0
    tp.check()


def test_disk_tier_round_trips_exact_bytes(tmp_path):
    tp = TieredPool(1, disk_dir=str(tmp_path), disk_pages=2)
    a = tp.demote(_slab(7))
    b = tp.demote(_slab(8))                  # spills a host -> disk
    assert tp.tier_of(a) == 2 and tp.tier_of(b) == 1
    assert tp.stats.disk_demotions == 1 and tp.stats.evicted == 0
    tp.check()
    assert _same(tp.pop(a), _slab(7))
    assert tp.disk_used == 0 and not list(tmp_path.iterdir())
    assert tp.stats.promoted == 1
    tp.check()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float8_e4m3fn",
                                   "float32"])
def test_disk_tier_round_trips_every_leaf_dtype(tmp_path, dtype):
    """A slab leaf comes back off disk with its dtype and every bit, also
    when it is a view into a larger batch buffer (the engine's slabs
    are), and the file holds only the page, not the buffer."""
    dt = getattr(torch, dtype)
    if dt == torch.float8_e4m3fn and not quant.fp8_supported():
        pytest.skip("this torch stores no float8_e4m3fn")
    g = torch.Generator().manual_seed(3)
    bits = torch.randint(0, 256, (2, 64, 4, 2, 8), generator=g,
                         dtype=torch.uint8)
    if dt.itemsize == 1:
        batch = bits.view(dt)
    else:
        batch = torch.randn((2, 64, 4, 2, 8), generator=g).to(dt)
    slab = (batch[:, 5], batch[:, 9])        # views, as the engine's
    tp = TieredPool(1, disk_dir=str(tmp_path), disk_pages=2)
    a = tp.demote(slab)
    tp.demote(_slab(1))                      # spills a to disk
    assert tp.tier_of(a) == 2
    (path,) = tmp_path.iterdir()
    assert path.stat().st_size < batch.nbytes // 4
    got = tp.pop(a)
    for x, y in zip(got, slab):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.contiguous().view(torch.uint8),
                           y.contiguous().view(torch.uint8))
    tp.check()


def test_quantized_slab_disk_round_trip_bitwise(tmp_path):
    """Quantized pages demote as (codes, codes, steps, steps); the disk
    tier returns every leaf bit for bit with its dtype."""
    def qslab(seed):
        g = torch.Generator().manual_seed(seed)
        return (torch.randint(-127, 128, (2, 4, 2, 8), generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (2, 4, 2, 8), generator=g,
                              dtype=torch.int8),
                torch.rand((2, 2), generator=g),
                torch.rand((2, 2), generator=g))
    tp = TieredPool(1, disk_dir=str(tmp_path), disk_pages=2)
    a = tp.demote(qslab(7))
    tp.demote(qslab(8))
    assert tp.tier_of(a) == 2
    assert _same(tp.pop(a), qslab(7))
    tp.check()


def test_disk_tier_full_evicts_oldest_file(tmp_path):
    tp = TieredPool(1, disk_dir=str(tmp_path), disk_pages=1)
    tp.demote(_slab(1))
    b = tp.demote(_slab(2))                  # a -> disk
    c = tp.demote(_slab(3))                  # b -> disk, a falls off
    assert tp.ids() == {b, c}
    assert tp.stats.evicted == 1
    assert len(list(tmp_path.iterdir())) == 1
    tp.check()


def test_pop_and_drop_from_either_tier(tmp_path):
    tp = TieredPool(1, disk_dir=str(tmp_path), disk_pages=4)
    a = tp.demote(_slab(1))
    b = tp.demote(_slab(2))                  # a spilled to disk
    assert tp.pop(b) is not None
    tp.drop(a)                               # file removed
    assert len(tp) == 0 and not list(tmp_path.iterdir())
    assert tp.stats.promoted == 1            # a drop is no promotion
    with pytest.raises(KeyError):
        tp.pop(a)
    tp.check()


def test_tiers_module_touches_no_device():
    """The store is host memory and files: importing it pulls in no
    device module of the port."""
    import subprocess
    code = ("import sys; import repro_torch.serving.tiers; "
            "bad = [m for m in sys.modules if m.startswith('repro_torch.') "
            "and m.split('.')[1] in ('kernels', 'models')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


# ---------------------------------------------------------------------------
# Cross-tier PrefixIndex lifecycle
# ---------------------------------------------------------------------------


def test_index_entry_survives_demotion_and_promotes_back():
    ix = PrefixIndex(page_size=2)
    ix.register([1, 2, 3, 4], pages=[5, 6])
    ix.commit([1, 2, 3, 4])
    assert ix.demote_page(6, hid=0)
    m = ix.match([1, 2, 3, 4])
    assert m.pages == [5, -1]                # demoted placeholder
    assert m.tiers == [0, 1] and m.hids == [None, 0]
    ix.check(live_pages={5}, live_hids={0})
    ix.promote_hid(0, page=9)
    m = ix.match([1, 2, 3, 4])
    assert m.pages == [5, 9] and m.tiers == [0, 0]
    ix.check(live_pages={5, 9})


def test_index_demote_unindexed_page_is_noop():
    ix = PrefixIndex(page_size=2)
    assert not ix.demote_page(3, hid=0)
    assert ix.demoted_ids() == set()


def test_index_set_tier_and_rebind_track_store_moves():
    ix = PrefixIndex(page_size=2)
    ix.register([1, 2], pages=[4])
    ix.commit([1, 2])
    ix.demote_page(4, hid=0)
    ix.set_tier(0, 2)
    assert ix.match([1, 2]).tiers == [2]
    ix.rebind_hid(0, 5)
    assert ix.match([1, 2]).hids == [5]
    ix.check(live_pages=set(), live_hids={5})


def test_index_purges_only_on_true_eviction():
    ix = PrefixIndex(page_size=2)
    ix.register([1, 2], pages=[4])
    ix.commit([1, 2])
    ix.demote_page(4, hid=0)
    assert len(ix.match([1, 2])) == 1
    ix.purge_hid(0)
    assert ix.match([1, 2]).pages == []
    assert len(ix) == 0
    ix.check(live_pages=set())


def test_index_check_catches_a_dangling_hid():
    ix = PrefixIndex(page_size=2)
    ix.register([1, 2], pages=[4])
    ix.commit([1, 2])
    ix.demote_page(4, hid=3)
    with pytest.raises(AssertionError, match="evicted hid"):
        ix.check(live_pages=set(), live_hids=set())


# ---------------------------------------------------------------------------
# Session-cache manager dataflow (dummy gather)
# ---------------------------------------------------------------------------


def _gather(pages):
    return {p: ("slab", p) for p in pages}


def _tiered_mgr(num_pages=8, page_size=4, host_pages=8):
    pool = BlockPool(num_pages, page_size)
    ix = PrefixIndex(page_size)
    tiers = TieredPool(host_pages, index=ix)
    mgr = PagedSlotManager(3, 32, pool, prefix_index=ix, tiers=tiers)
    return mgr, pool, tiers


def test_tiers_require_prefix_index():
    with pytest.raises(ValueError, match="prefix index"):
        PagedSlotManager(2, 32, BlockPool(8, 4), tiers=TieredPool(4))


def test_retain_session_transfers_refs_instead_of_freeing():
    mgr, pool, _ = _tiered_mgr()
    toks = np.arange(100, 109, dtype=np.int32)          # 2 full pages
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    full = mgr.slots[idx].pages[:2]
    assert mgr.retain_session(idx, toks) == 2
    assert mgr.slots[idx].free
    assert all(pool.refcount(p) == 1 for p in full)
    assert mgr.session_pages() == 2
    assert mgr.prefix.match(toks).pages == full
    mgr.check()


def test_session_rehit_maps_pages_without_copies():
    mgr, pool, tiers = _tiered_mgr()
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    idx2 = mgr.try_assign(1, 9, 4, tokens=toks)
    s = mgr.slots[idx2]
    assert s.shared_len == 8 and s.session_mapped == 2
    assert not s.pending_promotions
    assert tiers.stats.demoted == 0
    mgr.check()


def test_reclaim_session_demotes_dying_pages_and_keeps_index():
    mgr, pool, tiers = _tiered_mgr()
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    assert mgr.reclaim_session(1, _gather) == 1
    assert mgr.session_pages() == 1 and tiers.stats.demoted == 1
    assert mgr.prefix.match(toks).tiers == [1, 0]
    mgr.check()
    assert mgr.reclaim_session(10, _gather) == 1
    assert mgr.session_pages() == 0 and pool.used_pages == 0
    assert mgr.prefix.match(toks).tiers == [1, 1]
    mgr.check()


def test_reclaim_spares_pages_shared_with_live_slots():
    mgr, pool, _ = _tiered_mgr()
    toks = np.arange(100, 109, dtype=np.int32)
    a = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(a, toks)
    b = mgr.try_assign(1, 9, 4, tokens=toks)
    mgr.retain_session(a, toks)
    shared = mgr.slots[b].pages[:2]
    mgr.reclaim_session(10, _gather)
    assert all(pool.refcount(p) == 1 for p in shared)
    assert mgr.prefix.match(toks).tiers == [0, 0]
    mgr.check()


def test_returning_admission_promotes_demoted_span():
    mgr, pool, tiers = _tiered_mgr()
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    mgr.reclaim_session(10, _gather)
    idx2 = mgr.try_assign(1, 9, 4, tokens=toks)
    s = mgr.slots[idx2]
    assert s.shared_len == 8 and len(s.pending_promotions) == 2
    assert tiers.stats.promoted == 2 and len(tiers) == 0
    m = mgr.prefix.match(toks)
    assert m.tiers == [0, 0]
    assert m.pages == [dst for _slab, dst in s.pending_promotions]
    mgr.check()


def test_promoted_tail_needs_no_fork():
    """A fully covered prompt whose last page is promoted re-runs its
    final chunk in place: the fresh page is private already."""
    mgr, pool, tiers = _tiered_mgr()
    toks = np.arange(100, 108, dtype=np.int32)          # exactly 2 pages
    idx = mgr.try_assign(0, 8, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    mgr.reclaim_session(10, _gather)
    s = mgr.slots[mgr.try_assign(1, 8, 4, tokens=toks)]
    assert s.pending_fork is None and len(s.pending_promotions) == 2
    assert s.shared_len == 8 and s.prefill_start == 8
    mgr.check()


def test_swap_threshold_truncates_match_at_first_demoted_entry():
    mgr, pool, tiers = _tiered_mgr()
    mgr.swap_threshold = 64
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    mgr.reclaim_session(1, _gather)
    s = mgr.slots[mgr.try_assign(1, 9, 4, tokens=toks)]
    assert s.shared_len == 0 and not s.pending_promotions
    assert tiers.stats.promoted == 0
    mgr.check()


def test_dry_admission_reclaims_session_via_callback():
    mgr, pool, tiers = _tiered_mgr(num_pages=4)
    mgr.reclaim_cb = lambda need: mgr.reclaim_session(need, _gather) >= need
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    other = np.arange(200, 212, dtype=np.int32)
    assert mgr.try_assign(1, 12, 4, tokens=other) is not None
    assert tiers.stats.demoted == 2
    assert mgr.session_pages() == 0
    mgr.check()


def test_dry_admission_rolls_back_pins_and_slabs():
    """An admission that finds the pool dry even after reclaim leaves
    refcounts as they were and puts its popped slabs back, their entries
    rebound to the new handles."""
    mgr, pool, tiers = _tiered_mgr(num_pages=4, host_pages=4)
    toks = np.arange(100, 109, dtype=np.int32)
    idx = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(idx, toks)
    mgr.retain_session(idx, toks)
    mgr.reclaim_session(10, _gather)                     # both demoted
    hog = mgr.try_assign(1, 12, 4, tokens=np.arange(300, 312,
                                                    dtype=np.int32))
    assert hog is not None and pool.free_pages == 0
    before = sorted(tiers.ids())
    assert mgr.try_assign(2, 9, 4, tokens=toks) is None
    assert len(tiers.ids()) == 2 and sorted(tiers.ids()) != before
    assert mgr.prefix.match(toks).tiers == [1, 1]
    mgr.check()


# ---------------------------------------------------------------------------
# Parity with the JAX package: identical state under the same operations
# ---------------------------------------------------------------------------


def _np_slab(tag):
    return (np.full((2, 4), tag, np.float32),)


def _store_state(tp):
    return (list(tp._host), list(tp._disk), dataclasses.asdict(tp.stats),
            tp._next_hid)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("disk", [0, 3], ids=["host", "host+disk"])
def test_store_matches_reference_under_random_ops(tmp_path, seed, disk):
    rng = np.random.default_rng(seed)
    kw = dict(disk_pages=disk)
    ref = JTieredPool(3, disk_dir=str(tmp_path / "ref") if disk else None,
                      **kw)
    got = TieredPool(3, disk_dir=str(tmp_path / "port") if disk else None,
                     **kw)
    tag = 0
    for _ in range(60):
        op = rng.choice(["demote", "demote", "pop", "touch", "drop"])
        live = sorted(ref.ids())
        if op == "demote" or not live:
            tag += 1
            assert ref.demote(_np_slab(tag)) == got.demote(
                (torch.full((2, 4), float(tag)),))
        else:
            hid = int(rng.choice(live))
            if op == "pop":
                want, have = ref.pop(hid), got.pop(hid)
                np.testing.assert_array_equal(have[0].numpy(), want[0])
            elif op == "touch":
                ref.touch(hid)
                got.touch(hid)
            else:
                ref.drop(hid)
                got.drop(hid)
        assert _store_state(got) == _store_state(ref)
        ref.check()
        got.check()


def repair_reference_rollback(mgr):
    """Give a JAX-package slot manager the port's roll-back: when an
    admission's allocation fails even after reclaim, the session pages it
    pinned whose session ref that reclaim dropped go back to the session
    cache (one ref moved from the pin) instead of being freed by the
    roll-back. The manager's own methods are wrapped, nothing in the
    package is edited: ``pool.share`` (called only by ``_make_slot``,
    just before its allocation) records the pins."""
    pins = []
    share, alloc = mgr.pool.share, mgr._alloc_reclaiming

    def recording_share(pages):
        pins[:] = list(pages)
        return share(pages)

    def repaired_alloc(n):
        held = [p for p in pins if p in mgr._session]
        pins.clear()
        got = alloc(n)
        if got is None:
            back = [p for p in held if p not in mgr._session]
            for p in back:
                mgr._session[p] = None
            share(back)                  # the roll-back frees these refs
        return got

    mgr.pool.share = recording_share
    mgr._alloc_reclaiming = repaired_alloc


def test_reference_fault_dry_readmission_discards_session_kv():
    """A preempted sequence's pages sit in the session cache; its
    re-admission finds the pool dry, pins them, and its own reclaim
    drops their session refs. The JAX package's roll-back then frees
    them: the KV is gone (never demoted) and the prefix stops matching.
    The port keeps them in the session cache, still matchable."""
    toks = np.arange(100, 113, dtype=np.int32)          # 3 full pages
    other = np.arange(300, 316, dtype=np.int32)         # 5 pages with growth
    kept = {}
    for name, (Pool, Index, Tiers, Mgr) in (
            ("ref", (JBlockPool, JPrefixIndex, JTieredPool,
                     JPagedSlotManager)),
            ("port", (BlockPool, PrefixIndex, TieredPool, PagedSlotManager))):
        ix = Index(4)
        mgr = Mgr(2, 32, Pool(8, 4), prefix_index=ix,
                  tiers=Tiers(8, index=ix))
        mgr.reclaim_cb = lambda need, m=mgr: m.reclaim_session(
            need, _gather) >= need
        a = mgr.try_assign(0, 13, 3, tokens=toks)
        mgr.commit_prefix(a, toks)
        mgr.retain_session(a, toks[:12])                # preempted: 3 pages
        hog = mgr.try_assign(1, 16, 1, tokens=other)    # takes the rest
        assert hog is not None and mgr.pool.free_pages == 0
        assert mgr.try_assign(2, 13, 3, tokens=toks) is None
        kept[name] = (mgr.session_pages(), len(mgr.prefix.match(toks)),
                      mgr.tiers.stats.demoted)
        mgr.check()
    assert kept["ref"] == (0, 0, 0)        # KV discarded, nothing demoted
    assert kept["port"] == (3, 3, 0)       # still cached at tier 0


def _mgr_pair(num_pages, page_size, host_pages, disk_pages, tmp_path):
    out = []
    for tag, (Pool, Index, Tiers, Mgr) in (
            ("ref", (JBlockPool, JPrefixIndex, JTieredPool,
                     JPagedSlotManager)),
            ("port", (BlockPool, PrefixIndex, TieredPool, PagedSlotManager))):
        ix = Index(page_size)
        tiers = Tiers(host_pages, index=ix, disk_pages=disk_pages,
                      disk_dir=str(tmp_path / tag) if disk_pages else None)
        mgr = Mgr(3, 64, Pool(num_pages, page_size), prefix_index=ix,
                  tiers=tiers)
        mgr.reclaim_cb = (lambda m: lambda need: m.reclaim_session(
            need, _gather) >= need)(mgr)
        if tag == "ref":
            repair_reference_rollback(mgr)
        out.append(mgr)
    return out


def _mgr_state(mgr):
    """Everything the tier machinery decides, in comparable form."""
    slots = [(s.free, s.request_id, s.length, list(s.pages), s.shared_len,
              s.prefill_start, s.prefill_level, s.pending_fork,
              s.session_mapped) for s in mgr.slots]
    pool = (list(mgr.pool._free), dict(mgr.pool._ref))
    ix = mgr.prefix
    entries = sorted((k[0], e.page, e.tier, e.hid, e.pending_level)
                     for k, e in ix._entries.items())
    return (slots, pool, list(mgr._session), entries,
            sorted(ix._by_hid), _store_state(mgr.tiers), ix.hits, ix.misses)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tier_kw", [dict(host_pages=4, disk_pages=0),
                                     dict(host_pages=2, disk_pages=3),
                                     dict(host_pages=0, disk_pages=0)],
                         ids=["host", "host+disk", "none"])
def test_manager_matches_reference_under_random_ops(tmp_path, seed,
                                                    tier_kw):
    """Admit (with promotions), decode growth with COW forks, retain,
    release, reclaim and swap-threshold changes, drawn from a seed, on
    prompts that share page-aligned headers: the port's manager reaches
    the JAX package's state after every operation."""
    rng = np.random.default_rng(seed)
    ps = 4
    ref, got = _mgr_pair(14, ps, tmp_path=tmp_path, **tier_kw)
    headers = [rng.integers(1, 50, size=8) for _ in range(2)]
    convo = {}                    # rid -> token history (prompt + decode)
    rid = 0
    for _ in range(80):
        op = rng.choice(["admit", "admit", "grow", "grow", "grow",
                         "retain", "release", "reclaim", "threshold"])
        busy = [i for i, s in enumerate(ref.slots) if not s.free]
        if op == "admit":
            if convo and rng.random() < 0.5:
                toks = convo[int(rng.choice(sorted(convo)))]
            else:
                h = headers[int(rng.integers(2))]
                toks = np.concatenate([h, rng.integers(
                    1, 50, size=int(rng.integers(1, 9)))])
            toks = np.asarray(toks, np.int32)[:48]
            max_new = int(rng.integers(1, 6))
            a = ref.try_assign(rid, len(toks), max_new, tokens=toks)
            b = got.try_assign(rid, len(toks), max_new, tokens=toks)
            assert a == b
            if a is not None:
                for m in (ref, got):
                    s = m.slots[a]
                    s.pending_promotions_seen = [
                        (slab, dst) for slab, dst in s.pending_promotions]
                assert (got.slots[a].pending_promotions_seen
                        == ref.slots[a].pending_promotions_seen)
                for m in (ref, got):
                    m.slots[a].pending_promotions = []
                    m.commit_prefix(a, toks)
                convo[rid] = toks
            rid += 1
        elif op == "grow" and busy:
            i = int(rng.choice(busy))
            length = ref.slots[i].length
            outs = []
            for m in (ref, got):
                ok = m.ensure(i, length + 1)
                forks = m.fork_for_write(i, length, length + 1) if ok \
                    else None
                outs.append((ok, forks))
                if forks is not None:
                    m.tick(i)
            assert outs[0] == outs[1]
            if outs[0][1] is not None:
                r = ref.slots[i].request_id
                convo[r] = np.append(convo[r], rng.integers(1, 50)).astype(
                    np.int32)
        elif op == "retain" and busy:
            i = int(rng.choice(busy))
            r = ref.slots[i].request_id
            n = ref.slots[i].length
            toks = convo[r][:n]
            assert ref.retain_session(i, toks) == got.retain_session(i, toks)
        elif op == "release" and busy:
            i = int(rng.choice(busy))
            ref.release(i)
            got.release(i)
        elif op == "reclaim":
            n = int(rng.integers(1, 4))
            assert (ref.reclaim_session(n, _gather)
                    == got.reclaim_session(n, _gather))
        elif op == "threshold":
            t = int(rng.integers(1, 4))
            ref.swap_threshold = got.swap_threshold = t
        assert _mgr_state(got) == _mgr_state(ref), op
        ref.check()
        got.check()


# ---------------------------------------------------------------------------
# Engines: the JAX package's against the port's (f32, its params)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_model():
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get("qwen2-0.5b")),
                               **F32)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(configs.smoke(configs.get("qwen2-0.5b")),
                               **F32)
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


_TIER_COUNTERS = ("demoted_pages", "promoted_pages", "session_hits",
                  "host_evicted_pages", "preemptions", "shared_prefix_pages",
                  "saved_prefill_tokens", "cow_forks", "peak_pages_used")


def _kw(**over):
    kw = dict(num_slots=4, max_seq=256, prefill_chunk=16, page_size=16,
              cache_kind="paged", prefix_sharing=True)
    kw.update(over)
    return kw


def _prompts(seed, n=3, plen=40, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=plen).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("case", ["two_rounds_flush", "two_rounds_tier0",
                                  "preempting_pool", "disk"])
def test_engine_matches_reference_through_tiers(ref_model, tmp_path, case):
    jcfg, jparams, tcfg, tparams = ref_model
    if case == "preempting_pool":
        rng = np.random.default_rng(23)
        prompts = [rng.integers(1, 500, size=40).astype(np.int32)
                   for _ in range(4)]
        budget, kw, rounds = 40, _kw(num_pages=9, host_pages=64), 1
    elif case == "disk":
        prompts, budget, rounds = _prompts(29, n=2), 6, 2
        kw = _kw(host_pages=2, disk_pages=16)
    else:
        prompts, budget, rounds = _prompts(17), 6, 2
        kw = _kw(host_pages=64)
    jkw, tkw = dict(kw), dict(kw)
    if case == "disk":
        jkw["disk_dir"] = str(tmp_path / "ref")
        tkw["disk_dir"] = str(tmp_path / "port")
    jeng = JEngine(jcfg, jparams, **jkw)
    repair_reference_rollback(jeng.slots)
    teng = Engine(tcfg, tparams, device="cpu", **tkw)
    for rnd in range(rounds):
        want = jeng.run([(p, JSamplingParams(max_new_tokens=budget))
                         for p in prompts], max_ticks=3000)
        got = teng.run([(p, SamplingParams(max_new_tokens=budget))
                        for p in prompts], max_ticks=3000)
        assert got == want, f"round {rnd}"
        for f in _TIER_COUNTERS:
            assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
        if rnd + 1 < rounds:
            flush = case != "two_rounds_tier0"
            assert (jeng.evict_finished(flush=flush)
                    == teng.evict_finished(flush=flush))
    st = teng.stats
    if case == "preempting_pool":
        assert st.preemptions > 0 and st.demoted_pages > 0
    elif case == "two_rounds_tier0":
        assert st.session_hits > 0 and st.promoted_pages == 0
    else:
        assert st.demoted_pages > 0 and st.promoted_pages > 0
        assert st.session_hits > 0
    if case == "disk":
        assert teng.tiers.stats.disk_demotions > 0
    assert (dataclasses.asdict(teng.tiers.stats)
            == dataclasses.asdict(jeng.tiers.stats))
    teng.slots.check()


# ---------------------------------------------------------------------------
# Within the port: resume / returning bitwise through every tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_model():
    cfg = configs.smoke(configs.get("qwen2-0.5b"))
    gen = torch.Generator().manual_seed(0)
    return cfg, get_model(cfg).init_params(gen, device="cpu")


def _engine(cfg, params, **kw):
    return Engine(cfg, params, device="cpu", **_kw(**kw))


def _reqs(cfg, n=3, plen=40, max_new=6, seed=17):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32),
             SamplingParams(max_new_tokens=max_new)) for _ in range(n)]


def _toks(out):
    """Outputs in submission order: rids keep counting across runs on one
    engine, so dicts of two runs never compare key for key."""
    return [out[k] for k in sorted(out)]


def test_engine_rejects_tiered_misconfig(smoke_model):
    cfg, params = smoke_model
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, cache_kind="dense", host_pages=8, device="cpu")
    with pytest.raises(ValueError, match="prefix_sharing"):
        Engine(cfg, params, cache_kind="paged", host_pages=8,
               prefix_sharing=False, device="cpu")


def test_engine_reads_swap_threshold_from_plan(smoke_model):
    from repro_torch.core.plan import make_plan
    cfg, params = smoke_model
    eng = _engine(cfg, params, host_pages=8,
                  plan=make_plan("cuda", swap_threshold=5))
    assert eng.slots.swap_threshold == 5
    assert eng.slots.reclaim_cb == eng._reclaim_session


def test_returning_conversation_promotes_and_matches(smoke_model):
    cfg, params = smoke_model
    reqs = _reqs(cfg)
    out_base = _toks(_engine(cfg, params).run(list(reqs)))
    dense = Engine(cfg, params, cache_kind="dense", num_slots=4,
                   max_seq=256, prefill_chunk=16, device="cpu")
    assert _toks(dense.run(list(reqs))) == out_base
    eng = _engine(cfg, params, host_pages=64)
    assert _toks(eng.run(list(reqs))) == out_base
    eng.evict_finished(flush=True)
    assert eng.tiers.host_used > 0 and eng.pool.used_pages == 0
    assert _toks(eng.run(list(reqs))) == out_base
    assert eng.stats.promoted_pages > 0 and eng.stats.demoted_pages > 0
    assert eng.stats.saved_prefill_tokens > 0
    eng.slots.check()


def test_tier0_session_rehit_skips_prefill_without_copies(smoke_model):
    cfg, params = smoke_model
    reqs = _reqs(cfg, seed=19)
    out = _toks(_engine(cfg, params).run(list(reqs)))
    eng = _engine(cfg, params, host_pages=64)
    eng.run(list(reqs))
    eng.evict_finished()
    assert eng.slots.session_pages() > 0
    assert _toks(eng.run(list(reqs))) == out
    assert eng.stats.session_hits > 0 and eng.stats.promoted_pages == 0
    eng.slots.check()


def test_preempted_resume_identical_through_tiers(smoke_model):
    cfg, params = smoke_model
    rng = np.random.default_rng(23)
    sp = SamplingParams(max_new_tokens=40)
    reqs = [(rng.integers(1, cfg.vocab_size, size=40).astype(np.int32), sp)
            for _ in range(4)]
    out_big = _toks(_engine(cfg, params, num_pages=64).run(
        list(reqs), max_ticks=3000))
    tight = _engine(cfg, params, num_pages=9)
    assert _toks(tight.run(list(reqs), max_ticks=3000)) == out_big
    assert tight.stats.preemptions > 0
    tiers = _engine(cfg, params, num_pages=9, host_pages=64)
    assert _toks(tiers.run(list(reqs), max_ticks=3000)) == out_big
    assert tiers.stats.preemptions > 0 and tiers.stats.demoted_pages > 0
    tiers.slots.check()
    tiers.evict_finished(flush=True)
    assert tiers.pool.used_pages == 0


def test_disk_tier_resume_identical(smoke_model, tmp_path):
    cfg, params = smoke_model
    reqs = _reqs(cfg, n=2, seed=29)
    out = _toks(_engine(cfg, params).run(list(reqs)))
    eng = _engine(cfg, params, host_pages=2, disk_dir=str(tmp_path),
                  disk_pages=16)
    eng.run(list(reqs))
    eng.evict_finished(flush=True)
    assert eng.tiers.stats.disk_demotions > 0
    assert _toks(eng.run(list(reqs))) == out
    eng.slots.check()


def test_host_tier_holds_only_its_pages_storage(smoke_model, tmp_path):
    """A flush of more pages than the host tier holds spills the rest to
    disk; each slab the host keeps owns only its own page's storage, so
    ``host_pages`` bounds host memory however large the gather batch."""
    cfg, params = smoke_model
    eng = _engine(cfg, params, host_pages=2, disk_dir=str(tmp_path),
                  disk_pages=32)
    eng.run(_reqs(cfg, n=3, seed=43))
    eng.evict_finished(flush=True)
    assert eng.stats.demoted_pages > eng.tiers.host_pages
    assert eng.tiers.stats.disk_demotions > 0
    page_bytes = [leaf[:, 0].numel() * leaf.element_size()
                  for leaf in eng.cache.values()]
    kept = list(eng.tiers._host.values())
    assert len(kept) == eng.tiers.host_pages
    for slab in kept:
        assert [a.untyped_storage().nbytes() for a in slab] == page_bytes


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_pages_demote_promote_bitwise(smoke_model, tmp_path, kv_dtype):
    """Pages flushed through the host and disk tiers come back with every
    bit of every leaf (codes and f32 step rows when quantized), and the
    tokens match a never-demoted engine's."""
    if kv_dtype == "fp8" and not quant.fp8_supported():
        pytest.skip("this torch stores no float8_e4m3fn")
    cfg, params = smoke_model
    reqs = _reqs(cfg, n=2, seed=43)
    out = _toks(_engine(cfg, params, kv_dtype=kv_dtype).run(list(reqs)))
    eng = _engine(cfg, params, kv_dtype=kv_dtype, host_pages=2,
                  disk_dir=str(tmp_path), disk_pages=16)
    assert _toks(eng.run(list(reqs))) == out

    def snapshot():
        ent = eng.prefix._entries
        keys = sorted(k for k in ent if ent[k].page is not None)
        pages = [ent[k].page for k in keys]
        slabs = eng._gather_pages(pages)
        return {k: slabs[p] for k, p in zip(keys, pages)}

    before = snapshot()
    assert before
    leaves = next(iter(before.values()))
    assert len(leaves) == len(eng.cache)
    if kv_dtype != "bf16":
        assert {t.dtype for t in leaves} == {
            quant.spec_for(kv_dtype).code_dtype, torch.float32}
    eng.evict_finished(flush=True)
    assert eng.tiers.stats.disk_demotions > 0
    assert _toks(eng.run(list(reqs))) == out
    assert eng.stats.promoted_pages > 0
    after = snapshot()
    assert sorted(after) == sorted(before)
    for k in before:
        for g, w in zip(after[k], before[k]):
            assert g.dtype == w.dtype
            assert torch.equal(g.contiguous().view(torch.uint8),
                               w.contiguous().view(torch.uint8))
    eng.slots.check()


def test_eviction_fallback_reprefills_identically(smoke_model):
    cfg, params = smoke_model
    reqs = _reqs(cfg, n=2, seed=31)
    out = _toks(_engine(cfg, params).run(list(reqs)))
    eng = _engine(cfg, params, host_pages=1)
    eng.run(list(reqs))
    eng.evict_finished(flush=True)
    assert eng.stats.host_evicted_pages > 0
    assert _toks(eng.run(list(reqs))) == out
    eng.slots.check()


def test_session_cache_off_frees_on_retire(smoke_model):
    cfg, params = smoke_model
    reqs = _reqs(cfg, n=2, seed=37)
    out = _toks(_engine(cfg, params).run(list(reqs)))
    eng = _engine(cfg, params, host_pages=64, session_cache=False)
    eng.run(list(reqs))
    eng.evict_finished()
    assert eng.slots.session_pages() == 0 and eng.pool.used_pages == 0
    assert _toks(eng.run(list(reqs))) == out
    assert eng.stats.session_hits == 0


def test_flush_sessions_accounts_stats(smoke_model):
    cfg, params = smoke_model
    eng = _engine(cfg, params, host_pages=64)
    eng.run(_reqs(cfg, n=2, seed=41))
    cached = eng.slots.session_pages()
    assert cached > 0
    assert eng.flush_sessions() == cached
    assert eng.stats.demoted_pages == cached
    assert eng.slots.session_pages() == 0 and eng.pool.used_pages == 0
    eng.slots.check()


def test_evict_refuses_unfinished_and_keeps_kv(smoke_model):
    cfg, params = smoke_model
    eng = _engine(cfg, params, host_pages=8)
    (p, sp), = _reqs(cfg, n=1, seed=47)
    rid = eng.submit(p, sp)
    with pytest.raises(ValueError, match="not finished"):
        eng.evict(rid)
    while not eng.requests[rid].finished:
        eng.step()
    toks = list(eng.requests[rid].tokens)
    assert eng.evict(rid) == toks and rid not in eng.requests
    assert eng.slots.session_pages() > 0


def test_looped_promotion_keeps_cache_addresses(smoke_model):
    """A promotion writes the slabs into the existing cache leaves in
    place: the looped decode keys its graphs on the leaves' addresses,
    so a rebound leaf would silently force new captures."""
    cfg, params = smoke_model
    reqs = _reqs(cfg, n=2, seed=53)
    eng = _engine(cfg, params, host_pages=64, decode_fusion="looped",
                  kv_dtype="int8")
    ptrs = {k: t.data_ptr() for k, t in eng.cache.items()}
    out = _toks(eng.run(list(reqs)))
    eng.evict_finished(flush=True)
    assert _toks(eng.run(list(reqs))) == out
    assert eng.stats.promoted_pages > 0
    assert {k: t.data_ptr() for k, t in eng.cache.items()} == ptrs


def test_refresh_sets_persistable_len(smoke_model):
    cfg, params = smoke_model
    eng = _engine(cfg, params, host_pages=8)
    (p, sp), = _reqs(cfg, n=1, seed=59, max_new=20)
    eng.submit(p, sp)
    for _ in range(4):
        eng.step()
    eng._refresh_shared_lens()
    (state,) = eng.by_slot.values()
    length = eng.slots.slots[state.slot].length
    assert state.persistable_len == (length // 16) * 16 > 0
    assert state.resume_cost == state.total_len - state.persistable_len
