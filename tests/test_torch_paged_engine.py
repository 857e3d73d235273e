"""The port's paged serving path (repro_torch.serving.{blockpool, prefix,
engine} and the paged model steps) on the CPU.

  * Parity: the port's paged Engine against the JAX package's paged Engine
    in f32 at smoke size (the reference's ``init_params(PRNGKey(0))``
    carried across), gather and fused chunk modes, with and without prefix
    sharing, and under preemption: identical greedy tokens, ticks, finish
    reasons and page bookkeeping.
  * The contracts the JAX package proves, re-proved inside the port:
    dense = gather = fused and sharing on = off. On the ``"torch"`` plan
    (gather + reference math, the role of JAX's ``"xla"``) they hold
    bitwise, as in the JAX package; on the ``"cuda"`` plan (the kernels'
    plain versions here) greedy tokens must agree in f32.
  * The host-side page machinery (BlockPool, PrefixIndex, PagedSlotManager
    and its copy-on-write forks), ported from ``tests/test_blockpool.py``
    and ``tests/test_prefix.py``.
  * The sync-free masked KV write that both layouts share.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.plan import make_plan as jmake_plan
from repro.models.api import get_model as jget_model
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.core.plan import PagedPlan, PlanError, make_plan
from repro_torch.models import layers as L
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout, PagedLayout, pages_for
from repro_torch.serving.blockpool import BlockPool, PagedSlotManager
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix import PrefixIndex
from repro_torch.serving.request import SamplingParams

ARCH = "qwen2-0.5b"
F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(scope="module")
def ref_model():
    """JAX cfg + params and the port's f32 cfg + the same params."""
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


# ---------------------------------------------------------------------------
# Port vs JAX: paged engines, both chunk modes
# ---------------------------------------------------------------------------


_WORKLOADS = {
    # 5 requests through 2 slots: waves, page recycling, a shared header
    "waves": dict(prompts=(11, 32, (3, 19, 8, 27, 12)),
                  budgets=[6, 3, 9, 1, 5],
                  kw=dict(num_slots=2, max_seq=128, page_size=16,
                          prefill_chunk=16)),
    # a 5-page pool: with the header shared both requests are admitted
    # and one is preempted mid-decode; without sharing the second waits
    "preempt": dict(prompts=(7, 16, (9, 10)), budgets=[26, 26],
                    kw=dict(num_slots=2, max_seq=80, page_size=16,
                            prefill_chunk=16, num_pages=5)),
}


@pytest.mark.parametrize("sharing", [False, True], ids=["private", "shared"])
@pytest.mark.parametrize("mode", ["dense", "fused"])
@pytest.mark.parametrize("workload", ["waves", "preempt"])
def test_paged_engine_matches_reference(ref_model, workload, mode, sharing):
    jcfg, jparams, tcfg, tparams = ref_model
    w = _WORKLOADS[workload]
    prompts = _header_prompts(*w["prompts"])
    jeng = JEngine(jcfg, jparams, cache_kind="paged", prefix_sharing=sharing,
                   plan=jmake_plan(gather_chunk=mode, fused_threshold=1),
                   **w["kw"])
    want = jeng.run([(p, JSamplingParams(max_new_tokens=m))
                     for p, m in zip(prompts, w["budgets"])])
    teng = Engine(tcfg, tparams, cache_kind="paged", prefix_sharing=sharing,
                  plan=make_plan("cuda", gather_chunk=mode,
                                 fused_threshold=1, fused_ffn=False),
                  device="cpu", **w["kw"])
    got = teng.run([(p, SamplingParams(max_new_tokens=m))
                    for p, m in zip(prompts, w["budgets"])])
    assert got == want
    assert teng.ticks == jeng.ticks
    for rid in want:
        assert (teng.finish_reason(rid).value
                == jeng.finish_reason(rid).value)
    for field in ("preemptions", "peak_pages_used", "shared_prefix_pages",
                  "saved_prefill_tokens", "cow_forks"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    if workload == "preempt" and sharing:
        assert teng.stats.preemptions > 0
    teng.slots.check()
    assert teng.pool.used_pages == 0


# ---------------------------------------------------------------------------
# Within the port: dense = gather = fused, sharing on = off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_identity_dense_gather_fused(ref_model, backend):
    """Greedy tokens are identical across the dense slot cache, the paged
    gather mode and the fused mode, with prefix sharing on and off."""
    _, _, cfg, params = ref_model
    prompts = _header_prompts(13, 48, (9, 23, 5, 30))

    def run(**kw):
        return Engine(cfg, params, num_slots=4, max_seq=128,
                      prefill_chunk=16, device="cpu", **kw).run(
            [(p, SamplingParams(max_new_tokens=5)) for p in prompts])

    gather = make_plan(backend, gather_chunk="dense")
    fused = make_plan(backend, fused_threshold=1)
    paged = dict(cache_kind="paged", page_size=16)
    base = run(cache_kind="dense", plan=gather)
    for name, kw in {"gather": dict(plan=gather),
                     "fused": dict(plan=fused),
                     "gather+share": dict(plan=gather, prefix_sharing=True),
                     "fused+share": dict(plan=fused,
                                         prefix_sharing=True)}.items():
        assert run(**paged, **kw) == base, f"{name} diverged from dense"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_identity_fused_under_preemption_with_sharing(ref_model,
                                                             backend):
    """A sharing sequence preempted mid-decode under an overcommitted pool,
    in the fused mode: release drops refs, re-admission re-maps the
    surviving prefix and re-prefills through resident-bounded tables, and
    greedy outputs still match the gather mode without sharing."""
    _, _, cfg, params = ref_model
    prompts = _header_prompts(17, 16, (9, 10))
    kw = dict(num_slots=2, max_seq=80, page_size=16, prefill_chunk=16,
              num_pages=5, cache_kind="paged", device="cpu")
    fused = Engine(cfg, params, prefix_sharing=True,
                   plan=make_plan(backend, fused_threshold=1), **kw)
    gather = Engine(cfg, params,
                    plan=make_plan(backend, gather_chunk="dense"), **kw)
    reqs = [(p, SamplingParams(max_new_tokens=26)) for p in prompts]
    out_f = fused.run(list(reqs))
    out_g = gather.run(list(reqs))
    assert fused.stats.preemptions > 0, "pool was never under pressure"
    assert fused.stats.shared_prefix_pages > 0, "nothing was shared"
    assert any(fused.requests[r].preemptions > 0 for r in out_f)
    assert out_f == out_g
    fused.slots.check()
    assert fused.pool.used_pages == 0


def test_shared_prefix_batch_identical_and_cheaper(ref_model):
    """Sharing on = off = dense, bitwise on the kernels' plain versions
    (every row is computed by the same code at the same shape either
    way), with fewer pages allocated and the shared prefill skipped."""
    _, _, cfg, params = ref_model
    prompts = _header_prompts(3, 40, (9, 23, 5, 17))

    def eng(**kw):
        return Engine(cfg, params, num_slots=4, max_seq=128,
                      prefill_chunk=16, device="cpu", **kw)

    reqs = [(p, SamplingParams(max_new_tokens=4)) for p in prompts]
    on = eng(cache_kind="paged", page_size=16, prefix_sharing=True)
    off = eng(cache_kind="paged", page_size=16)
    out_on = on.run(list(reqs))
    assert out_on == off.run(list(reqs))
    # a 40-token header = 2 full 16-token pages shared by 3 followers
    assert on.stats.shared_prefix_pages == 6
    assert on.stats.saved_prefill_tokens == 6 * 16
    assert on.stats.peak_pages_used < off.stats.peak_pages_used
    on.slots.check()
    assert on.pool.used_pages == 0 and len(on.prefix) == 0


def test_fully_covered_prompt_cow_forks_and_matches(ref_model):
    """A request whose page-aligned prompt is fully resident forks the
    tail page (the final-chunk re-run that recovers the last-token logits
    writes into a refcount-2 page) and still matches sharing off."""
    _, _, cfg, params = ref_model
    prompt = np.random.default_rng(5).integers(1, 500, 32).astype(np.int32)
    outs = {}
    for sharing in (True, False):
        eng = Engine(cfg, params, num_slots=2, max_seq=128,
                     prefill_chunk=16, cache_kind="paged", page_size=16,
                     prefix_sharing=sharing, device="cpu")
        ra = eng.submit(prompt, SamplingParams(max_new_tokens=8))
        eng.step()               # a prefills + commits, stays resident
        rb = eng.submit(prompt, SamplingParams(max_new_tokens=8))
        while not (eng.requests[ra].finished and eng.requests[rb].finished):
            eng.step()
        outs[sharing] = {r: eng.requests[r].tokens for r in (ra, rb)}
        if sharing:
            assert eng.stats.cow_forks == 1
            assert eng.stats.shared_prefix_pages == 1   # fork dst private
            eng.slots.check()
    assert outs[True] == outs[False]


def test_victim_signal_tracks_live_refcounts(ref_model):
    """exclusive_len reflects refcounts at eviction time: when the leader
    goes, its follower becomes the sole owner of the once-shared pages."""
    _, _, cfg, params = ref_model
    prompt = np.random.default_rng(13).integers(1, 500, 33).astype(np.int32)
    eng = Engine(cfg, params, num_slots=2, max_seq=128, prefill_chunk=16,
                 cache_kind="paged", page_size=16, prefix_sharing=True,
                 device="cpu")
    ra = eng.submit(prompt, SamplingParams(max_new_tokens=20))
    eng.step()
    rb = eng.submit(prompt, SamplingParams(max_new_tokens=20))
    eng.step()
    a, b = eng.requests[ra], eng.requests[rb]
    eng._refresh_shared_lens()
    assert b.shared_len == 32 and a.shared_len == 32
    eng.abort(ra)
    eng._refresh_shared_lens()
    assert b.shared_len == 0
    assert b.exclusive_len == b.total_len


@pytest.mark.parametrize("threshold,widths", [(1, {1, 2, 4}),
                                               (10_000, {8})])
def test_fused_threshold_bounds_the_chunk_tables(ref_model, monkeypatch,
                                                 threshold, widths):
    """In the fused mode the chunk kernel reads the pool in place; a wave
    whose longest prompt reaches ``fused_threshold`` hands it tables cut
    to a power-of-two bound of resident pages (here 1, 2, then 4 of 8
    while the prompts end by position 48), a shorter wave the full
    tables, as the JAX engine does. The tokens do not change."""
    from repro_torch.kernels import ops
    _, _, cfg, params = ref_model
    calls = []
    real = ops.paged_chunk_attention_unified_max

    def spy(*a, **k):
        calls.append(a[3].shape[1])              # table width
        return real(*a, **k)

    monkeypatch.setattr(ops, "paged_chunk_attention_unified_max", spy)
    prompts = [np.random.default_rng(19).integers(1, 500, n).astype(np.int32)
               for n in (7, 40)]
    kw = dict(num_slots=2, max_seq=128, page_size=16, prefill_chunk=16,
              cache_kind="paged", device="cpu")
    reqs = [(p, SamplingParams(max_new_tokens=4)) for p in prompts]
    got = Engine(cfg, params, plan=make_plan(fused_threshold=threshold),
                 **kw).run(list(reqs))
    assert set(calls) == widths
    calls.clear()
    want = Engine(cfg, params, plan=make_plan(gather_chunk="dense"),
                  **kw).run(list(reqs))
    assert not calls                             # gather mode: no kernel
    assert got == want


def test_fused_chunk_kernel_gets_each_steps_chunk_lens(ref_model,
                                                     monkeypatch):
    """Every fused chunk-kernel call of a chunk step carries that step's
    chunk_lens (the valid tokens per row), so on the card it never reads
    the pool rows past a ragged chunk: a 7-token prompt ends in a ragged
    chunk, a 40-token one in a full one and then an 8-token one."""
    from repro_torch.kernels import ops
    _, _, cfg, params = ref_model
    seen = []
    real = ops.paged_chunk_attention_unified_max

    def spy(*a, **k):
        seen.append(k["chunk_lens"].tolist())
        return real(*a, **k)

    monkeypatch.setattr(ops, "paged_chunk_attention_unified_max", spy)
    prompts = [np.random.default_rng(23).integers(1, 500, n).astype(np.int32)
               for n in (7, 40)]
    Engine(cfg, params, num_slots=2, max_seq=128, page_size=16,
           prefill_chunk=16, cache_kind="paged", device="cpu").run(
        [(p, SamplingParams(max_new_tokens=2)) for p in prompts])
    steps = [seen[i] for i in range(0, len(seen), cfg.num_layers)]
    assert len(seen) == len(steps) * cfg.num_layers
    assert sorted(n for step in steps for n in step if n) == [7, 8, 16, 16]


def test_paged_engine_rejects_what_it_cannot_serve(ref_model):
    _, _, cfg, params = ref_model
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, cache_kind="dense", prefix_sharing=True,
               device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        Engine(cfg, params, cache_kind="paged", prefix_sharing=True,
               page_size=24, prefill_chunk=16, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        Engine(cfg, params, cache_kind="paged", prefill_chunk=0,
               device="cpu")
    eng = Engine(cfg, params, cache_kind="paged", page_size=16, num_pages=2,
                 max_seq=128, device="cpu")
    with pytest.raises(ValueError, match="pool size"):
        eng.submit(np.arange(1, 30, dtype=np.int32),
                   SamplingParams(max_new_tokens=10))
    with pytest.raises(PlanError):
        PagedPlan(gather_chunk="bogus")
    with pytest.raises(PlanError):
        PagedPlan(fused_threshold=0)
    assert make_plan("torch", gather_chunk="dense").paged.gather_chunk \
        == "dense"


def test_serve_cli_paged_matches_dense(capsys):
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-seq", "96", "--max-new", "3", "--prompt-len", "20",
            "--prefill-chunk", "16", "--shared-prefix", "32"]
    assert serve.main(base) == 0
    dense = capsys.readouterr().out
    assert serve.main(base + ["--cache-kind", "paged", "--page-size", "16",
                              "--prefix-sharing", "--gather-chunk",
                              "fused"]) == 0
    paged = capsys.readouterr().out
    assert "shared pages" in paged and "preemptions" in paged
    req = [ln for ln in dense.splitlines() if ln.startswith("  req ")]
    assert len(req) == 3
    assert req == [ln for ln in paged.splitlines()
                   if ln.startswith("  req ")]


# ---------------------------------------------------------------------------
# Model level: the paged layout and the sync-free masked KV write
# ---------------------------------------------------------------------------


def test_init_cache_layouts():
    cfg = tconfigs.smoke(tconfigs.get(ARCH))
    api = tget_model(cfg)
    assert api.supports_paged
    dense = api.init_cache(DenseLayout(4, 64), device="cpu")
    paged = api.init_cache(PagedLayout(12, 16), device="cpu")
    shape = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    assert dense["k"].shape == (shape[0], 4, 64, *shape[1:])
    assert paged["v"].shape == (shape[0], 12, 16, *shape[1:])
    assert not paged["k"].any()
    assert PagedLayout(12, 16).pages_for(17) == pages_for(17, 16) == 2
    q8 = api.init_cache(PagedLayout(12, 16, kv_dtype="int8"), device="cpu")
    assert q8["k"].dtype == q8["v"].dtype == torch.int8
    assert q8["k"].shape == paged["k"].shape
    for name in ("k_scale", "v_scale"):
        assert q8[name].shape == (shape[0], 12, shape[1])
        assert q8[name].dtype == torch.float32 and not q8[name].any()


def _write_reference(store, new, rows, keep):
    """Loop version of the masked write: kept entries land, others don't."""
    out = store.clone().view(-1, *store.shape[-2:])
    vals = new.reshape(-1, *out.shape[1:])
    for i in range(len(keep)):
        if keep[i]:
            out[rows[i]] = vals[i]
    return out.view_as(store)


@pytest.mark.parametrize("case", ["mixed", "none_kept"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kv_write_drops_padding_spectators_and_sentinels(layout, case):
    rng = np.random.default_rng(0)
    b, c, hk, d = 3, 4, 2, 8
    new = torch.from_numpy(rng.normal(size=(b, c, hk, d)).astype(np.float32))
    lengths = torch.tensor([5, 0, 9], dtype=torch.int32)
    chunk_lens = torch.tensor([4, 0, 2] if case == "mixed" else [0, 0, 0],
                              dtype=torch.int32)
    if layout == "dense":
        store = torch.from_numpy(rng.normal(size=(b, 16, hk, d)).astype(
            np.float32))
        write = L.dense_chunk_write(store, lengths, chunk_lens, c)
        pos = lengths[:, None].long() + torch.arange(c)[None, :]
        rows = (torch.arange(b)[:, None] * 16 + pos).reshape(-1)
        keep = (torch.arange(c)[None, :] < chunk_lens[:, None]).reshape(-1)
    else:
        ps, npages = 4, 7
        store = torch.from_numpy(rng.normal(size=(npages, ps, hk, d)).astype(
            np.float32))
        # row 1 is an empty slot (all sentinel), row 2's second page too
        bt = torch.tensor([[3, 0, 5, 7], [7, 7, 7, 7], [6, 2, 1, 7]],
                          dtype=torch.int32)
        if case == "mixed":
            lengths = torch.tensor([5, 0, 6], dtype=torch.int32)
            chunk_lens = torch.tensor([4, 1, 2], dtype=torch.int32)
            bt[2, 1] = npages            # row 2's write at 6, 7 is dropped
        write = L.paged_chunk_write(store, bt, lengths, chunk_lens, c)
        pos = lengths[:, None].long() + torch.arange(c)[None, :]
        phys = torch.gather(bt.long(), 1, (pos // ps).clamp(0, 3))
        rows = (phys * ps + pos % ps).reshape(-1)
        keep = ((torch.arange(c)[None, :] < chunk_lens[:, None])
                & (phys < npages)).reshape(-1)
    want = _write_reference(store, new, rows.tolist(), keep.tolist())
    write.put(store, new)
    assert torch.equal(store, want)


# ---------------------------------------------------------------------------
# BlockPool, PrefixIndex, PagedSlotManager (host side)
# ---------------------------------------------------------------------------


def test_blockpool_alloc_share_free():
    pool = BlockPool(num_pages=8, page_size=16)
    a, b = pool.alloc(3), pool.alloc(5)
    assert pool.free_pages == 0 and pool.used_pages == 8
    assert set(a) | set(b) == set(range(8)) and not set(a) & set(b)
    assert pool.alloc(1) is None                 # exhausted, not an error
    pool.share(a[:2])
    assert pool.total_refs == 10
    assert pool.free(a) == [a[2]]                # only the unshared died
    assert pool.free(a[:2]) == a[:2]
    c = pool.alloc(2)
    assert set(c) <= set(a)                      # freed pages reused
    pool.check()
    with pytest.raises(ValueError):
        pool.free([a[2]])                        # double free
    with pytest.raises(ValueError):
        pool.share([99])                         # not allocated
    assert [pool.pages_for(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]


def test_lazy_admission_growth_and_dry_pool():
    pool = BlockPool(num_pages=8, page_size=8)
    mgr = PagedSlotManager(2, max_seq=64, pool=pool)
    idx = mgr.try_assign(0, prompt_len=20, max_new=30)
    # prefill footprint (3 pages) + one growth page, not ceil(50/8) = 7
    assert pool.used_pages == pages_for(20, 8) + 1
    assert mgr.ensure(idx, 32) and pool.used_pages == 4
    assert mgr.ensure(idx, 33) and pool.used_pages == 5
    other = mgr.try_assign(1, prompt_len=14, max_new=2)   # capped: 2 pages
    assert other is not None and pool.used_pages == 7
    assert not mgr.ensure(idx, 64)              # dry: needs 3 more
    mgr.check()                                 # nothing leaked
    mgr.release(other)
    assert mgr.ensure(idx, 64)
    mgr.check()
    with pytest.raises(ValueError):
        PagedSlotManager(1, 512, BlockPool(2, 64)).try_assign(0, 200, 100)


def test_block_tables_sentinel_cache_and_invalidation():
    pool = BlockPool(num_pages=16, page_size=8)
    mgr = PagedSlotManager(3, max_seq=64, pool=pool)
    a = mgr.try_assign(0, prompt_len=9, max_new=20)      # 2 + headroom
    b = mgr.try_assign(1, prompt_len=5, max_new=3)       # 1 page
    bt0 = mgr.block_tables("cpu")
    assert bt0.shape == (3, 8) and bt0.dtype == torch.int32
    assert mgr.block_tables("cpu") is bt0                # cached
    assert set(bt0[a, :3].tolist()).isdisjoint(bt0[b, :1].tolist())
    free_row = ({0, 1, 2} - {a, b}).pop()
    assert (bt0[free_row] == pool.num_pages).all()       # sentinel row
    mgr.tick(a)
    assert mgr.ensure(a, 24) and mgr.block_tables("cpu") is bt0
    assert mgr.ensure(a, 25)                             # grew a page
    bt1 = mgr.block_tables("cpu")
    assert bt1 is not bt0 and bt1[a, 3] < pool.num_pages
    mgr.release(a)
    assert mgr.block_tables("cpu") is not bt1


@pytest.mark.parametrize("seed", range(8))
def test_paged_manager_random_lifecycle(seed):
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([4, 8, 16]))
    num_pages = int(rng.integers(4, 40))
    num_slots = int(rng.integers(1, 6))
    max_seq = page_size * max(2, num_pages // num_slots)
    pool = BlockPool(num_pages, page_size)
    mgr = PagedSlotManager(num_slots, max_seq, pool)
    live, rid = [], 0
    for _ in range(40):
        op = rng.random()
        if op < 0.4:
            prompt = int(rng.integers(1, max(max_seq // 2, 2)))
            max_new = int(rng.integers(1, max_seq - prompt + 1))
            if pages_for(prompt + max_new, page_size) > num_pages:
                continue
            idx = mgr.try_assign(rid, prompt, max_new)
            if idx is not None:
                assert idx not in live
                live.append(idx)
                rid += 1
        elif op < 0.6 and live:
            mgr.ensure(live[rng.integers(len(live))],
                       int(rng.integers(1, max_seq + 1)))
        elif op < 0.8 and live:
            mgr.tick(live[rng.integers(len(live))],
                     wrote_kv=bool(rng.random() < 0.9))
        elif live:
            mgr.release(live.pop(rng.integers(len(live))))
        mgr.check()
    for idx in live:
        mgr.release(idx)
    mgr.check()
    assert pool.free_pages == num_pages


def test_prefix_index_semantics():
    ix = PrefixIndex(page_size=4)
    toks = list(range(10, 21))                   # 11 tokens = 2 full pages
    assert ix.register(toks, pages=[7, 8, 99]) == 2
    assert ix.match(toks).pages == [7, 8]
    assert ix.match(toks[:7]).pages == [7]
    assert ix.match(toks[:3]).pages == []
    # the chain key needs the whole ancestry to match
    assert ix.match([9, 9, 9, 9] + toks[4:8]).pages == []
    assert ix.match(toks[:4] + [9, 9, 9, 9]).pages == [7]
    # first registrant wins; a dropped page purges its entry
    ix2 = PrefixIndex(page_size=2)
    ix2.register([1, 2, 3, 4], pages=[5, 6])
    ix2.register([1, 2, 9, 9], pages=[7, 8])
    assert ix2.match([1, 2, 9, 9]).pages == [5, 8]
    ix2.drop_page(5)
    assert ix2.match([1, 2, 3, 4]).pages == []
    ix2.check(live_pages={6, 8})
    # pending entries carry their wave level until committed
    ix3 = PrefixIndex(page_size=2)
    ix3.register([1, 2, 3, 4], pages=[0, 1], level=0)
    m = ix3.match([1, 2, 3, 4, 5])
    assert m.pages == [0, 1] and m.pending_level == 0 and m.tail_pending
    ix3.commit([1, 2, 3, 4])
    m = ix3.match([1, 2, 3, 4, 5])
    assert m.pending_level == -1 and not m.tail_pending


def _sharing_mgr(num_pages=16, page_size=4, num_slots=3, max_seq=32):
    pool = BlockPool(num_pages, page_size)
    return PagedSlotManager(num_slots, max_seq, pool,
                            prefix_index=PrefixIndex(page_size)), pool


def test_shared_admission_release_and_cow_fork():
    mgr, pool = _sharing_mgr()
    toks = np.arange(100, 109, dtype=np.int32)   # 9 tokens, 2 full pages
    a = mgr.try_assign(0, 9, 4, tokens=toks)
    mgr.commit_prefix(a, toks)
    used = pool.used_pages
    b = mgr.try_assign(1, 9, 4, tokens=toks)
    sb = mgr.slots[b]
    assert sb.shared_len == 8 and sb.prefill_start == 8
    assert sb.pages[:2] == mgr.slots[a].pages[:2]
    assert all(pool.refcount(p) == 2 for p in sb.pages[:2])
    assert pool.used_pages == used + len(sb.pages) - 2
    forks = mgr.fork_for_write(b, 0, 9)          # write over the shared span
    assert forks is not None and len(forks) == 2
    for src, dst in forks:
        assert pool.refcount(src) == pool.refcount(dst) == 1
        assert dst in mgr.slots[b].pages and dst not in mgr.slots[a].pages
    assert mgr.fork_for_write(b, 0, 9) == []     # all private now
    mgr.check()
    shared = list(mgr.slots[a].pages[:2])
    mgr.release(b)
    assert mgr.prefix.match(toks).pages == shared
    mgr.release(a)
    assert mgr.prefix.match(toks).pages == []    # purged with its pages
    mgr.check()
    assert pool.free_pages == pool.num_pages


def test_fork_for_write_reports_dry_pool_without_side_effects():
    pool = BlockPool(num_pages=7, page_size=4)
    mgr = PagedSlotManager(3, 16, pool, prefix_index=PrefixIndex(4))
    toks = np.arange(60, 69, dtype=np.int32)     # 9 tokens: 2 full pages
    a = mgr.try_assign(0, 9, 1, tokens=toks)     # 3 pages
    mgr.commit_prefix(a, toks)
    b = mgr.try_assign(1, 9, 1, tokens=toks)     # shares 2, allocs 1
    c = mgr.try_assign(2, 5, 1)                  # takes 2 more
    assert pool.free_pages == 1                  # room for one fork only
    before = list(mgr.slots[b].pages)
    assert mgr.fork_for_write(b, 0, 8) is None   # needs two
    assert mgr.slots[b].pages == before
    assert all(pool.refcount(p) == 2 for p in before[:2])
    mgr.check()
    mgr.release(c)
    assert len(mgr.fork_for_write(b, 0, 8)) == 2
    mgr.check()


@pytest.mark.parametrize("seed", range(8))
def test_sharing_manager_random_lifecycle(seed):
    """check() invariants (refcount == ownership multiset, no page both
    free and owned, forks never alias, the index maps only live pages)
    under random admit / grow / fork / release over shared headers."""
    rng = np.random.default_rng(seed)
    page_size = int(rng.choice([2, 4]))
    num_pages = int(rng.integers(6, 32))
    num_slots = int(rng.integers(2, 5))
    max_seq = page_size * max(3, num_pages // num_slots)
    pool = BlockPool(num_pages, page_size)
    mgr = PagedSlotManager(num_slots, max_seq, pool,
                           prefix_index=PrefixIndex(page_size))
    headers = [list(rng.integers(1, 50, size=2 * page_size))
               for _ in range(2)]
    live, rid = {}, 0
    for _ in range(50):
        op = rng.random()
        if op < 0.4:
            toks = np.asarray(
                headers[int(rng.integers(2))][:int(rng.integers(
                    1, 2 * page_size + 1))]
                + list(rng.integers(1, 50, size=int(rng.integers(0, 6)))),
                np.int32)[:max_seq - 1]
            max_new = int(rng.integers(1, max_seq - len(toks) + 1))
            if pages_for(len(toks) + max_new, page_size) > num_pages:
                continue
            idx = mgr.try_assign(rid, len(toks), max_new, tokens=toks)
            if idx is not None:
                assert idx not in live
                live[idx] = toks
                rid += 1
                mgr.commit_prefix(idx, toks)
        elif op < 0.55 and live:
            mgr.ensure(list(live)[rng.integers(len(live))],
                       int(rng.integers(1, max_seq + 1)))
        elif op < 0.75 and live:
            pos = int(rng.integers(0, max_seq))
            mgr.fork_for_write(list(live)[rng.integers(len(live))], pos,
                               pos + 1)
        elif live:
            idx = list(live)[rng.integers(len(live))]
            del live[idx]
            mgr.release(idx)
        mgr.check()
    for idx in list(live):
        mgr.release(idx)
    mgr.check()
    assert pool.free_pages == num_pages
    assert len(mgr.prefix) == 0
