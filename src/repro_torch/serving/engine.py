"""Streaming continuous-batching engine over the dense slot cache or the
block-paged pool.

The port of the JAX package's ``serving/engine.py`` for
``cache_kind="dense"`` and ``cache_kind="paged"``:

  * **Request lifecycle.** Each submission is a
    :class:`~repro_torch.serving.request.RequestState` walking WAITING →
    PREFILLING → RUNNING → FINISHED``{stop,length,abort}``. Sampling knobs
    ride in an immutable :class:`SamplingParams`, and every request owns
    a private ``torch.Generator`` seeded from ``(seed, rid)`` (or its own
    ``SamplingParams.seed``).
  * **Prefill.** Chunked and batched: every admitted prompt streams
    through ``api.prefill_chunk`` in ``prefill_chunk``-token chunks, the
    whole admission wave in one ``(num_slots, chunk)`` call. With
    ``prefill_chunk=0`` a wave prefills in one padded ``api.prefill``
    call (flash prefill attention) and its KV rows are copied into the
    slots.
  * **Decode.** Every tick runs the whole slot batch (continuous
    batching), so decode GEMMs see M = num_slots — the regime the paper's
    T2/T3 target. KV appends update the cache in place.
  * **Lazy pages + preemption** (paged). Admission reserves pages only
    for the tokens about to be prefilled; each decode tick grows tables
    page by page. When the (possibly overcommitted) pool runs dry, the
    scheduler names a victim: its pages are freed and it is re-queued,
    and re-admission re-prefills ``prompt + generated`` through fresh
    block tables.
  * **Prefix sharing + copy-on-write** (paged, ``prefix_sharing=True``).
    Admission maps a prompt's page-aligned prefix onto resident pages
    through a :class:`~repro_torch.serving.prefix.PrefixIndex` and
    prefills only the rest; the first write into a shared page forks it
    (fresh page, device page copy, table patch). Chunk boundaries stay on
    the share-less grid, so greedy tokens do not change with sharing.
  * **Tiered KV + session cache** (paged + sharing, ``host_pages`` /
    ``session_cache`` / ``disk_pages``). The pool becomes tier 0 of a
    hierarchy (:mod:`~repro_torch.serving.tiers`): retiring or preempting
    a sequence *retains* its full pages in a session set instead of
    freeing them, pool pressure demotes those pages to pinned host memory
    (one device gather per reclaim batch, copied out into a pinned buffer
    a page) and on to disk, and
    a returning conversation whose prefix matches a demoted span
    *promotes* the slabs back (one bulk host-to-device copy before its
    prefill, written in place into the cache leaves) instead of
    re-prefilling them, when the span reaches the plan's
    ``paged.swap_threshold``. Demoted bytes are the bytes the run wrote,
    so the tokens do not change.
  * **Chunk discipline** (paged). With ``plan.paged.gather_chunk ==
    "fused"`` chunk attention reads the pool in place (the fused chunk
    kernel on the ``"cuda"`` backend), and a wave whose longest prompt
    reaches ``fused_threshold`` hands it block tables cut to a
    power-of-two bound of resident pages; ``"dense"`` gathers a dense
    view of the full tables for the reference chunk math.
  * **Grouped decode** (paged + sharing, ``plan.paged.decode_group ==
    "grouped"``). Each tick the slot manager's cached group plan names
    the slots whose tables lead with the same shared pages; decode
    attention reads each such prefix once per group and merges each
    row's private tail (the two-stage grouped kernels on ``"cuda"``).
    Tokens do not change.
  * **Decode fusion** (``decode_fusion=`` or the plan's
    ``decode_fusion.granularity``). ``"fused"`` runs each decode layer as
    four fused stage launches; ``"looped"`` replays the whole decode step
    as one CUDA graph per static shape key (one for the dense cache and
    for the ungrouped pool, one per power-of-two group bucket of grouped
    decode), all in one memory pool. A key's first tick runs eagerly and
    the next one captures; ``EngineStats.graph_captures`` /
    ``graph_replays`` count them. On the CPU looped runs the fused path
    eagerly.
  * **Quantized weights** (``weight_dtype=`` or the plan's
    ``matmul.weight_dtype``). ``"int8"`` / ``"fp8"`` quantize every layer
    GEMM weight once at load into 1-byte codes with one f32 step per
    output channel; the GEMM kernels stream the codes and scale their f32
    accumulators. ``EngineStats.weight_bytes_decode_read`` counts the
    stored weight bytes the decode ticks read. The accuracy contract is
    the logits guard (``quant.logits_guard_tol``), not bitwise tokens;
    ``"bf16"`` keeps every kernel and token.
  * **Quantized KV pages** (paged, ``kv_dtype=`` or the plan's
    ``paged.kv_dtype``). ``"int8"`` / ``"fp8"`` store every page as 1-byte
    codes with one f32 step per (layer, page, kv head) in the
    ``k_scale`` / ``v_scale`` cache leaves; appends go through the
    quantized scatter (:mod:`~repro_torch.serving.kvquant`) and the paged
    kernels' quantized bodies dequantize as they read. A page costs about
    half the bytes (``EngineStats.kv_page_bytes``), and
    ``kv_bytes_decode_read`` counts the stored KV bytes the decode ticks
    read. The accuracy contract is the logits guard, as for weights.
  * **One dispatch surface.** Every kernel decision rides in the single
    ``plan=`` operand; plans change which kernel runs, never the tokens
    (the weight precision changes them within the logits guard).

Entry points run on the card unless ``device`` says otherwise; asking for
CUDA where there is none raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.plan import (DEFAULT_PLAN, FUSION_MODES, KV_DTYPES,
                                   WEIGHT_DTYPES, ExecutionPlan)
from repro_torch.device import resolve
from repro_torch.kernels import quant
from repro_torch.models import wquant
from repro_torch.models.api import get_model
from repro_torch.models.kvlayout import (DenseLayout, KVLayout, PagedLayout,
                                         pages_for, pow2_bucket)
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves
from repro_torch.serving.blockpool import BlockPool, PagedSlotManager
from repro_torch.serving.kvcache import SlotManager
from repro_torch.serving.prefix import PrefixIndex
from repro_torch.serving.request import (FinishReason, Phase, RequestState,
                                         SamplingParams, TokenEvent)
from repro_torch.serving.sampling import mask_vocab, sample
from repro_torch.serving.scheduler import Scheduler, get_scheduler
from repro_torch.serving.tiers import TieredPool

PROMPT_BUCKET = 64
DEFAULT_PREFILL_CHUNK = 64
DEFAULT_PAGE_SIZE = 64

PromptLike = Union[np.ndarray, Sequence[int]]


@dataclasses.dataclass
class EngineStats:
    """Counters for the CLI summary line. Phase times are host wall time
    around work that ends in a host read of the sampled tokens (so the
    device work is included)."""

    admitted: int = 0
    finished: int = 0
    aborted: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    # paged cache (all zero for cache_kind="dense")
    preemptions: int = 0
    peak_pages_used: int = 0
    shared_prefix_pages: int = 0     # page mappings served by refcount
    #                                  bumps instead of fresh allocations
    saved_prefill_tokens: int = 0    # prompt positions admission skipped
    #                                  because their KV was resident
    cow_forks: int = 0               # shared pages privatized by a write
    # grouped decode (plan.paged.decode_group == "grouped")
    grouped_requests: int = 0        # decode-row ticks served through a
    #                                  shared-prefix group
    prefix_kv_bytes_saved: int = 0   # prefix KV bytes read once per group
    #                                  instead of once per member
    # looped decode (decode_fusion == "looped" on the card)
    graph_captures: int = 0          # decode-step CUDA graphs captured
    graph_replays: int = 0           # decode ticks served by a replay
    # GEMM weights (bf16-sized unless weight_dtype != "bf16")
    weight_bytes_decode_read: int = 0  # cumulative GEMM weight bytes the
    #                                  decode ticks streamed: every layer's
    #                                  projection leaves once per tick,
    #                                  codes and steps at stored width
    #                                  (embedding / lm_head excluded: not
    #                                  per-layer streams)
    # KV page storage (zero for cache_kind="dense")
    kv_page_bytes: int = 0           # one page's K+V slab across all layers
    #                                  (code pools + scale rows as stored)
    kv_bytes_decode_read: int = 0    # cumulative KV bytes decode ticks
    #                                  streamed (resident pages x slab
    #                                  bytes), at stored width
    # tiered KV / session cache (all zero without host_pages/session_cache)
    demoted_pages: int = 0           # pages copied device -> host (-> disk)
    #                                  instead of being discarded
    promoted_pages: int = 0          # demoted pages copied back into fresh
    #                                  pages at re-admission
    session_hits: int = 0            # admissions that re-mapped at least
    #                                  one retained session page (refcount
    #                                  bump or promotion)
    host_evicted_pages: int = 0      # pages that fell off the bottom tier
    #                                  (KV lost; those spans re-prefill)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its uint8 bits (the tier copies move bytes, and
    the index kernels take no float8); any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def request_seed(seed: int, rid: int) -> int:
    """The per-request generator seed derived from ``(seed, rid)``."""
    return int(np.random.SeedSequence([seed, rid]).generate_state(1)[0])


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        num_slots: int = 8,
        max_seq: int = 2048,
        cache_kind: str = "dense",
        page_size: int = DEFAULT_PAGE_SIZE,
        num_pages: Optional[int] = None,
        prefill_chunk: Optional[int] = DEFAULT_PREFILL_CHUNK,
        prefix_sharing: bool = False,
        scheduler: Union[str, Scheduler] = "fcfs",
        plan: Optional[ExecutionPlan] = None,
        decode_fusion: Optional[str] = None,
        weight_dtype: Optional[str] = None,
        kv_dtype: Optional[str] = None,
        host_pages: Optional[int] = None,
        session_cache: Optional[bool] = None,
        disk_dir: Optional[str] = None,
        disk_pages: int = 0,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve(device)
        leaf = tree_leaves(params)[0]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.plan = plan if plan is not None else DEFAULT_PLAN
        # decode-layer granularity: the explicit argument wins over the
        # plan's knob, and lands in the plan, which the layers read
        if decode_fusion is not None:
            if decode_fusion not in FUSION_MODES:
                raise ValueError(f"decode_fusion {decode_fusion!r} not in "
                                 f"{FUSION_MODES}")
            self.plan = dataclasses.replace(
                self.plan, decode_fusion=dataclasses.replace(
                    self.plan.decode_fusion, granularity=decode_fusion))
        self.decode_fusion = self.plan.decode_fusion.granularity
        # GEMM weight precision: the explicit argument wins over the plan's
        # matmul.weight_dtype and lands in the plan; the kernels themselves
        # key off the quantized leaves, not the knob
        if weight_dtype is None:
            weight_dtype = self.plan.matmul.weight_dtype
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype {weight_dtype!r} not in "
                             f"{WEIGHT_DTYPES}")
        if weight_dtype != self.plan.matmul.weight_dtype:
            self.plan = dataclasses.replace(
                self.plan, matmul=dataclasses.replace(
                    self.plan.matmul, weight_dtype=weight_dtype))
        if cfg.family == "moe" and weight_dtype != "bf16":
            # the JAX package quantizes the expert leaves too (w_gate /
            # w_up / w_down are weight keys) and its MoE einsums cannot
            # take the {codes, scale} dict: its engine fails there, so
            # there is no reference result to hold quantized experts to
            raise ValueError(
                f"weight_dtype {weight_dtype!r} is not served for the moe "
                "family: the JAX package quantizes the expert weights and "
                "its expert einsums cannot read the {codes, scale} leaves; "
                "use weight_dtype='bf16'")
        self.weight_dtype = weight_dtype
        self.ctx = LayerCtx(cfg=cfg, plan=self.plan)
        # quantize at load, once, on the params' device: every GEMM weight
        # leaf becomes int8 / fp8 codes with one f32 step per output
        # channel; bf16 leaves the tree untouched (the bitwise path)
        if weight_dtype != "bf16":
            params = wquant.quantize_params(params,
                                            quant.spec_for(weight_dtype))
        self.params = params
        # one decode tick's GEMM weight stream at stored width
        self._weight_bytes_per_tick = wquant.gemm_weight_bytes(params)
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.scheduler = get_scheduler(scheduler)
        # prefill_chunk=None adopts the plan's chunk size
        if prefill_chunk is None:
            prefill_chunk = self.plan.paged.chunk_block
        self.prefill_chunk = (
            prefill_chunk if self.api.supports_chunked_prefill else 0)
        # KV page precision: the explicit argument wins, else the plan's
        # paged.kv_dtype (paged engines only: a dense engine never reads
        # plan.paged); the step rows are page-pool leaves, so quantized
        # pages need the paged layout
        if kv_dtype is None:
            kv_dtype = (self.plan.paged.kv_dtype if cache_kind == "paged"
                        else "bf16")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        if kv_dtype != "bf16" and cache_kind != "paged":
            raise ValueError(
                "kv_dtype quantization stores per-page scales in the block "
                "pool; use cache_kind='paged'")
        quant.spec_for(kv_dtype)          # raises where fp8 is unsupported
        self.kv_dtype = kv_dtype
        # tiered KV store: any of the knobs turns the hierarchy on
        tiered = (host_pages is not None or disk_pages > 0
                  or bool(session_cache))
        # retain finished sequences' KV in the session cache? On whenever
        # the hierarchy exists (the session cache is its point);
        # session_cache=False keeps demotion for preemption only
        self.session_cache = (tiered if session_cache is None
                              else bool(session_cache))
        self.layout: KVLayout
        self.prefix: Optional[PrefixIndex] = None
        self.pool: Optional[BlockPool] = None
        self.tiers: Optional[TieredPool] = None
        if cache_kind == "dense":
            if prefix_sharing:
                raise ValueError("prefix_sharing needs refcounted pages; "
                                 "use cache_kind='paged'")
            if tiered:
                raise ValueError(
                    "tiered KV (host_pages/session_cache/disk_pages) "
                    "needs cache_kind='paged'")
            self.layout = DenseLayout(num_slots, max_seq)
            self.slots: SlotManager = SlotManager(num_slots, max_seq)
        elif cache_kind == "paged":
            if not self.api.supports_paged:
                raise ValueError(f"family {cfg.family!r} has no paged-KV "
                                 "path; use cache_kind='dense'")
            if not self.prefill_chunk:
                raise ValueError("cache_kind='paged' requires chunked "
                                 "prefill (prefill_chunk > 0)")
            if prefix_sharing and page_size % self.prefill_chunk:
                # shared prefixes are page-aligned; keeping every chunk
                # boundary on the share-less run's grid is what keeps the
                # tokens identical, and that needs chunk | page_size
                raise ValueError(
                    f"prefix_sharing requires page_size ({page_size}) to "
                    f"be a multiple of prefill_chunk ({self.prefill_chunk})")
            # default pool: the dense cache's KV bytes; smaller overcommits
            # (lazy growth then preempts on a dry pool)
            self.pool = BlockPool(
                num_pages if num_pages is not None
                else num_slots * pages_for(max_seq, page_size), page_size)
            self.layout = PagedLayout(self.pool.num_pages, page_size,
                                      kv_dtype)
            if prefix_sharing:
                self.prefix = PrefixIndex(page_size)
            if tiered:
                if self.prefix is None:
                    raise ValueError(
                        "tiered KV needs prefix_sharing=True — the "
                        "prefix index is the cross-tier map that makes "
                        "retained/demoted pages matchable")
                self.tiers = TieredPool(
                    host_pages if host_pages is not None else 0,
                    index=self.prefix, disk_dir=disk_dir,
                    disk_pages=disk_pages)
            self.slots = PagedSlotManager(num_slots, max_seq, self.pool,
                                          prefix_index=self.prefix,
                                          tiers=self.tiers)
            if self.tiers is not None:
                self.slots.swap_threshold = self.plan.paged.swap_threshold
                self.slots.reclaim_cb = self._reclaim_session
        else:
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        self.cache_kind = cache_kind
        self.cache = self.api.init_cache(self.layout, device=self.device)
        # grouped decode reads shared prefixes once per group; groups
        # exist only where prefix sharing maps pages onto several slots
        self._group_decode = (cache_kind == "paged" and prefix_sharing
                              and self.plan.paged.decode_group == "grouped")
        # one page's K+V slab across all layers, steps included: the unit
        # of the grouped decode's bytes-saved and the decode KV byte counts
        self._kv_bytes_per_page = (
            sum(t.nbytes for t in self.cache.values())
            // self.pool.num_pages) if cache_kind == "paged" else 0

        self.seed = seed
        self.requests: dict[int, RequestState] = {}
        self.waiting: list[RequestState] = []
        self.by_slot: dict[int, RequestState] = {}
        self.stats = EngineStats(kv_page_bytes=self._kv_bytes_per_page)
        self.ticks = 0
        self._next_rid = 0
        self._arrival = 0

    # -- public API -----------------------------------------------------------

    def submit(self, prompt: PromptLike,
               params: Optional[SamplingParams] = None,
               *, rid: Optional[int] = None) -> int:
        """Queue a request; returns its id (auto-assigned if not given).
        Unservable requests are rejected here, not mid-admission."""
        params = params if params is not None else SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        worst = len(prompt) + params.max_new_tokens
        if worst > self.max_seq:
            raise ValueError(
                f"request needs {worst} positions > max_seq {self.max_seq}")
        if self.pool is not None and (
                pages_for(worst, self.pool.page_size) > self.pool.num_pages):
            raise ValueError(
                f"request needs {pages_for(worst, self.pool.page_size)} "
                f"pages > pool size {self.pool.num_pages} "
                f"(page_size {self.pool.page_size})")
        if rid is None:
            while self._next_rid in self.requests:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        elif rid in self.requests:
            raise ValueError(f"request id {rid} already submitted")
        seed = (params.seed if params.seed is not None
                else request_seed(self.seed, rid))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = RequestState(
            rid=rid, prompt=prompt, params=params, arrival=self._arrival,
            generator=gen, submit_time=time.perf_counter())
        self._arrival += 1
        self.requests[rid] = state
        self.waiting.append(state)
        return rid

    def generate(self, prompt: PromptLike,
                 params: Optional[SamplingParams] = None,
                 *, rid: Optional[int] = None) -> Iterator[TokenEvent]:
        """Stream one request's ``TokenEvent``s as engine ticks produce
        them (driving the shared tick loop). The final event has
        ``finished=True`` and a ``finish_reason``."""
        rid = self.submit(prompt, params, rid=rid)
        state = self.requests[rid]
        cursor = 0
        while True:
            while cursor < len(state.events):
                ev = state.events[cursor]
                cursor += 1
                yield ev
                if ev.finished:
                    return
            if state.finished:
                return
            self.step()

    def abort(self, rid: int) -> bool:
        """Cancel a request in any phase; frees its slot (and pages) at
        once. Returns False if unknown or already finished."""
        state = self.requests.get(rid)
        if state is None or state.finished:
            return False
        if state.slot is not None:
            self.by_slot.pop(state.slot, None)
            self.slots.release(state.slot)
        if state in self.waiting:
            self.waiting.remove(state)
        state.finish(FinishReason.ABORT)
        state.events.append(TokenEvent(
            rid, None, state.generated, finished=True,
            finish_reason=FinishReason.ABORT))
        self.stats.aborted += 1
        return True

    def finish_reason(self, rid: int) -> Optional[FinishReason]:
        return self.requests[rid].finish_reason

    def evict(self, rid: int) -> list[int]:
        """Drop a *finished* request's record (tokens, events, prompt) and
        return its tokens. A long-lived server calls this (or
        :meth:`evict_finished`) after consuming results. The
        conversation's KV stays: with the session cache on, its pages
        were retained at retire time, so its next turn still matches."""
        state = self.requests[rid]
        if not state.finished:
            raise ValueError(f"request {rid} is not finished; abort() it "
                             "first to evict early")
        del self.requests[rid]
        return state.tokens

    def evict_finished(self, *, flush: bool = False) -> int:
        """Evict every finished request's record; returns how many were
        dropped. Their KV stays cached (see :meth:`evict`); ``flush=True``
        also demotes the whole session cache to the host now
        (:meth:`flush_sessions`) instead of waiting for pool pressure."""
        done = [r for r, s in self.requests.items() if s.finished]
        for r in done:
            del self.requests[r]
        if flush:
            self.flush_sessions()
        return len(done)

    def run(self, requests, *, max_ticks: int = 10_000
            ) -> dict[int, list[int]]:
        """Blocking batch API: ``requests`` is a list of prompts or
        ``(prompt, SamplingParams)`` pairs; returns ``{rid: tokens}``."""
        rids = []
        for item in requests:
            prompt, sp = item if isinstance(item, tuple) else (item, None)
            rids.append(self.submit(prompt, sp))
        start = self.ticks
        while (any(not self.requests[r].finished for r in rids)
               and self.ticks - start < max_ticks):
            self.step()
        return {r: list(self.requests[r].tokens) for r in rids}

    # -- engine tick ------------------------------------------------------------

    @torch.no_grad()
    def step(self) -> list[TokenEvent]:
        """Admit + prefill per the scheduler's order, then one decode
        tick. Returns this tick's token events."""
        t0 = time.perf_counter()
        events = self._admit()
        self.stats.prefill_seconds += time.perf_counter() - t0
        if not self.by_slot:
            if self.waiting and not events:
                raise RuntimeError(
                    "admission stalled: empty batch but "
                    f"{len(self.waiting)} requests cannot be admitted")
            return events
        t0 = time.perf_counter()
        events += self._decode_tick()
        self.stats.decode_seconds += time.perf_counter() - t0
        self.ticks += 1
        return events

    # -- admission ---------------------------------------------------------------

    def _admit(self) -> list[TokenEvent]:
        """Offer slots (and prefill pages) to waiting requests in the
        scheduler's order and prefill the admitted wave in one batch.

        With prefix sharing, a request whose match includes pages
        promised by an earlier request of the same wave gets a later
        prefill level; the wave then prefills level by level, so shared
        pages are written before any sharer attends over them."""
        if not self.waiting:
            return []
        admitted: list[tuple[int, RequestState]] = []
        levels: dict[int, int] = {}
        for state in self.scheduler.admission_order(self.waiting):
            toks = state.prefill_tokens()
            idx = self.slots.try_assign(
                state.rid, len(toks),
                max(state.params.max_new_tokens - state.generated, 1),
                tokens=toks if self.prefix is not None else None)
            if idx is None:
                if not self.scheduler.allow_skip:
                    break      # head-of-line blocking (FCFS no-starvation)
                continue
            state.phase = Phase.PREFILLING
            state.slot = idx
            self.by_slot[idx] = state
            admitted.append((idx, state))
            self.stats.admitted += 1
            levels[idx] = 0
            if self.prefix is not None:
                slot = self.slots.slots[idx]
                levels[idx] = slot.prefill_level
                # the COW-fork destination is private, not shared
                state.shared_len = slot.shared_len - (
                    self.pool.page_size if slot.pending_fork else 0)
                # refcount-bump pages only; promoted pages are fresh pages,
                # counted under promoted_pages
                self.stats.shared_prefix_pages += (
                    state.shared_len // self.pool.page_size
                    - len(slot.pending_promotions))
                self.stats.saved_prefill_tokens += \
                    self._chunk_start(idx, len(toks))
                if slot.session_mapped:
                    # re-mapped a retired / preempted session's retained
                    # KV (refcount bump and / or promotion)
                    self.stats.session_hits += 1
                    slot.session_mapped = 0
        if not admitted:
            return []
        self.waiting = [s for s in self.waiting if s.slot is None]
        self._note_page_pressure()
        if self.tiers is not None:
            self._apply_pending_promotions(admitted)
        if self.prefix is not None:
            self._apply_pending_forks(admitted)
        if self.prefill_chunk:
            events: list[TokenEvent] = []
            for lv in sorted(set(levels.values())):
                events += self._prefill_chunked(
                    [(i, s) for i, s in admitted if levels[i] == lv])
            return events
        return self._prefill_batched(admitted)

    def _copy_page(self, src: int, dst: int) -> None:
        """COW fork on the device: page ``dst`` of every cache leaf (the K
        and V pools and, quantized, their step rows) becomes a copy of
        page ``src``, before anything writes it."""
        for leaf in self.cache.values():
            leaf[:, dst] = leaf[:, src]
        self.stats.cow_forks += 1

    def _apply_pending_forks(
            self, admitted: list[tuple[int, RequestState]]) -> None:
        """The page copies admission promised: a fully covered prompt
        forked its last shared page so the final-chunk re-run (which
        recovers the last-token logits) writes a private copy. Sources
        are committed pages, so copying before this wave's prefill is
        safe."""
        for idx, _state in admitted:
            slot = self.slots.slots[idx]
            if slot.pending_fork:
                self._copy_page(*slot.pending_fork)
                slot.pending_fork = None

    def _apply_pending_promotions(
            self, admitted: list[tuple[int, RequestState]]) -> None:
        """The host-to-device uploads admission promised: each promoted
        prefix page's slab (popped from the store at match time) lands in
        its fresh page, before any fork or prefill of this wave reads it.
        One bulk copy for the wave: each leaf's slabs stacked into pinned
        memory, one ``non_blocking`` copy to the device, and one in-place
        ``index_copy_`` into the cache leaf on the engine's stream. The
        leaves are never rebound to new tensors: the looped decode's
        graphs are keyed on their addresses."""
        ups: list[tuple] = []           # (slab, dst_page)
        for idx, _state in admitted:
            slot = self.slots.slots[idx]
            if slot.pending_promotions:
                ups.extend(slot.pending_promotions)
                slot.pending_promotions = []
        if not ups:
            return
        n = len(ups)
        dst = torch.tensor([d for _slab, d in ups], dtype=torch.long,
                           device=self.device)
        pinned = self.device.type == "cuda"
        for j, leaf in enumerate(self.cache.values()):
            rows = [_bits(slab[j]) for slab, _d in ups]
            shape = (rows[0].shape[0], n, *rows[0].shape[1:])
            staged = torch.empty(shape, dtype=rows[0].dtype,
                                 pin_memory=pinned)
            torch.stack(rows, dim=1, out=staged)
            _bits(leaf).index_copy_(
                1, dst, staged.to(self.device, non_blocking=True))
        self.stats.promoted_pages += n

    def _gather_pages(self, pages: list[int]) -> dict[int, tuple]:
        """Bulk device-to-host copy of the named pages: one
        ``index_select`` per cache leaf along the page axis (a quantized
        pool's step rows travel with the codes), laid out page-major,
        then each page's run copied ``non_blocking`` into a pinned buffer
        of its own, and one synchronization. Returns ``{page: slab}``, a
        slab being the tuple of each leaf's page in the cache's leaf
        order. A slab owns its storage, so the host tier's
        ``host_pages`` bounds host memory however large the batch."""
        if not pages:
            return {}
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        pinned = self.device.type == "cuda"
        slabs: list[list] = [[] for _ in pages]
        for leaf in self.cache.values():
            got = _bits(leaf).index_select(1, idx).movedim(1, 0).contiguous()
            for slab, row in zip(slabs, got):
                buf = torch.empty(row.shape, dtype=row.dtype,
                                  pin_memory=pinned)
                buf.copy_(row, non_blocking=pinned)
                slab.append(buf.view(leaf.dtype))
        if pinned:
            torch.cuda.current_stream(self.device).synchronize()
        return {p: tuple(slab) for p, slab in zip(pages, slabs)}

    def _reclaim_session(self, need: int) -> bool:
        """Slot-manager callback when an allocation finds the pool dry:
        demote LRU session pages (the gather included) until ``need``
        pages are free. The session cache never wins a page fight
        against admission or growth."""
        if self.slots.session_pages() == 0:
            return False
        return self._demote(max(need, 1)) >= need

    def flush_sessions(self) -> int:
        """Demote the *entire* session cache to the host now (one bulk
        gather), returning how many device pages were freed. Pool
        pressure does this on demand (:meth:`_reclaim_session`); this is
        for checkpoints and for runs that want host-resident sessions
        without running the pool dry."""
        if self.tiers is None or self.slots.session_pages() == 0:
            return 0
        return self._demote(self.slots.session_pages())

    def _demote(self, need: int) -> int:
        before = dataclasses.replace(self.tiers.stats)
        freed = self.slots.reclaim_session(need, self._gather_pages)
        st = self.tiers.stats
        self.stats.demoted_pages += st.demoted - before.demoted
        self.stats.host_evicted_pages += st.evicted - before.evicted
        return freed

    def _chunk_start(self, idx: int, n_prefill: int) -> int:
        """First position slot ``idx``'s chunked prefill must process: the
        shared prefix is skipped, except that the final prompt token must
        run (its logits seed decode), floored to the chunk grid so every
        chunk boundary matches a share-less run (the re-run positions
        rewrite byte-identical KV, into the COW fork when they fall in a
        shared page)."""
        start = getattr(self.slots.slots[idx], "prefill_start", 0)
        if start <= 0:
            return 0
        start = min(start, max(n_prefill - 1, 0))
        return (start // self.prefill_chunk) * self.prefill_chunk

    def _i32(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    def _chunk_tables(self, fused: bool, hi: int):
        """Block-table operand for one chunk step. In the fused mode the
        tables are cut to a power-of-two page bound covering ``hi`` (the
        wave's highest position written or read this step), so chunk
        attention walks only resident pages; pages past the bound hold
        only causally masked positions of the wave's rows, so the cut
        changes no result the engine keeps (spectators' rows are
        dropped)."""
        bt = self.slots.block_tables(self.device)
        if bt is None or not fused:
            return bt
        full = self.slots.max_pages_per_seq
        bound = pow2_bucket(pages_for(hi, self.pool.page_size), hi=full)
        if bound >= full:
            return bt
        return bt[:, :bound].contiguous()

    def _prefill_chunked(
            self, items: list[tuple[int, RequestState]]) -> list[TokenEvent]:
        """Stream all admitted prompts through the chunk-append path, one
        ``(num_slots, chunk)`` call per step; other slots are spectators
        (``chunk_lens == 0`` — nothing written). A re-admitted (preempted)
        request prefills ``prompt + generated``, from its first unshared
        chunk boundary when the prefix index still maps its prefix."""
        c = self.prefill_chunk
        seqs = {idx: state.prefill_tokens() for idx, state in items}
        progress = {idx: self._chunk_start(idx, len(seqs[idx]))
                    for idx, _ in items}
        plens = {idx: max(len(seqs[idx]), 1) for idx, _ in items}
        pp = self.plan.paged
        fused = (self.pool is not None and pp.gather_chunk == "fused"
                 and max(plens.values()) >= pp.fused_threshold)
        final_logits: dict[int, torch.Tensor] = {}
        n_steps = max(-(-(plens[idx] - progress[idx]) // c)
                      for idx, _ in items)
        for _ in range(n_steps):
            tokens = np.zeros((self.num_slots, c), np.int32)
            chunk_lens = np.zeros((self.num_slots,), np.int32)
            lengths = self.slots.lengths()
            hi = 0
            for idx, _state in items:
                done = progress[idx]
                cl = min(plens[idx] - done, c)
                if cl <= 0:
                    continue
                avail = min(max(len(seqs[idx]) - done, 0), cl)
                if avail:
                    tokens[idx, :avail] = seqs[idx][done:done + avail]
                chunk_lens[idx] = cl          # p=0 feeds one pad token
                lengths[idx] = done           # prefill progress, not final P
                hi = max(hi, done + cl)
            logits, self.cache = self.api.prefill_chunk(
                self.ctx, self.params, self._i32(tokens),
                self._i32(chunk_lens), self.cache, self._i32(lengths),
                block_tables=self._chunk_tables(fused, hi))
            for idx, _state in items:
                if chunk_lens[idx]:
                    progress[idx] += int(chunk_lens[idx])
                    if progress[idx] == plens[idx]:
                        final_logits[idx] = logits[idx:idx + 1]
        for idx, _state in items:
            # the full prompt pages now hold real KV: later arrivals (and
            # later levels of this wave) may map them
            self.slots.commit_prefix(idx, seqs[idx])
        return self._first_tokens(items, final_logits)

    def _prefill_batched(
            self, items: list[tuple[int, RequestState]]) -> list[TokenEvent]:
        """One padded ``api.prefill`` call for the whole admission wave
        (flash prefill attention); each row's KV is then copied into its
        slot. Prompts pad to a power-of-two bucket (min
        ``PROMPT_BUCKET``)."""
        seqs = {idx: state.prefill_tokens() for idx, state in items}
        pmax = max(len(s) for s in seqs.values())
        padded = pow2_bucket(
            pmax, lo=PROMPT_BUCKET,
            hi=-(-self.max_seq // PROMPT_BUCKET) * PROMPT_BUCKET)
        toks = np.zeros((self.num_slots, padded), np.int32)
        lens = np.zeros((self.num_slots,), np.int32)
        for row, (idx, _state) in enumerate(items):
            toks[row, :len(seqs[idx])] = seqs[idx]
            lens[row] = len(seqs[idx])
        scratch = self.api.init_cache(DenseLayout(self.num_slots, padded),
                                      device=self.device)
        logits, scratch = self.api.prefill(
            self.ctx, self.params, self._i32(toks), self._i32(lens), scratch)
        span = min(padded, self.max_seq)
        final_logits = {}
        for row, (idx, _state) in enumerate(items):
            for name in ("k", "v"):
                self.cache[name][:, idx, :span] = scratch[name][:, row, :span]
            final_logits[idx] = logits[row:row + 1]
        return self._first_tokens(items, final_logits)

    def _first_tokens(self, items, final_logits) -> list[TokenEvent]:
        toks = self._sample(
            [(final_logits[idx], state) for idx, state in items])
        events = []
        for (idx, state), tok in zip(items, toks):
            state.phase = Phase.RUNNING
            events.append(self._emit(idx, state, tok, wrote_kv=False))
        return events

    # -- decode ----------------------------------------------------------------

    def _grow_or_preempt(self) -> None:
        """Lazy page growth (and COW forks) for every resident sequence:
        a decode tick writes position ``length``, so slot ``i`` must cover
        ``length + 1``, and a shared page holding that position is forked
        before the write. When the pool is dry the scheduler names a
        victim — possibly the growing sequence itself — whose refs are
        dropped and whose state goes back to the queue."""
        for idx, state in list(self.by_slot.items()):
            if self.by_slot.get(idx) is not state:
                continue                      # became a victim this tick
            while True:
                length = self.slots.slots[idx].length
                forks = None
                if self.slots.ensure(idx, length + 1):
                    forks = self.slots.fork_for_write(
                        idx, length, length + 1)
                if forks is not None:
                    for src, dst in forks:
                        self._copy_page(src, dst)
                    break
                self._refresh_shared_lens()
                victim = self.scheduler.pick_victim(
                    list(self.by_slot.values()))
                if victim is None or (victim is state
                                      and len(self.by_slot) == 1):
                    # admission's whole-footprint bound makes a lone
                    # sequence always satisfiable — defensive only
                    raise RuntimeError(
                        "page pool exhausted with no preemptable victim")
                self._preempt(victim)
                if victim is state:
                    break                     # evicted itself; skip growth
        self._note_page_pressure()

    def _decode_tick(self) -> list[TokenEvent]:
        self._grow_or_preempt()
        if not self.by_slot:
            return []
        tokens = np.zeros((self.num_slots,), np.int32)
        for idx, state in self.by_slot.items():
            tokens[idx] = state.tokens[-1]
        gplan = self.slots.group_plan(
            self.plan.paged.group_threshold) if self._group_decode else None
        logits, self.cache = self.api.decode_step(
            self.ctx, self.params, self._i32(tokens), self.cache,
            self.slots.lengths_device(self.device),
            block_tables=self.slots.block_tables(self.device),
            decode_groups=(gplan.operands(self.device)
                           if gplan is not None else None))
        self.stats.weight_bytes_decode_read += self._weight_bytes_per_tick
        if self.pool is not None:
            # decode streams every resident page once per tick, at the
            # stored width: the term kv_dtype shrinks
            pages_read = sum(len(self.slots.slots[i].pages)
                             for i in self.by_slot)
            self.stats.kv_bytes_decode_read += (
                pages_read * self._kv_bytes_per_page)
        if self.ctx.graphs is not None:
            self.stats.graph_captures = self.ctx.graphs.captures
            self.stats.graph_replays = self.ctx.graphs.replays
        if gplan is not None:
            self.stats.grouped_requests += gplan.n_grouped
            self.stats.prefix_kv_bytes_saved += (
                gplan.pages_deduped * self._kv_bytes_per_page)
        rows = list(self.by_slot)
        toks = self._sample(
            [(logits[idx:idx + 1], self.by_slot[idx]) for idx in rows])
        return [self._emit(idx, self.by_slot[idx], tok)
                for idx, tok in zip(rows, toks)]

    def _preempt(self, state: RequestState) -> None:
        idx = state.slot
        self.by_slot.pop(idx, None)
        if self.tiers is not None:
            # demote, don't discard: the victim's full pages move to the
            # session cache (to the host only under pressure), so
            # re-admission promotes instead of re-prefilling them
            length = self.slots.slots[idx].length
            self.slots.retain_session(idx, state.prefill_tokens()[:length])
        else:
            self.slots.release(idx)
        state.phase = Phase.PREEMPTED
        state.slot = None
        state.shared_len = 0          # recomputed if re-admission re-maps
        state.persistable_len = 0
        state.preemptions += 1
        self.stats.preemptions += 1
        self.waiting.append(state)

    def _refresh_shared_lens(self) -> None:
        """Recompute every resident's ``shared_len`` from live refcounts
        right before the scheduler ranks victims: sharing drifts after
        admission, and ``exclusive_len`` must mean the pages an eviction
        reclaims now."""
        if self.prefix is None:
            return
        ps = self.pool.page_size
        for idx, state in self.by_slot.items():
            state.shared_len = ps * sum(
                1 for p in self.slots.slots[idx].pages
                if self.pool.refcount(p) > 1)
            if self.tiers is not None:
                # preemption retains every full page, so a re-admission
                # recomputes only the partial tail past the last boundary
                state.persistable_len = (
                    self.slots.slots[idx].length // ps) * ps

    def _note_page_pressure(self) -> None:
        if self.pool is not None:
            self.stats.peak_pages_used = max(
                self.stats.peak_pages_used, self.pool.used_pages)

    # -- bookkeeping -----------------------------------------------------------

    def _sample(self, rows) -> list[int]:
        """Next token for each ``(logits (1, Vp), state)``: greedy rows in
        one batched argmax and one host read, sampled rows through their
        own generators."""
        out: list[Optional[int]] = [None] * len(rows)
        greedy = [i for i, (_, s) in enumerate(rows)
                  if s.params.temperature <= 0.0]
        if greedy:
            stacked = torch.cat([rows[i][0] for i in greedy])
            picks = mask_vocab(stacked, self.cfg.vocab_size).argmax(-1)
            for i, tok in zip(greedy, picks.tolist()):
                out[i] = tok
        for i, (logits, state) in enumerate(rows):
            if out[i] is None:
                p = state.params
                out[i] = int(sample(
                    logits, state.generator, temperature=p.temperature,
                    top_k=p.top_k, top_p=p.top_p,
                    vocab_size=self.cfg.vocab_size)[0])
        return out

    def _emit(self, idx: int, state: RequestState, tok: int,
              *, wrote_kv: bool = True) -> TokenEvent:
        """Account one sampled token: stop/budget checks, event record,
        slot release on finish. The stop token joins the output only when
        ``SamplingParams.include_stop`` asks for it, and never burns
        ``max_new_tokens`` budget."""
        p = state.params
        if state.first_token_time is None:
            state.first_token_time = time.perf_counter()
            state.first_token_tick = self.ticks
        if tok in p.stop_tokens:
            if p.include_stop:
                state.tokens.append(tok)
                self.slots.tick(idx, wrote_kv=wrote_kv)
            return self._retire(idx, state, FinishReason.STOP)
        state.tokens.append(tok)
        self.slots.tick(idx, wrote_kv=wrote_kv)
        if (state.generated >= p.max_new_tokens
                or self.slots.slots[idx].length >= self.max_seq):
            return self._retire(idx, state, FinishReason.LENGTH)
        ev = TokenEvent(state.rid, tok, state.generated - 1)
        state.events.append(ev)
        return ev

    def _retire(self, idx: int, state: RequestState,
                reason: FinishReason) -> TokenEvent:
        """Release the slot and record the terminal event, which carries
        the last *kept* token (``None`` when the request ends without
        keeping one). With the session cache on, the sequence's full
        pages are retained instead of freed, so the conversation's next
        turn re-maps or promotes them rather than re-prefilling."""
        if self.tiers is not None and self.session_cache:
            length = self.slots.slots[idx].length
            self.slots.retain_session(idx, state.prefill_tokens()[:length])
        else:
            self.slots.release(idx)
        self.by_slot.pop(idx, None)
        state.finish(reason)
        self.stats.finished += 1
        if reason is FinishReason.STOP and not state.params.include_stop:
            ev = TokenEvent(state.rid, None, state.generated,
                            finished=True, finish_reason=reason)
        else:
            ev = TokenEvent(state.rid, state.tokens[-1] if state.tokens
                            else None, max(state.generated - 1, 0),
                            finished=True, finish_reason=reason)
        state.events.append(ev)
        return ev
