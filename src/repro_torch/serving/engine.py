"""Streaming continuous-batching engine over the dense slot cache.

The port of the JAX package's ``serving/engine.py`` for
``cache_kind="dense"`` (the block-paged pool, prefix sharing and the
tiered KV store come with later slices):

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
  * **One dispatch surface.** Every kernel decision rides in the single
    ``plan=`` operand; plans change which kernel runs, never the tokens.

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
from repro_torch.core.plan import DEFAULT_PLAN, ExecutionPlan
from repro_torch.device import resolve
from repro_torch.models.api import get_model
from repro_torch.models.kvlayout import DenseLayout, pow2_bucket
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves
from repro_torch.serving.kvcache import SlotManager
from repro_torch.serving.request import (FinishReason, Phase, RequestState,
                                         SamplingParams, TokenEvent)
from repro_torch.serving.sampling import mask_vocab, sample
from repro_torch.serving.scheduler import Scheduler, get_scheduler

PROMPT_BUCKET = 64
DEFAULT_PREFILL_CHUNK = 64

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
        prefill_chunk: int = DEFAULT_PREFILL_CHUNK,
        scheduler: Union[str, Scheduler] = "fcfs",
        plan: Optional[ExecutionPlan] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve(device)
        if cache_kind != "dense":
            raise NotImplementedError(
                f"cache_kind={cache_kind!r} comes with slice 2 (paged KV) "
                "of the port; use cache_kind='dense'")
        leaf = tree_leaves(params)[0]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.plan = plan if plan is not None else DEFAULT_PLAN
        self.ctx = LayerCtx(cfg=cfg, plan=self.plan)
        self.params = params
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.scheduler = get_scheduler(scheduler)
        self.prefill_chunk = (
            prefill_chunk if self.api.supports_chunked_prefill else 0)
        self.cache_kind = cache_kind
        self.layout = DenseLayout(num_slots, max_seq)
        self.slots = SlotManager(num_slots, max_seq)
        self.cache = self.api.init_cache(self.layout, device=self.device)

        self.seed = seed
        self.requests: dict[int, RequestState] = {}
        self.waiting: list[RequestState] = []
        self.by_slot: dict[int, RequestState] = {}
        self.stats = EngineStats()
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
        """Cancel a request in any phase; frees its slot at once. Returns
        False if unknown or already finished."""
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
        """Offer slots to waiting requests in the scheduler's order and
        prefill the admitted wave in one batch."""
        if not self.waiting:
            return []
        admitted: list[tuple[int, RequestState]] = []
        for state in self.scheduler.admission_order(self.waiting):
            toks = state.prefill_tokens()
            idx = self.slots.try_assign(
                state.rid, len(toks),
                max(state.params.max_new_tokens - state.generated, 1))
            if idx is None:
                if not self.scheduler.allow_skip:
                    break      # head-of-line blocking (FCFS no-starvation)
                continue
            state.phase = Phase.PREFILLING
            state.slot = idx
            self.by_slot[idx] = state
            admitted.append((idx, state))
            self.stats.admitted += 1
        if not admitted:
            return []
        self.waiting = [s for s in self.waiting if s.slot is None]
        if self.prefill_chunk:
            return self._prefill_chunked(admitted)
        return self._prefill_batched(admitted)

    def _i32(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    def _prefill_chunked(
            self, items: list[tuple[int, RequestState]]) -> list[TokenEvent]:
        """Stream all admitted prompts through the chunk-append path, one
        ``(num_slots, chunk)`` call per step; other slots are spectators
        (``chunk_lens == 0`` — nothing written)."""
        c = self.prefill_chunk
        seqs = {idx: state.prefill_tokens() for idx, state in items}
        progress = {idx: 0 for idx, _ in items}
        plens = {idx: max(len(seqs[idx]), 1) for idx, _ in items}
        final_logits: dict[int, torch.Tensor] = {}
        n_steps = max(-(-plens[idx] // c) for idx, _ in items)
        for _ in range(n_steps):
            tokens = np.zeros((self.num_slots, c), np.int32)
            chunk_lens = np.zeros((self.num_slots,), np.int32)
            lengths = self.slots.lengths()
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
            logits, self.cache = self.api.prefill_chunk(
                self.ctx, self.params, self._i32(tokens),
                self._i32(chunk_lens), self.cache, self._i32(lengths))
            for idx, _state in items:
                if chunk_lens[idx]:
                    progress[idx] += int(chunk_lens[idx])
                    if progress[idx] == plens[idx]:
                        final_logits[idx] = logits[idx:idx + 1]
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

    def _decode_tick(self) -> list[TokenEvent]:
        tokens = np.zeros((self.num_slots,), np.int32)
        for idx, state in self.by_slot.items():
            tokens[idx] = state.tokens[-1]
        logits, self.cache = self.api.decode_step(
            self.ctx, self.params, self._i32(tokens), self.cache,
            self.slots.lengths_device(self.device))
        rows = list(self.by_slot)
        toks = self._sample(
            [(logits[idx:idx + 1], self.by_slot[idx]) for idx in rows])
        return [self._emit(idx, self.by_slot[idx], tok)
                for idx, tok in zip(rows, toks)]

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
        keeping one)."""
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
