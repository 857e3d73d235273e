"""Request lifecycle: sampling parameters, the per-request state machine,
and the streaming token event record.

This replaces the old flat ``Request``/``_Done`` pair with the three
objects the scheduler/engine redesign needs:

  * :class:`SamplingParams` — immutable generation knobs (temperature,
    top-k, top-p, per-request seed, stop tokens, explicit stop-token
    inclusion, token budget).

  * :class:`RequestState` — one mutable record per submitted request,
    walking the machine::

        WAITING -> PREFILLING -> RUNNING -> FINISHED{stop,length,abort}
                        ^            |
                        '- PREEMPTED <'   (pages freed, re-queued,
                                           re-prefilled on re-admission)

    The state owns everything needed to restart after preemption: the
    prompt, every generated token, and the request's own
    ``torch.Generator`` — so no other request's sampling order can
    perturb this one.

  * :class:`TokenEvent` — one streamed token (or terminal marker) from
    ``Engine.generate()`` / ``Engine.step()``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch


class FinishReason(str, enum.Enum):
    STOP = "stop"        # sampled a stop token
    LENGTH = "length"    # max_new_tokens reached or cache/max_seq exhausted
    ABORT = "abort"      # Engine.abort(rid)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class Phase(enum.Enum):
    WAITING = enum.auto()
    PREFILLING = enum.auto()
    RUNNING = enum.auto()
    PREEMPTED = enum.auto()
    FINISHED = enum.auto()


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters (immutable, hashable)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None       # None -> derived from engine seed + rid
    stop_tokens: Tuple[int, ...] = ()
    include_stop: bool = False       # append the stop token to the output?

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")


@dataclasses.dataclass
class RequestState:
    """Mutable lifecycle record for one submitted request."""

    rid: int
    prompt: np.ndarray               # (P,) int32
    params: SamplingParams
    arrival: int                     # admission-order sequence number
    generator: torch.Generator       # private RNG, seeded from (seed, rid)
    phase: Phase = Phase.WAITING
    tokens: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)  # TokenEvents
    finish_reason: Optional[FinishReason] = None
    slot: Optional[int] = None
    preemptions: int = 0
    shared_len: int = 0              # resident prefix positions backed by
    #                                  shared (refcount > 1 at admission)
    #                                  pages — set by the engine at
    #                                  admission, cleared on preemption
    persistable_len: int = 0         # page-aligned resident positions whose
    #                                  KV survives a preemption through the
    #                                  tiered session cache (retained /
    #                                  demoted, not discarded) — refreshed
    #                                  by the engine before victim ranking;
    #                                  stays 0 without a TieredPool
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    first_token_tick: Optional[int] = None

    # -- scheduler-facing cost signals --------------------------------------

    @property
    def generated(self) -> int:
        return len(self.tokens)

    @property
    def remaining_new(self) -> int:
        """Upper bound on decode work left (SJF's cost signal)."""
        return max(self.params.max_new_tokens - self.generated, 0)

    @property
    def total_len(self) -> int:
        """KV positions this request occupies if resident now — the page
        footprint signal (PageBudgetFair)."""
        return len(self.prompt) + self.generated

    @property
    def exclusive_len(self) -> int:
        """Positions backed by pages only this request owns — the
        positions a preemption actually returns to the pool (shared
        prefix pages survive the victim's release, and a re-admission
        re-maps them instead of re-prefilling), so this is both the
        reclaim value and the re-prefill cost of evicting this request."""
        return max(self.total_len - self.shared_len, 0)

    @property
    def resume_cost(self) -> int:
        """Positions a re-admission would actually *recompute*. With a
        tiered KV store, preemption retains every full page (tier-0
        session set, demoted host-ward under pressure), so only the
        positions past ``max(shared_len, persistable_len)`` re-prefill —
        without tiers this degrades to ``exclusive_len`` exactly."""
        keep = max(self.shared_len, self.persistable_len)
        return max(self.total_len - keep, 0)

    # -- lifecycle ----------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.phase is Phase.FINISHED

    def prefill_tokens(self) -> np.ndarray:
        """Tokens to (re-)prefill on admission: the prompt, plus — after a
        preemption — everything generated so far, so the rebuilt KV equals
        what an uninterrupted run would hold."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def finish(self, reason: FinishReason) -> None:
        self.phase = Phase.FINISHED
        self.finish_reason = reason
        self.slot = None


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed generation event.

    ``token is None`` only for a terminal marker with no token attached
    (e.g. an abort before/without a final sample). ``finished`` is True on
    the request's last event, with ``finish_reason`` set.
    """

    rid: int
    token: Optional[int]
    index: int                       # position in the generated stream
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
