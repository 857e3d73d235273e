"""Pluggable scheduling policies: admission order and preemption victims.

The engine owns the *mechanism* (slots, pages, prefill/decode ticks,
preemption plumbing); a :class:`Scheduler` owns the *policy* — in what
order waiting requests are offered admission, whether a blocked head of
queue may be skipped, and which resident sequence is evicted when the page
pool runs dry mid-decode. Policies see only
:class:`~repro_torch.serving.request.RequestState` cost signals (arrival order,
remaining token budget, KV footprint), never device state, so new policies
are a dozen lines.

Built-ins:

  * :class:`FCFS` — strict arrival order, head-of-line blocking (a request
    that cannot be admitted *stops* admission, so later arrivals can never
    overtake it: the no-starvation policy). Victim: newest arrival.

  * :class:`ShortestJobFirst` — order by remaining ``max_new_tokens``
    budget (the paper-adjacent cost-aware policy: short decodes drain
    slots fastest, keeping decode batches full). Skips blocked requests.
    Victim: the longest remaining job.

  * :class:`PageBudgetFair` — order by current KV footprint ascending
    (cheapest-to-host first — maximizes resident request count for a fixed
    page budget). Victim: the largest *exclusive* footprint — prefix
    sharing means evicting a sequence only reclaims pages nobody else
    refcounts, and its shared prefix re-maps (rather than re-prefills) on
    re-admission, so exclusive bytes are both the reclaim value and the
    eviction cost.

Preemption contract: ``pick_victim`` gets *every* resident sequence —
including the one that needs pages this tick, so e.g. FCFS really evicts
the newest arrival even when the newest is the one growing (it then
self-preempts and re-queues). Returning a candidate frees its pages and
re-queues it (state machine: RUNNING -> PREEMPTED -> re-admitted and
re-prefilled later). It must return a candidate when any exist; the
engine guards the lone-resident case itself.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.serving.request import RequestState


class Scheduler:
    """Base policy; subclasses override the two order functions."""

    name = "base"
    #: may admission skip a blocked request and try later arrivals?
    allow_skip = True

    def admission_order(
            self, waiting: Sequence[RequestState]) -> list[RequestState]:
        raise NotImplementedError

    def pick_victim(
            self, candidates: Sequence[RequestState]
    ) -> Optional[RequestState]:
        """Choose the resident sequence to evict; None iff no candidates."""
        raise NotImplementedError


class FCFS(Scheduler):
    name = "fcfs"
    allow_skip = False

    def admission_order(self, waiting):
        return sorted(waiting, key=lambda s: (s.arrival, s.rid))

    def pick_victim(self, candidates):
        # newest arrival loses: the oldest requests keep making progress,
        # so every admitted request eventually finishes (no livelock)
        return max(candidates, key=lambda s: (s.arrival, s.rid),
                   default=None)


class ShortestJobFirst(Scheduler):
    name = "sjf"
    allow_skip = True

    def admission_order(self, waiting):
        return sorted(
            waiting, key=lambda s: (s.remaining_new, s.arrival, s.rid))

    def pick_victim(self, candidates):
        return max(candidates,
                   key=lambda s: (s.remaining_new, s.arrival, s.rid),
                   default=None)


class PageBudgetFair(Scheduler):
    name = "pagefair"
    allow_skip = True

    def admission_order(self, waiting):
        return sorted(
            waiting, key=lambda s: (s.total_len, s.arrival, s.rid))

    def pick_victim(self, candidates):
        # cost signal knows about prefix sharing AND the tiered store:
        # evicting a request only reclaims its *exclusively* owned pages
        # (shared-prefix pages survive through the other owners, and
        # re-admission re-maps them instead of re-prefilling) — so rank
        # victims by exclusive footprint: most pages freed per eviction.
        # Among equals, prefer the victim whose re-admission recomputes
        # the least (``resume_cost``): with a TieredPool, a preemption
        # retains full pages in the session cache, so a sequence whose KV
        # can be demoted-and-promoted is cheaper to evict than one that
        # must re-prefill the same span. Without tiers resume_cost ==
        # exclusive_len and the ranking is unchanged.
        return max(candidates,
                   key=lambda s: (s.exclusive_len, -s.resume_cost, s.rid),
                   default=None)


SCHEDULERS = {
    cls.name: cls for cls in (FCFS, ShortestJobFirst, PageBudgetFair)
}


def get_scheduler(policy) -> Scheduler:
    """Resolve a policy name (or pass through an instance)."""
    if isinstance(policy, Scheduler):
        return policy
    try:
        return SCHEDULERS[policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler {policy!r}; have {sorted(SCHEDULERS)}"
        ) from None
