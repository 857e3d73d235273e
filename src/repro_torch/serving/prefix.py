"""Prefix index: page-aligned token-chunk hashes -> physical page ids.

N requests that share a system prompt or few-shot header would hold N
identical copies of the same KV pages. This index lets admission *map* a
new request's page-aligned prompt prefix onto pages a resident sequence
already wrote, instead of allocating and re-prefilling them.

Keys are a **hash chain over page-sized token chunks**: chunk ``i``'s key
folds the exact tokens of positions ``[i*PS, (i+1)*PS)`` into the key of
chunk ``i-1``, so a page is shared only when every preceding position
matches too (RoPE and causal attention make KV position-dependent).
Entries also keep the raw chunk tokens and are compared exactly on
lookup, so the current chunk can never alias; ancestry rides in the key
only as a 64-bit hash (two histories alias only on a full ``hash()``
collision of their chains).

Lifecycle contract (enforced by :meth:`check`):

  * Only **full** pages are registered — a partially written tail page
    still receives decode writes and must stay private.
  * An entry is ``pending`` from admission (pages promised, content not
    yet written) until its owner's prefill completes (:meth:`commit`).
    Same-wave followers may map pending pages but must prefill *after*
    the level that writes them (``pending_level``; see ``Engine._admit``).
  * The index holds no refcount of its own: an entry lives exactly as
    long as its page has owners, and :meth:`drop_page` purges it when
    the page returns to the free list, so a key never resolves to a
    recycled page.

**Tiered entries.** With a :class:`~repro_torch.serving.tiers.TieredPool`
behind the pool, an entry outlives its tier-0 page: when a session-cache
page's last device owner lets go, the manager demotes its slab to the
host store and :meth:`demote_page` rebinds the entry from its page id to
the store's ``hid`` (``tier`` 1 = host RAM, 2 = disk). The chain hash
stays matchable: :meth:`match` reports each hit's tier, so admission can
share it (tier 0), promote it (``promote_hid`` rebinds it onto a fresh
tier-0 page once the engine uploads the slab) or re-prefill it (below
the plan's ``swap_threshold``). Only a **true eviction**, the slab
falling off the bottom of the hierarchy, purges a demoted entry
(:meth:`purge_hid`). Demoted entries are always committed: only written,
full pages are demoted.

At decode time :func:`shared_prefix_groups` groups resident slots by the
physical pages of their shared prefix (refcounts alone, no index lookup).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Entry:
    """One registered full page of prefix KV (tier 0: a live device page;
    tier >= 1: a slab handle in the tiered store)."""

    page: Optional[int]               # tier-0 page id; None when demoted
    chunk: Tuple[int, ...]            # exact tokens (collision guard)
    pending_level: Optional[int]      # None = content committed
    tier: int = 0                     # 0 device, 1 host, 2 disk
    hid: Optional[int] = None         # tiered-store handle; None at tier 0


@dataclasses.dataclass
class Match:
    """Result of :meth:`PrefixIndex.match` for one prompt."""

    pages: List[int]                  # matched pages, position order
    #                                   (-1 placeholder for demoted entries)
    pending_level: int                # max pending level matched; -1 if all
    #                                   matched pages are committed
    tail_pending: bool                # is the *last* matched page pending?
    tiers: List[int] = dataclasses.field(default_factory=list)
    hids: List[Optional[int]] = dataclasses.field(default_factory=list)
    pending: List[Optional[int]] = dataclasses.field(default_factory=list)
    #                                   per-entry pending level

    def __len__(self) -> int:
        return len(self.pages)


class PrefixIndex:
    """Chain-hashed map of page-aligned prompt chunks to live pages."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self._entries: Dict[Tuple[int, Tuple[int, ...]], _Entry] = {}
        self._by_page: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._by_hid: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # one admission derives the chain three times (match, register,
        # commit); a small LRU keyed on the token bytes makes that one pass
        self._chain_cache: "OrderedDict[bytes, list]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _chunks(self, tokens: Sequence[int]) -> list:
        """Chain keys, one per FULL page of ``tokens``, cached."""
        toks = np.asarray(tokens).reshape(-1)
        n_full = len(toks) // self.page_size
        if not n_full:
            return []
        toks = np.asarray(toks[:n_full * self.page_size], np.int64)
        blob = toks.tobytes()          # canonical dtype: no value aliasing
        keys = self._chain_cache.get(blob)
        if keys is None:
            keys = []
            parent = 0
            for i in range(n_full):
                chunk = tuple(
                    int(t) for t in
                    toks[i * self.page_size:(i + 1) * self.page_size])
                key = (hash((parent, chunk)), chunk)
                parent = key[0]
                keys.append(key)
            self._chain_cache[blob] = keys
            if len(self._chain_cache) > 16:
                self._chain_cache.popitem(last=False)
        else:
            self._chain_cache.move_to_end(blob)
        return keys

    def match(self, tokens: Sequence[int]) -> Match:
        """Longest indexed page-aligned prefix of ``tokens``; stops at the
        first missing chunk (the chain key makes later hits unreachable)."""
        pages: List[int] = []
        tiers: List[int] = []
        hids: List[Optional[int]] = []
        per_pending: List[Optional[int]] = []
        pending = -1
        tail_pending = False
        for key in self._chunks(tokens):
            e = self._entries.get(key)
            if e is None or e.chunk != key[1]:
                break
            pages.append(e.page if e.page is not None else -1)
            tiers.append(e.tier)
            hids.append(e.hid)
            per_pending.append(e.pending_level)
            tail_pending = e.pending_level is not None
            if e.pending_level is not None:
                pending = max(pending, e.pending_level)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return Match(pages=pages, pending_level=pending,
                     tail_pending=tail_pending, tiers=tiers, hids=hids,
                     pending=per_pending)

    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 *, level: int = 0) -> int:
        """Register every full page of ``tokens`` not indexed yet;
        ``pages[i]`` holds chunk ``i``. New entries are pending at
        ``level`` until :meth:`commit`. Returns how many were added."""
        added = 0
        for i, key in enumerate(self._chunks(tokens)):
            if key in self._entries:
                continue                  # first registrant wins
            page = int(pages[i])
            if page in self._by_page:
                # a page holds exactly one chunk of content; re-keying it
                # would alias two prefixes onto one slab
                continue
            self._entries[key] = _Entry(page, key[1], pending_level=level)
            self._by_page[page] = key
            added += 1
        return added

    def commit(self, tokens: Sequence[int]) -> None:
        """Mark every indexed full page of ``tokens`` as written
        (idempotent; wave ordering guarantees the content is there)."""
        for key in self._chunks(tokens):
            e = self._entries.get(key)
            if e is not None:
                e.pending_level = None

    def drop_page(self, page: int) -> None:
        """Purge the entry for a page returning to the free list."""
        key = self._by_page.pop(page, None)
        if key is not None:
            del self._entries[key]

    # -- tier transitions ----------------------------------------------------

    def demote_page(self, page: int, hid: int, tier: int = 1) -> bool:
        """Rebind a tier-0 entry onto a tiered-store handle: the device
        page is about to be freed but its slab lives on as ``hid``, so
        the key stays matchable. False (no-op) when the page was never
        indexed."""
        key = self._by_page.pop(page, None)
        if key is None:
            return False
        e = self._entries[key]
        e.page = None
        e.tier = tier
        e.hid = hid
        self._by_hid[hid] = key
        return True

    def promote_hid(self, hid: int, page: int) -> None:
        """Rebind a demoted entry onto a fresh tier-0 ``page`` (the engine
        uploads the slab; demoted content is always committed)."""
        key = self._by_hid.pop(hid)
        e = self._entries[key]
        e.page = page
        e.tier = 0
        e.hid = None
        e.pending_level = None
        self._by_page[page] = key

    def set_tier(self, hid: int, tier: int) -> None:
        """Record a move inside the hierarchy (host -> disk spill)."""
        key = self._by_hid.get(hid)
        if key is not None:
            self._entries[key].tier = tier

    def rebind_hid(self, old: int, new: int) -> None:
        """Point a demoted entry at a fresh store handle (an aborted
        promotion pushed the slab back down under a new hid)."""
        key = self._by_hid.pop(old)
        self._by_hid[new] = key
        self._entries[key].hid = new

    def purge_hid(self, hid: int) -> None:
        """True eviction: the slab fell off the bottom tier, so the key
        stops matching (re-prefill is the only way back)."""
        key = self._by_hid.pop(hid, None)
        if key is not None:
            del self._entries[key]

    def demoted_ids(self) -> set:
        return set(self._by_hid)

    # -- invariants ----------------------------------------------------------

    def shared_page_ids(self) -> set:
        return set(self._by_page)

    def check(self, live_pages: set, live_hids: set = frozenset()) -> None:
        """Index invariants (called from ``PagedSlotManager.check``):
        bijection between entries and pages / hids, every indexed page
        alive (or its hid resident in the tiered store), chunks exactly
        one page long, demoted entries committed."""
        assert len(self._entries) == len(self._by_page) + len(self._by_hid), \
            "entry/page/hid maps out of sync"
        for key, e in self._entries.items():
            assert len(e.chunk) == self.page_size, \
                "registered chunk is not exactly one page"
            if e.tier == 0:
                assert e.hid is None, "tier-0 entry carries a hid"
                assert self._by_page.get(e.page) == key, \
                    "page -> key back-pointer broken"
                assert e.page in live_pages, \
                    f"index maps to freed page {e.page}"
            else:
                assert e.page is None, "demoted entry still names a page"
                assert self._by_hid.get(e.hid) == key, \
                    "hid -> key back-pointer broken"
                assert e.hid in live_hids, \
                    f"index maps to evicted hid {e.hid}"
                assert e.pending_level is None, \
                    "demoted entry is pending (unwritten content demoted)"


# -- decode-time group enumeration -------------------------------------------


def shared_prefix_groups(slots, refcount):
    """Group resident slots by the physical pages of their shared prefix.

    A slot's group key is the **maximal leading run** of its block table
    whose pages have ``refcount(page) > 1``: the prefix positions whose KV
    is deduplicated with at least one other owner. Two slots share a
    group iff those runs are the same page list (same pages, same
    order), hence byte-identical prefix KV; runs of different lengths
    give different keys (a group has one prefix length).

    Deriving the key from refcounts keeps the plan right across the page
    lifecycle: a COW fork replaces the writer's page (its run shortens
    and it leaves the group), a release that frees a page ends every
    former sharer's run there, and re-admission after preemption re-maps
    the prefix and rejoins.

    ``slots`` is any sequence with ``.free`` and ``.pages``; ``refcount``
    maps page id -> owner count. Returns ``[(key, member_indices)]`` for
    every key with >= 2 members, in first-seen slot order.
    """
    runs: Dict[tuple, List[int]] = {}
    order: List[tuple] = []
    for i, s in enumerate(slots):
        if s.free or not s.pages:
            continue
        n = 0
        for p in s.pages:
            if refcount(p) > 1:
                n += 1
            else:
                break
        if not n:
            continue
        key = tuple(s.pages[:n])
        if key not in runs:
            runs[key] = []
            order.append(key)
        runs[key].append(i)
    return [(k, runs[k]) for k in order if len(runs[k]) >= 2]
