"""Block-paged KV cache management (host side): a refcounted page pool
with copy-on-write prefix sharing.

A dense ``(num_slots, max_seq)`` cache provisions every slot for the
worst-case sequence, so short requests strand capacity. Here KV storage
is a flat pool of fixed-size pages shared by all sequences; each
sequence owns an ordered list of page ids (its *block table*), and pages
cycle through a LIFO free list.

Pages are **refcounted**, which buys two things on top of plain paging:

  * **Prefix sharing.** Requests with the same page-aligned prompt
    prefix map it onto one physical copy: admission consults a
    :class:`~repro_torch.serving.prefix.PrefixIndex`, bumps the refcount
    of every matched page (:meth:`BlockPool.share`) and prefills only the
    unshared suffix. A page returns to the free list, and leaves the
    index, only when its last owner lets go.
  * **Copy-on-write.** Shared pages are immutable: the first write into
    a page with refcount > 1 forks it (:meth:`PagedSlotManager.
    fork_for_write`): a fresh page, a patched block table, one ref
    dropped on the source; the engine copies the page on the device.

Device layout (``transformer.init_cache`` with a
:class:`~repro_torch.models.kvlayout.PagedLayout`)::

    k/v pool: (num_layers, num_pages, page_size, kv_heads, head_dim)

Position ``p`` of the sequence in slot ``s`` lives at
``(block_tables[s, p // page_size], p % page_size)``. The block tables
are a ``(num_slots, max_pages_per_seq)`` int32 tensor handed to the
model steps — **cached on the device** and rebuilt only when some table
changed (admission, growth, release, COW fork), so a steady decode tick
uploads nothing. Unassigned entries hold the out-of-bounds sentinel
``num_pages``: KV writes through them are dropped and reads clamp to a
real page whose contents the length mask discards, so an empty slot can
never touch a page another sequence owns.

Allocation is **lazy**: admission reserves the pages the prefill will
write (shared prefix excluded) plus one decode growth page, and each
decode tick grows a table page by page through :meth:`ensure`. A pool
can thus be overcommitted; when :meth:`ensure` reports it dry, the
engine's scheduler preempts a victim (refs dropped, request re-queued),
and the block tables make re-admission relocation-free.

Grouped decode reads each shared prefix once per group: the manager's
:meth:`PagedSlotManager.group_plan` turns the refcount-derived groups of
:func:`~repro_torch.serving.prefix.shared_prefix_groups` into a
:class:`GroupPlan`, cached under the block tables' dirty discipline with
its device operands. The JAX package's tiered session cache
(``retain_session`` / ``reclaim_session``) comes with the tiers slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.group_attention import DecodeGroups
from repro_torch.models.kvlayout import pages_for, pow2_bucket
from repro_torch.serving.kvcache import Slot, SlotManager
from repro_torch.serving.prefix import PrefixIndex, shared_prefix_groups


class BlockPool:
    """Refcounted fixed-size page allocator over ``num_pages`` pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO: a just-freed (hot) page is reused first
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._ref: dict[int, int] = {}     # page -> refcount (>= 1)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._ref)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts = what a share-less pool would have used."""
        return sum(self._ref.values())

    def allocated_pages(self) -> set:
        return set(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_for(self, positions: int) -> int:
        return pages_for(positions, self.page_size)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Pop ``n`` pages off the free list (refcount 1 each); None if
        not enough remain."""
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, pages: list[int]) -> None:
        """Add one owner to each (already allocated) page."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"cannot share unallocated page {p}")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: list[int]) -> list[int]:
        """Drop one ref per page; pages reaching refcount 0 return to the
        free list. Returns the pages that died, which the caller purges
        from the prefix index."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"double free / foreign page {p}")
        dead = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
                dead.append(p)
        return dead

    def check(self) -> None:
        """Invariants: every page on exactly one side of the free /
        allocated split, every allocated page with a positive refcount."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert not (free & set(self._ref)), "page both free and allocated"
        assert free | set(self._ref) == set(range(self.num_pages)), \
            "page leaked out of the pool"
        assert all(r >= 1 for r in self._ref.values()), \
            "allocated page with refcount < 1"


@dataclasses.dataclass
class GroupPlan:
    """One decode tick's shared-prefix grouping, host side.

    Built by :meth:`PagedSlotManager.group_plan`, with every dimension
    power-of-two bucketed (groups NG, prefix pages LP, members M). Padding
    groups carry zero counts; padding table entries hold the pool's
    sentinel ``num_pages`` and padding member rows the sentinel ``B``;
    solo rows have ``gid == NG`` and ``prefix_len == 0``.
    :meth:`operands` uploads the arrays once per device and keeps them,
    so a steady tick (same plan) uploads nothing.
    """

    gid: np.ndarray            # (B,)  group id per slot row; NG = solo
    member: np.ndarray         # (B,)  rank within the group; 0 for solo
    prefix_len: np.ndarray     # (B,)  shared positions; 0 = solo
    tables: np.ndarray         # (NG, LP) physical pages of each prefix
    n_pages: np.ndarray        # (NG,) live prefix pages per group
    g_prefix_len: np.ndarray   # (NG,) shared positions per group
    num_members: np.ndarray    # (NG,) live members per group
    member_rows: np.ndarray    # (NG, M) slot row of each member; B = pad
    n_grouped: int             # rows covered by some group
    pages_deduped: int         # sum over groups of (members - 1) * pages
    _operands: dict = dataclasses.field(default_factory=dict, repr=False)

    def operands(self, device) -> DecodeGroups:
        dev = torch.device(device)
        ops = self._operands.get(dev)
        if ops is None:
            ops = DecodeGroups(*(torch.from_numpy(a).to(dev) for a in (
                self.tables, self.n_pages, self.g_prefix_len,
                self.num_members, self.member_rows, self.gid, self.member,
                self.prefix_len)))
            self._operands[dev] = ops
        return ops


@dataclasses.dataclass
class PagedSlot(Slot):
    pages: list = dataclasses.field(default_factory=list)
    # prefix-sharing admission metadata (all zero when sharing is off)
    shared_len: int = 0          # prefix positions mapped onto shared pages
    prefill_start: int = 0       # first position the engine must prefill
    prefill_level: int = 0       # same-wave ordering: prefill after every
    #                              slot whose pending pages this one mapped
    pending_fork: Optional[tuple] = None   # (src, dst): page copy the
    #                              engine owes before this slot's prefill


class PagedSlotManager(SlotManager):
    """Slot occupancy + block tables over a shared :class:`BlockPool`.

    Keeps the ``SlotManager`` tick-loop interface so the engine switches
    cache kinds without touching its loop. Admission needs pages for the
    tokens about to be prefilled plus one growth page, minus whatever
    prefix the :class:`~repro_torch.serving.prefix.PrefixIndex` maps onto
    existing pages (``prefix_index=None`` disables sharing); decode growth
    goes through :meth:`ensure`, writes into shared pages fork through
    :meth:`fork_for_write`, and release drops one ref per page.
    """

    def __init__(self, num_slots: int, max_seq: int, pool: BlockPool,
                 prefix_index: Optional[PrefixIndex] = None):
        self.pool = pool
        self.prefix = prefix_index
        if prefix_index is not None and \
                prefix_index.page_size != pool.page_size:
            raise ValueError("prefix index / pool page_size mismatch")
        self.max_pages_per_seq = pool.pages_for(max_seq)
        # the (num_slots, max_pages_per_seq) block-table operand, cached on
        # the device; rebuilt only when a table changed
        self._bt_cache: Optional[torch.Tensor] = None
        self._bt_dirty = True
        # the group plan is a function of the tables and refcounts, so
        # every event that dirties the tables dirties it too
        self._gp_cache: Optional[tuple] = None
        self._gp_dirty = True
        super().__init__(num_slots, max_seq)

    def _empty_slot(self) -> PagedSlot:
        return PagedSlot()

    def try_assign(self, request_id: int, prompt_len: int, max_new: int,
                   tokens=None) -> Optional[int]:
        idx = super().try_assign(request_id, prompt_len, max_new,
                                 tokens=tokens)
        if idx is not None:
            self._bt_dirty = True
            self._gp_dirty = True
            if self.prefix is not None and tokens is not None:
                # promise this slot's full prompt pages to later arrivals
                # (pending at its wave level until its prefill commits)
                self.prefix.register(
                    tokens, self.slots[idx].pages,
                    level=self.slots[idx].prefill_level)
        return idx

    def _make_slot(self, request_id: int, prompt_len: int, max_new: int,
                   tokens=None) -> Optional[PagedSlot]:
        worst = self.pool.pages_for(prompt_len + max_new)
        if worst > self.pool.num_pages:
            # never satisfiable, not even by an empty pool: raise like the
            # max_seq check (None would livelock admission)
            raise ValueError(
                f"request {request_id} needs {worst} pages > pool size "
                f"{self.pool.num_pages} (page_size {self.pool.page_size})")

        ps = self.pool.page_size
        shared: list[int] = []
        level = 0
        fork_src: Optional[int] = None
        if self.prefix is not None and tokens is not None and prompt_len:
            m = self.prefix.match(tokens)
            shared = list(m.pages)
            if shared and len(shared) * ps == prompt_len:
                # prompt fully covered: the last page must still yield the
                # last-token logits, so the engine re-runs the final chunk.
                # A committed shared tail is forked (the rewrite lands in
                # a private copy); a pending tail has no content to copy
                # yet, so this slot prefills that page itself.
                if m.pending[len(shared) - 1] is None:
                    fork_src = shared[-1]
                shared.pop()
            if m.pending_level >= 0:
                level = m.pending_level + 1
        shared_len = (len(shared) + (1 if fork_src is not None else 0)) * ps

        # lazy: reserve what prefill writes (shared prefix excluded; a COW
        # fork destination counts as a write) plus ONE decode growth page
        # capped at the true footprint — without that headroom a request
        # admitted into a dry pool would be preempted on its first decode
        # write. Further growth goes through ensure().
        need = min(self.pool.pages_for(prompt_len) + 1,
                   self.pool.pages_for(prompt_len + max_new)) - len(shared)
        self.pool.share(shared)
        fresh = self.pool.alloc(need)
        if fresh is None:
            for page in self.pool.free(shared):
                self.prefix.drop_page(page)
            return None
        slot = PagedSlot(request_id, prompt_len, 0, max_new,
                         pages=shared + fresh, shared_len=shared_len,
                         prefill_level=level)
        if fork_src is not None:
            # the table already names the fork destination (fresh[0]); the
            # engine copies the page before prefill, then re-runs the
            # final chunk into it
            slot.pending_fork = (fork_src, fresh[0])
        slot.prefill_start = min(shared_len, prompt_len)
        return slot

    def ensure(self, idx: int, positions: int) -> bool:
        """Grow slot ``idx``'s table to cover ``positions`` KV entries.
        False = the pool is dry (the caller preempts and retries); the
        slot's pages are untouched either way."""
        s = self.slots[idx]
        need = self.pool.pages_for(positions) - len(s.pages)
        if need <= 0:
            return True
        got = self.pool.alloc(need)
        if got is None:
            return False
        s.pages.extend(got)
        self._bt_dirty = True
        self._gp_dirty = True
        return True

    def fork_for_write(self, idx: int, start: int, end: int):
        """Before slot ``idx`` writes positions ``[start, end)``, fork every
        covered page whose refcount > 1: a private destination, a patched
        table, one ref dropped on the source. Returns the ``(src, dst)``
        page copies the engine owes, or None when the pool is dry — with
        no side effect, since every destination is reserved up front."""
        s = self.slots[idx]
        ps = self.pool.page_size
        to_fork: list[int] = []
        for pi in range(start // ps, (max(end, start + 1) - 1) // ps + 1):
            if pi >= len(s.pages):
                break                    # growth is ensure()'s job
            if self.pool.refcount(s.pages[pi]) > 1:
                to_fork.append(pi)
        if not to_fork:
            return []
        dsts = self.pool.alloc(len(to_fork))
        if dsts is None:
            return None
        out: list[tuple[int, int]] = []
        for pi, dst in zip(to_fork, dsts):
            src = s.pages[pi]
            for page in self.pool.free([src]):
                if self.prefix is not None:
                    self.prefix.drop_page(page)
            s.pages[pi] = dst
            out.append((src, dst))
        self._bt_dirty = True
        self._gp_dirty = True
        return out

    def commit_prefix(self, idx: int, tokens) -> None:
        """Prefill for slot ``idx`` completed: its full prompt pages hold
        real KV, so their pending index entries become matchable."""
        if self.prefix is not None:
            self.prefix.commit(tokens)

    def release(self, idx: int) -> None:
        s = self.slots[idx]
        if s.pages:
            for page in self.pool.free(s.pages):
                if self.prefix is not None:
                    self.prefix.drop_page(page)
            self._bt_dirty = True
            self._gp_dirty = True
        super().release(idx)

    def block_tables(self, device) -> torch.Tensor:
        """The (num_slots, max_pages_per_seq) int32 block-table operand on
        ``device``, cached: the same tensor until some table changes.
        Unassigned entries hold the sentinel ``num_pages``."""
        if self._bt_dirty or self._bt_cache is None \
                or self._bt_cache.device != torch.device(device):
            bt = np.full((len(self.slots), self.max_pages_per_seq),
                         self.pool.num_pages, np.int32)
            for i, s in enumerate(self.slots):
                if s.pages:
                    bt[i, :len(s.pages)] = s.pages
            self._bt_cache = torch.from_numpy(bt).to(device)
            self._bt_dirty = False
        return self._bt_cache

    def group_plan(self, threshold: int = 2) -> Optional[GroupPlan]:
        """This tick's shared-prefix grouping, or None when no group is
        worth dispatching; cached until some table or refcount changes,
        so a steady tick reuses one plan and its device operands.

        A group is kept only with >= 2 members whose deduplicated work
        ``members * prefix_pages`` reaches ``threshold`` (the plan's
        ``group_threshold``). A member must already hold its whole shared
        prefix (``length >= prefix_len``); a resident still prefilling is
        left solo rather than read past its valid KV.
        """
        if not self._gp_dirty and self._gp_cache is not None \
                and self._gp_cache[0] == threshold:
            return self._gp_cache[1]
        plan = self._build_group_plan(threshold)
        self._gp_cache = (threshold, plan)
        self._gp_dirty = False
        return plan

    def _build_group_plan(self, threshold: int) -> Optional[GroupPlan]:
        ps = self.pool.page_size
        kept = []
        for key, members in shared_prefix_groups(self.slots,
                                                 self.pool.refcount):
            plen = len(key) * ps
            live = [i for i in members if self.slots[i].length >= plen]
            if len(live) >= 2 and len(live) * len(key) >= threshold:
                kept.append((key, live))
        if not kept:
            return None
        b = len(self.slots)
        ng = pow2_bucket(len(kept))
        lp = pow2_bucket(max(len(k) for k, _ in kept),
                         hi=self.max_pages_per_seq)
        m = pow2_bucket(max(len(ms) for _, ms in kept), hi=b)
        tables = np.full((ng, lp), self.pool.num_pages, np.int32)
        n_pages = np.zeros(ng, np.int32)
        g_prefix_len = np.zeros(ng, np.int32)
        num_members = np.zeros(ng, np.int32)
        member_rows = np.full((ng, m), b, np.int32)
        gid = np.full(b, ng, np.int32)          # NG = solo sentinel
        member = np.zeros(b, np.int32)
        prefix_len = np.zeros(b, np.int32)
        n_grouped = pages_deduped = 0
        for g, (key, live) in enumerate(kept):
            tables[g, :len(key)] = key
            n_pages[g] = len(key)
            g_prefix_len[g] = len(key) * ps
            num_members[g] = len(live)
            member_rows[g, :len(live)] = live
            for r, i in enumerate(live):
                gid[i], member[i], prefix_len[i] = g, r, len(key) * ps
            n_grouped += len(live)
            pages_deduped += (len(live) - 1) * len(key)
        return GroupPlan(gid=gid, member=member, prefix_len=prefix_len,
                         tables=tables, n_pages=n_pages,
                         g_prefix_len=g_prefix_len,
                         num_members=num_members, member_rows=member_rows,
                         n_grouped=n_grouped, pages_deduped=pages_deduped)

    def check(self) -> None:
        """Cross-structure invariants: pool conservation, and refcounts
        equal to the ownership multiset across the slots' block tables."""
        self.pool.check()
        owned: dict[int, int] = {}
        for s in self.slots:
            if s.free:
                assert not s.pages, "free slot still holds pages"
            assert len(set(s.pages)) == len(s.pages), \
                "one slot maps the same page twice (fork aliased)"
            for p in s.pages:
                owned[p] = owned.get(p, 0) + 1
        assert {p: self.pool.refcount(p) for p in owned} == owned, \
            "refcounts out of sync with slot ownership multiset"
        assert set(owned) == self.pool.allocated_pages(), \
            "pool used-set out of sync with slot block tables"
        if self.prefix is not None:
            self.prefix.check(self.pool.allocated_pages())
