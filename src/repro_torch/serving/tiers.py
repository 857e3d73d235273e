"""Tiered KV page store: demote, don't discard.

The block pool (:mod:`repro_torch.serving.blockpool`) is **tier 0**: device
memory, the only tier the kernels can address. This module adds the rest
of the hierarchy behind one interface::

    tier 0 (device pool)  ->  tier 1 (host RAM)  ->  tier 2 (disk, optional)

Instead of freeing a victim's KV pages (preemption) or a finished
conversation's prefix pages (retire), the serving stack **demotes** them
here and the :class:`~repro_torch.serving.prefix.PrefixIndex` keeps their
chain-hash keys matchable with a tier tag; a returning session *promotes*
its stored prefix back into fresh tier-0 pages (one bulk host-to-device
copy) instead of recomputing it. Whether the copy beats the recompute is
the plan's ``paged.swap_threshold``
(:func:`repro_torch.core.dispatch.find_swap_threshold`).

Division of labor:

  * :class:`TieredPool` (this module) owns the **slabs**: host copies of
    one page of every cache leaf, keyed by a monotonically increasing
    host id (``hid``). It is content-agnostic: a slab is whatever tuple
    of CPU tensors the engine gathered. Capacity is bounded
    (``host_pages`` / ``disk_pages``); overflow spills LRU-first down the
    hierarchy and **truly evicts** (purging the index entry) only when
    the bottom tier is full or absent.
  * The :class:`~repro_torch.serving.prefix.PrefixIndex` owns the
    **keys**: ``demote_page`` / ``promote_hid`` rebind an entry between a
    tier-0 page id and a ``hid``, so one chain-hash lookup spans the
    whole hierarchy.
  * The engine owns the **copies**: one device gather per demotion
    batch, copied out into a pinned buffer a page, and one bulk
    host-to-device upload per promotion batch
    (``Engine._gather_pages`` / ``_apply_pending_promotions``).

Nothing here touches a device; the tests drive the store with dummy
slabs.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from collections import OrderedDict
from typing import Optional

import torch


@dataclasses.dataclass
class TierStats:
    """Counters for the engine summary."""

    demoted: int = 0          # pages accepted into the hierarchy (tier >= 1)
    promoted: int = 0         # pages popped back toward tier 0
    disk_demotions: int = 0   # host -> disk spills (tier 1 -> 2)
    evicted: int = 0          # pages that fell off the bottom (KV lost;
    #                           the index entry is purged: re-prefill)


@dataclasses.dataclass(frozen=True)
class _Bits:
    """A tensor leaf as the disk tier pickles it: its dtype, its shape and
    its bytes as a numpy uint8 array (torch's own pickling cannot read a
    float8 tensor back, and pickling a view would write the whole batch
    buffer it views)."""

    dtype: str
    shape: tuple
    raw: object


def _to_disk(a):
    if isinstance(a, torch.Tensor):
        flat = a.detach().cpu().contiguous().reshape(-1)
        return _Bits(str(a.dtype).removeprefix("torch."), tuple(a.shape),
                     flat.view(torch.uint8).numpy().copy())
    return a


def _from_disk(a):
    if isinstance(a, _Bits):
        t = torch.from_numpy(a.raw).view(getattr(torch, a.dtype))
        return t.reshape(a.shape)
    return a


class TieredPool:
    """Bounded host (and disk) store for demoted KV page slabs.

    ``demote(slab)`` accepts one page's slab and returns its ``hid``, or
    ``None`` when the hierarchy has nowhere to put it (no host pages and
    no disk tier). Capacity pressure never rejects the new page: it
    spills the **least recently used** resident slab downward instead
    (host -> disk, disk -> gone), because the page being demoted now
    belongs to the most recently active session. ``pop(hid)`` removes and
    returns a slab for promotion; ``drop(hid)`` discards one.

    The optional ``index`` (a :class:`~repro_torch.serving.prefix.
    PrefixIndex`) follows every internal move: a host -> disk spill
    retags the entry (``set_tier``), a true eviction purges it
    (``purge_hid``), so a key never resolves to a slab that is gone.

    The disk tier pickles each slab into ``disk_dir``, a tensor leaf as
    its dtype, shape and raw bytes, so bf16, int8, float8_e4m3fn and f32
    leaves come back bit for bit.
    """

    def __init__(self, host_pages: int, *, index=None,
                 disk_dir: Optional[str] = None, disk_pages: int = 0):
        if host_pages < 0 or disk_pages < 0:
            raise ValueError("tier capacities must be >= 0")
        if disk_pages and not disk_dir:
            raise ValueError("disk_pages > 0 requires disk_dir")
        self.host_pages = host_pages
        self.disk_pages = disk_pages if disk_dir else 0
        self.disk_dir = disk_dir
        self.index = index
        self._host: "OrderedDict[int, tuple]" = OrderedDict()  # hid -> slab
        self._disk: "OrderedDict[int, str]" = OrderedDict()    # hid -> path
        self._next_hid = 0
        self.stats = TierStats()
        if self.disk_pages:
            os.makedirs(disk_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    @property
    def host_used(self) -> int:
        return len(self._host)

    @property
    def disk_used(self) -> int:
        return len(self._disk)

    def ids(self) -> set:
        """Live hids across every tier (the index check's ground truth)."""
        return set(self._host) | set(self._disk)

    def tier_of(self, hid: int) -> int:
        if hid in self._host:
            return 1
        if hid in self._disk:
            return 2
        raise KeyError(f"unknown hid {hid}")

    # -- downward dataflow ---------------------------------------------------

    def demote(self, slab) -> Optional[int]:
        """Admit one page slab; returns its ``hid``, or ``None`` when no
        tier has capacity (the caller then purges the index entry)."""
        hid = self._next_hid
        self._next_hid += 1
        if self.host_pages > 0:
            while len(self._host) >= self.host_pages:
                self._spill_lru()
            self._host[hid] = slab
            self.stats.demoted += 1
            return hid
        if self._disk_store(hid, slab):
            self.stats.demoted += 1
            if self.index is not None:
                self.index.set_tier(hid, 2)
            return hid
        return None

    def _spill_lru(self) -> None:
        """Push the least recently used host slab down one tier."""
        hid, slab = self._host.popitem(last=False)
        if self._disk_store(hid, slab):
            self.stats.disk_demotions += 1
            if self.index is not None:
                self.index.set_tier(hid, 2)
        else:
            self.stats.evicted += 1
            if self.index is not None:
                self.index.purge_hid(hid)

    def _disk_store(self, hid: int, slab) -> bool:
        if not self.disk_pages:
            return False
        while len(self._disk) >= self.disk_pages:
            old, path = self._disk.popitem(last=False)
            os.remove(path)
            self.stats.evicted += 1
            if self.index is not None:
                self.index.purge_hid(old)
        path = os.path.join(self.disk_dir, f"page-{hid}.kv")
        with open(path, "wb") as f:
            pickle.dump(tuple(_to_disk(a) for a in slab), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        self._disk[hid] = path
        return True

    # -- upward dataflow -----------------------------------------------------

    def pop(self, hid: int):
        """Remove and return a slab for promotion back to tier 0."""
        slab = self._host.pop(hid, None)
        if slab is None:
            path = self._disk.pop(hid)   # KeyError on an unknown hid
            with open(path, "rb") as f:
                slab = tuple(_from_disk(a) for a in pickle.load(f))
            os.remove(path)
        self.stats.promoted += 1
        return slab

    def touch(self, hid: int) -> None:
        """Refresh LRU recency (a session re-matched this slab)."""
        if hid in self._host:
            self._host.move_to_end(hid)
        elif hid in self._disk:
            self._disk.move_to_end(hid)

    def drop(self, hid: int) -> None:
        """Discard a slab without promoting it (entry superseded)."""
        if self._host.pop(hid, None) is None:
            path = self._disk.pop(hid, None)
            if path is not None:
                os.remove(path)

    # -- invariants ----------------------------------------------------------

    def check(self) -> None:
        assert len(self._host) <= max(self.host_pages, 0), \
            "host tier over capacity"
        assert len(self._disk) <= self.disk_pages, "disk tier over capacity"
        assert not (set(self._host) & set(self._disk)), \
            "hid resident in two tiers at once"
        for path in self._disk.values():
            assert os.path.exists(path), f"disk slab file missing: {path}"
        if self.index is not None:
            # every index entry pointing into the hierarchy must resolve
            assert self.index.demoted_ids() <= self.ids(), \
                "index maps a hid the tiered store no longer holds"
