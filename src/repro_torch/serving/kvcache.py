"""Slot-based (dense) KV cache manager for continuous batching.

The device cache is allocated for ``num_slots`` sequences at ``max_seq``
(``api.init_cache``). This manager tracks slot occupancy host-side and
produces the per-tick lengths and rope-position operands; a slot is freed
as soon as its request finishes, so a waiting request can claim it on
the next tick. Every slot reserves ``max_seq`` positions up front
(capacity = slots x worst case); the block-paged alternative
(:mod:`repro_torch.serving.blockpool`) overrides the storage hooks
below, and the engine selects between them with ``cache_kind``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Slot:
    request_id: Optional[int] = None
    length: int = 0                  # valid positions in the cache
    generated: int = 0
    max_new: int = 0

    @property
    def free(self) -> bool:
        return self.request_id is None


class SlotManager:
    def __init__(self, num_slots: int, max_seq: int):
        self.max_seq = max_seq
        self.slots = [self._empty_slot() for _ in range(num_slots)]
        # device copy of the lengths operand, re-uploaded only when some
        # slot's length changed (assign / release / tick)
        self._len_dev: Optional[torch.Tensor] = None
        self._dirty = True

    # hooks overridden by the paged manager (blockpool.PagedSlotManager)
    def _empty_slot(self) -> Slot:
        return Slot()

    def _make_slot(self, request_id: int, prompt_len: int, max_new: int,
                   tokens=None) -> Optional[Slot]:
        """The slot record for an admitted request; None = the backing
        storage (a page pool) cannot host it now. ``tokens`` is the exact
        prefill token sequence, which the paged manager matches against
        its prefix index; dense slots ignore it."""
        return Slot(request_id, prompt_len, 0, max_new)

    def try_assign(self, request_id: int, prompt_len: int, max_new: int,
                   tokens=None) -> Optional[int]:
        if prompt_len + max_new > self.max_seq:
            raise ValueError(
                f"request {request_id} needs {prompt_len + max_new} > "
                f"max_seq {self.max_seq}")
        for i, s in enumerate(self.slots):
            if s.free:
                new = self._make_slot(request_id, prompt_len, max_new,
                                      tokens=tokens)
                if new is None:
                    return None
                self.slots[i] = new
                self._dirty = True
                return i
        return None

    def release(self, idx: int) -> None:
        self.slots[idx] = self._empty_slot()
        self._dirty = True

    def ensure(self, idx: int, positions: int) -> bool:
        """Grow slot ``idx``'s storage to ``positions`` KV entries. Dense
        slots pre-reserve ``max_seq``; the paged manager allocates pages
        lazily and returns False when the pool is dry."""
        return positions <= self.max_seq

    def fork_for_write(self, idx: int, start: int, end: int):
        """Copy-on-write hook before writing positions [start, end): dense
        slots are never shared, so nothing to copy. The paged manager
        returns the (src, dst) page copies the engine owes the pool, or
        None when the pool is dry."""
        return []

    def commit_prefix(self, idx: int, tokens) -> None:
        """Prefill-completion hook (prefix-index bookkeeping); no-op for
        dense slots."""

    def block_tables(self, device):
        """The layout's addressing operand for the model steps: None for
        dense slots; the paged manager's (num_slots, max_pages_per_seq)
        int32 logical→physical page map."""
        return None

    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self.slots], np.int32)

    def lengths_device(self, device) -> torch.Tensor:
        """The (num_slots,) int32 lengths operand as a cached device
        tensor. The next decode token lands at position ``length``, so the
        same tensor is also the rope-position operand."""
        if self._dirty or self._len_dev is None:
            self._len_dev = torch.from_numpy(self.lengths()).to(device)
            self._dirty = False
        return self._len_dev

    def tick(self, idx: int, *, wrote_kv: bool = True) -> None:
        """Account one emitted token. ``wrote_kv=False`` for the token that
        comes out of prefill itself (its KV lands in the cache only on the
        next decode tick, which scatters at the current length)."""
        s = self.slots[idx]
        if wrote_kv:
            s.length += 1
            self._dirty = True
        s.generated += 1
