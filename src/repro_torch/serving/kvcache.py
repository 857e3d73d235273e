"""Slot-based (dense) KV cache manager for continuous batching.

The device cache is allocated for ``num_slots`` sequences at ``max_seq``
(``api.init_cache``). This manager tracks slot occupancy host-side and
produces the per-tick lengths and rope-position operands; a slot is freed
as soon as its request finishes, so a waiting request can claim it on
the next tick. Every slot reserves ``max_seq`` positions up front
(capacity = slots x worst case); the block-paged alternative comes with
the paged slice of the port.
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
        self.slots = [Slot() for _ in range(num_slots)]
        # device copy of the lengths operand, re-uploaded only when some
        # slot's length changed (assign / release / tick)
        self._len_dev: Optional[torch.Tensor] = None
        self._dirty = True

    def try_assign(self, request_id: int, prompt_len: int,
                   max_new: int) -> Optional[int]:
        if prompt_len + max_new > self.max_seq:
            raise ValueError(
                f"request {request_id} needs {prompt_len + max_new} > "
                f"max_seq {self.max_seq}")
        for i, s in enumerate(self.slots):
            if s.free:
                self.slots[i] = Slot(request_id, prompt_len, 0, max_new)
                self._dirty = True
                return i
        return None

    def release(self, idx: int) -> None:
        self.slots[idx] = Slot()
        self._dirty = True

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
