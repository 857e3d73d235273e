"""KV-storage layouts: the cache-surface descriptor shared by the model
API and the serving engine. This slice ports the dense slot layout; the
block-paged layout comes with the paged slice."""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union


def pow2_bucket(n: int, lo: int = 1, hi: Union[int, None] = None) -> int:
    """Round ``n`` up to a power-of-two bucket (floor ``lo``, capped at
    ``hi``) — the batched-prefill padding rule."""
    b = lo
    while b < n:
        b *= 2
    return b if hi is None else min(b, hi)


@dataclasses.dataclass(frozen=True)
class DenseLayout:
    """Slot-dense KV storage: every slot reserves ``max_seq`` positions;
    position ``p`` of slot ``s`` lives at ``(s, p)``."""

    num_slots: int
    max_seq: int

    kind = "dense"
    is_paged = False

    def kv_shape(self, num_layers: int, kv_heads: int,
                 head_dim: int) -> Tuple[int, int, int, int, int]:
        return (num_layers, self.num_slots, self.max_seq, kv_heads, head_dim)
