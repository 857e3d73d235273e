"""KV-storage layouts: the cache-surface descriptor shared by the model
API and the serving engine.

  * :class:`DenseLayout` — the slot cache ``(L, num_slots, max_seq, HK,
    Dh)``; position ``p`` of slot ``s`` lives at ``(s, p)``.
  * :class:`PagedLayout` — a block-paged pool ``(L, num_pages, page_size,
    HK, Dh)`` shared by every sequence; position ``p`` of slot ``s`` lives
    at ``(block_tables[s, p // page_size], p % page_size)``. The model
    steps take the engine's block tables as an optional ``block_tables``
    operand and pick the paged addressing when it is present. Its pages
    hold bf16 values or, with ``kv_dtype`` ``"int8"`` / ``"fp8"``, 1-byte
    codes beside one f32 step per (layer, page, kv head)
    (:mod:`repro_torch.serving.kvquant`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from repro_torch.kernels.quant import KV_DTYPES


def pages_for(positions: int, page_size: int) -> int:
    """Pages needed to store ``positions`` KV entries (the one page
    ceil-div, shared by the allocator and the engine's pool sizing)."""
    return -(-max(positions, 0) // page_size)


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


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Block-paged KV storage: a shared pool of fixed-size pages addressed
    through per-sequence block tables. ``kv_dtype`` (:data:`KV_DTYPES`)
    is the pages' storage precision: ``"bf16"`` values, or ``"int8"`` /
    ``"fp8"`` codes with a :meth:`scale_shape` step pool beside each of
    K and V."""

    num_pages: int
    page_size: int
    kv_dtype: str = "bf16"

    kind = "paged"
    is_paged = True

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")

    def kv_shape(self, num_layers: int, kv_heads: int,
                 head_dim: int) -> Tuple[int, int, int, int, int]:
        return (num_layers, self.num_pages, self.page_size, kv_heads,
                head_dim)

    def scale_shape(self, num_layers: int,
                    kv_heads: int) -> Tuple[int, int, int]:
        """The f32 step pool of a quantized layout: one step per (layer,
        page, kv head)."""
        return (num_layers, self.num_pages, kv_heads)

    def pages_for(self, positions: int) -> int:
        return pages_for(positions, self.page_size)


KVLayout = Union[DenseLayout, PagedLayout]


def require_dense(layout: KVLayout, family: str) -> DenseLayout:
    """The layout, which must be the dense slot layout: the recurrent and
    encoder-decoder families' caches (recurrent state, a ring buffer,
    cross-attention KV) have no paged form."""
    if layout.is_paged:
        raise ValueError(f"family {family!r} has no paged-KV path "
                         "(recurrent/ring state caches); use "
                         "cache_kind='dense'")
    return layout
