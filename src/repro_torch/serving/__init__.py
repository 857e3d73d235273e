"""Serving: a streaming continuous-batching :class:`Engine` over the dense
slot cache or the block-paged pool, with pluggable schedulers, per-request
sampling and a tiered KV store (:class:`TieredPool`) behind the pool."""
from repro_torch.serving.tiers import TieredPool, TierStats  # noqa: F401
