"""Uniform model API over all five families, keyed by ``cfg.family``.

The dense GQA family (and the VLM backbone that shares it) and the MoE
family, which reuses the dense steps through their block hooks, have the
paged pool and chunked prefill. The recurrent and encoder-decoder
families (ssm: RWKV6; hybrid: Hymba; encdec: Whisper) keep caches of
their own (recurrent state, ring buffers, cross-attention KV), so, as in
the JAX package, they are dense-only and prefill in one shot: their
``supports_paged`` is False and their ``prefill_chunk`` None.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.config import ModelConfig
from repro_torch.models import encdec, hybrid, moe, ssm, transformer

_MODULES = {"dense": transformer, "vlm": transformer, "moe": moe,
            "ssm": ssm, "hybrid": hybrid, "encdec": encdec}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    """One cache-agnostic surface per family: ``decode_step`` and
    ``prefill_chunk`` take an optional ``block_tables`` operand (``None``
    = dense slot addressing, a (B, NB) tensor = the block-paged pool);
    ``supports_paged`` says whether the family's KV admits a
    :class:`~repro_torch.models.kvlayout.PagedLayout`."""

    cfg: ModelConfig
    init_params: Callable         # (generator=None, device="cuda")
    prefill: Callable             # (ctx, params, tokens, lengths, cache)
    decode_step: Callable
    #   (ctx, params, tokens, cache, lengths, *, block_tables=None,
    #    decode_groups=None, positions=None)
    init_cache: Callable          # (layout, device="cuda")
    supports_paged: bool = False
    prefill_chunk: Optional[Callable] = None
    #   (ctx, params, tokens, chunk_lens, cache, lengths, *,
    #    block_tables=None)

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.prefill_chunk is not None


def get_model(cfg: ModelConfig) -> ModelApi:
    mod = _MODULES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family}")
    return ModelApi(
        cfg=cfg,
        init_params=lambda generator=None, device="cuda": mod.init_params(
            cfg, generator, device),
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_cache=lambda layout, device="cuda": mod.init_cache(
            cfg, layout, device=device),
        supports_paged=mod.PAGED_KV,
        prefill_chunk=getattr(mod, "prefill_chunk", None),
    )
