"""Uniform model API keyed by ``cfg.family``.

The port has the dense GQA family (and the VLM backbone that shares it)
and the MoE family, which reuses the dense steps through their block
hooks; the other families raise ``NotImplementedError`` naming the slice
of the port that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.config import ModelConfig
from repro_torch.models import moe, transformer

_LATER = {
    "ssm": "slice 7 (other families: models/ssm.py)",
    "hybrid": "slice 7 (other families: models/hybrid.py)",
    "encdec": "slice 7 (other families: models/encdec.py)",
}


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
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER[cfg.family]}")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(f"unknown family {cfg.family}")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} comes with slice 7 (encdec); the dense "
            "and MoE families use rmsnorm")
    mod = moe if cfg.family == "moe" else transformer
    return ModelApi(
        cfg=cfg,
        init_params=lambda generator=None, device="cuda": mod.init_params(
            cfg, generator, device),
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_cache=lambda layout, device="cuda": mod.init_cache(
            cfg, layout, device=device),
        supports_paged=mod.PAGED_KV,
        prefill_chunk=mod.prefill_chunk,
    )
