"""Uniform model API over all five families, keyed by ``cfg.family``.

The dense GQA family (and the VLM backbone that shares it) and the MoE
family, which reuses the dense steps through their block hooks, have the
paged pool and chunked prefill. The recurrent and encoder-decoder
families (ssm: RWKV6; hybrid: Hymba; encdec: Whisper) keep caches of
their own (recurrent state, ring buffers, cross-attention KV), so, as in
the JAX package, they are dense-only and prefill in one shot: their
``supports_paged`` is False and their ``prefill_chunk`` None. Every
family trains through ``train_loss``; :func:`train_input_specs` and
:func:`make_synthetic_batch` give a cell's train batch, and
:func:`serve_decode_input_specs` / :func:`serve_prefill_input_specs` a
cell's serving inputs (what the dry run, ``launch/dryrun.py``, builds on
the meta device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.models import encdec, hybrid, moe, ssm, transformer
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.stack import tree_map

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
    train_loss: Callable          # (ctx, params, batch, *, remat=True)
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
        train_loss=mod.train_loss,
        prefill=mod.prefill,
        decode_step=mod.decode_step,
        init_cache=lambda layout, device="cuda": mod.init_cache(
            cfg, layout, device=device),
        supports_paged=mod.PAGED_KV,
        prefill_chunk=getattr(mod, "prefill_chunk", None),
    )


# ---------------------------------------------------------------------------
# Train inputs: (shape, dtype) records per (arch x shape) cell
# ---------------------------------------------------------------------------

N_IMAGE_TOKENS = 256  # vision stub: patch embeddings prepended (internvl2)


def n_image_tokens(seq_len: int) -> int:
    """Vision-prefix length; clamped so reduced smoke shapes stay valid."""
    return min(N_IMAGE_TOKENS, max(seq_len // 4, 1))


class InputSpec(NamedTuple):
    """One model input's shape and dtype (the JAX package's
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The train batch of a cell: ``tokens`` / ``labels`` (B, S) int32;
    the VLM's stub frontend prepends ``prefix_embeds`` (B, P, D) and
    shrinks the tokens so the backbone still runs S positions; the
    encoder-decoder's stub frontend gives ``frames`` (B, S, D)."""
    b, s = shape.global_batch, shape.seq_len
    tok = InputSpec((b, s), torch.int32)
    batch = {"tokens": tok, "labels": tok}
    if cfg.frontend == "vision":
        npfx = n_image_tokens(s)
        tok = InputSpec((b, s - npfx), torch.int32)
        batch = {"tokens": tok, "labels": tok,
                 "prefix_embeds": InputSpec((b, npfx, cfg.d_model),
                                            torch.bfloat16)}
    if cfg.family == "encdec":
        batch["frames"] = InputSpec((b, s, cfg.d_model), torch.bfloat16)
    return batch


def serve_decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of one decode step of a cell: ``tokens`` and ``lengths``
    (B,) int32 and the dense (B, S) cache as a tree of specs (the
    family's ``init_cache`` built on the meta device)."""
    b, s = shape.global_batch, shape.seq_len
    cache = get_model(cfg).init_cache(DenseLayout(b, s), device="meta")
    return {
        "tokens": InputSpec((b,), torch.int32),
        "cache": tree_map(lambda t: InputSpec(tuple(t.shape), t.dtype),
                          cache),
        "lengths": InputSpec((b,), torch.int32),
    }


def serve_prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The inputs of one prefill of a cell: ``tokens`` (B, S) and
    ``lengths`` (B,) int32; the VLM's ``prefix_embeds`` (B, P, D), with
    the tokens shrunk by P, and Whisper's ``frames`` (B,
    ``encdec.ENC_FRAMES_SERVE``, D)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": InputSpec((b, s), torch.int32),
             "lengths": InputSpec((b,), torch.int32)}
    if cfg.frontend == "vision":
        npfx = n_image_tokens(s)
        specs["tokens"] = InputSpec((b, s - npfx), torch.int32)
        specs["prefix_embeds"] = InputSpec((b, npfx, cfg.d_model),
                                           torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = InputSpec((b, encdec.ENC_FRAMES_SERVE, cfg.d_model),
                                    torch.bfloat16)
    return specs


def make_synthetic_batch(cfg: ModelConfig,
                         shape_or_specs: Union[ShapeConfig, dict],
                         generator: Optional[torch.Generator] = None,
                         device="cuda") -> dict:
    """A random batch matching the specs, drawn on ``device`` from
    ``generator`` (which must live there; ``None`` seeds one with 0):
    integer inputs uniform over the vocabulary, float inputs normal *
    0.02."""
    specs = (train_input_specs(cfg, shape_or_specs)
             if isinstance(shape_or_specs, ShapeConfig) else shape_or_specs)
    dev = resolve(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, spec in specs.items():
        if spec.dtype.is_floating_point:
            x = torch.randn(spec.shape, generator=gen, device=dev) * 0.02
            out[name] = x.to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, dtype=spec.dtype,
                                      device=dev)
    return out
