"""Dense GQA decoder-only transformer (qwen2 / minitron / deepseek / phi3 /
llama2 families) plus the VLM backbone (internvl2; the stub vision prefix
is not ported).

Layer params and the KV cache are stacked on a leading L axis; a Python
loop over per-layer views replaces the JAX package's ``lax.scan``. KV
writes update the cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx, Params


# ---------------------------------------------------------------------------
# Params and cache
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """Random params drawn on ``device`` from the JAX package's init
    distributions (``layers.dense_init``: normal * fan_in^-1/2, zero
    biases, unit norms). ``generator`` must live on ``device``; ``None``
    seeds one with 0."""
    dev = resolve(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    n = cfg.num_layers
    return {
        **L.embed_params(cfg, gen, dev),
        "layers": {
            "attn_norm": L.norm_params(cfg, (n,), dev),
            "attn": L.attention_params(cfg, gen, n, dev),
            "mlp_norm": L.norm_params(cfg, (n,), dev),
            "mlp": L.mlp_params(cfg, gen, n, dev),
        },
        "final_norm": L.norm_params(cfg, (), dev),
    }


def init_cache(cfg: ModelConfig, layout: DenseLayout, dtype=None,
               device="cuda") -> dict:
    """The dense (L, B, S, HK, Dh) slot cache, zero-filled."""
    shape = layout.kv_shape(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or L.adt(cfg)
    dev = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def decode_block(ctx: LayerCtx, p: Params, x, position, cache_i: dict,
                 lengths):
    """One-token decode block over the dense slot cache (split stages:
    ingest → attend → epilogue → mlp)."""
    q, k, v = L.decode_ingest(ctx, p["attn_norm"], p["attn"], x, position)
    o = L.decode_attend(ctx, q, k, v, cache_i["k"], cache_i["v"], lengths)
    x = L.decode_epilogue(ctx, p["attn"], o, x)
    return L.decode_mlp(ctx, p["mlp_norm"], p["mlp"], x)


def chunk_block(ctx: LayerCtx, p: Params, x, cache_i: dict, lengths,
                chunk_lens):
    """Chunked-prefill block (decode-shaped path)."""
    cfg = ctx.cfg
    h = L.norm(cfg, p["attn_norm"], x)
    x = x + L.attention_chunk_block(ctx, p["attn"], h, cache_i["k"],
                                    cache_i["v"], lengths, chunk_lens)
    h = L.norm(cfg, p["mlp_norm"], x)
    return x + L.mlp_block(ctx, p["mlp"], h)


def prefill_block(ctx: LayerCtx, p: Params, x, positions, cache_i: dict):
    """Full-prompt block: flash prefill attention, and this layer's KV
    written into positions [0, S) of the cache."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h = L.norm(cfg, p["attn_norm"], x)
    q, k, v = L.attention_qkv(ctx, p["attn"], h, positions)
    o = ops.attention_prefill(q, k, v, phi_cfg=ctx.phi_cfg, causal=True,
                              sliding_window=cfg.sliding_window,
                              plan=ctx.plan)
    x = x + ctx.matmul(o.reshape(b, s, cfg.q_dim), p["attn"]["wo"])
    h = L.norm(cfg, p["mlp_norm"], x)
    x = x + L.mlp_block(ctx, p["mlp"], h)
    cache_i["k"][:, :s] = k.to(cache_i["k"].dtype)
    cache_i["v"][:, :s] = v.to(cache_i["v"].dtype)
    return x


# ---------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


def _last_rows(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, 1, D) at position n[b] - 1 (clipped at 0)."""
    idx = (n.long() - 1).clamp(min=0).to(x.device)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict):
    """Process whole prompts (B, S) in one pass, write their KV into the
    cache's positions [0, S) in place, return last-token logits (B, Vp)
    and the cache."""
    x = L.embed(ctx, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: prefill_block(ctx, p_i, xx, positions, c_i))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, _last_rows(x, lengths))[:, 0]
    return logits, cache


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, positions=None):
    """One decode step. tokens (B,) -> logits (B, Vp); the cache is
    updated in place and returned. ``positions`` defaults to
    ``lengths``."""
    x = L.embed(ctx, params, tokens[:, None])          # (B, 1, D)
    position = lengths if positions is None else positions
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: decode_block(ctx, p_i, xx, position, c_i,
                                          lengths))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    return L.lm_logits(ctx, params, x)[:, 0], cache


def prefill_chunk(ctx: LayerCtx, params: Params, tokens, chunk_lens,
                  cache: dict, lengths):
    """One prompt chunk for a whole (possibly ragged) batch: row b consumes
    its first ``chunk_lens[b]`` tokens at positions ``lengths[b]...``;
    rows with ``chunk_lens[b] == 0`` are spectators. Returns per-row
    logits at each row's last chunk position and the cache."""
    x = L.embed(ctx, params, tokens)                   # (B, C, D)
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: chunk_block(ctx, p_i, xx, c_i, lengths,
                                         chunk_lens))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, _last_rows(x, chunk_lens))[:, 0]
    return logits, cache
