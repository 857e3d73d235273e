"""Dense GQA decoder-only transformer (qwen2 / minitron / deepseek / phi3 /
llama2 families) plus the VLM backbone (internvl2; the stub vision prefix
is not ported).

Layer params and the KV cache are stacked on a leading L axis; a Python
loop over per-layer views replaces the JAX package's ``lax.scan``. KV
writes update the cache in place. The cache is either the dense slot
cache or the block-paged pool (:mod:`repro_torch.models.kvlayout`);
``decode_step`` and ``prefill_chunk`` take the engine's block tables as
``block_tables`` and address the pool through them when given. Under
the ``"looped"`` decode granularity on the card, ``decode_step`` replays
one CUDA graph of the whole step (:class:`stack.LoopedDecode`). A
quantized pool (``PagedLayout.kv_dtype`` int8 / fp8) adds the
``k_scale`` / ``v_scale`` step pools to the cache; its appends go
through the quantized scatter (:class:`kvquant.QuantWrite`).

The steps take the JAX package's block hooks (``layer_params_fn``,
``prefill_block_fn``, ``decode_block_fn``, ``chunk_block_fn``), through
which the MoE family (:mod:`repro_torch.models.moe`) swaps the MLP half
of each block and reuses the rest of this module.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops, quant
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models.kvlayout import KVLayout
from repro_torch.models.layers import LayerCtx, Params
from repro_torch.serving import kvquant

# the (L, B, S, HK, Dh) cache admits the block-paged layout
PAGED_KV = True


# ---------------------------------------------------------------------------
# Params and cache
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, gen: torch.Generator, n: int,
                 device) -> Params:
    """The dense block's params, stacked over ``n`` layers."""
    return {
        "attn_norm": L.norm_params(cfg, (n,), device),
        "attn": L.attention_params(cfg, gen, n, device),
        "mlp_norm": L.norm_params(cfg, (n,), device),
        "mlp": L.mlp_params(cfg, gen, n, device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", layer_params_fn: Optional[Callable] = None
                ) -> Params:
    """Random params drawn on ``device`` from the JAX package's init
    distributions (``layers.dense_init``: normal * fan_in^-1/2, zero
    biases, unit norms). ``generator`` must live on ``device``; ``None``
    seeds one with 0. ``layer_params_fn(cfg, gen, num_layers, device)``
    builds the stacked layer params (default: the dense block's)."""
    dev = resolve(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    lp = layer_params_fn or layer_params
    return {
        **L.embed_params(cfg, gen, dev),
        "layers": lp(cfg, gen, cfg.num_layers, dev),
        "final_norm": L.norm_params(cfg, (), dev),
    }


def init_cache(cfg: ModelConfig, layout: KVLayout, dtype=None,
               device="cuda") -> dict:
    """KV storage for a layout, zero-filled: the dense (L, B, S, HK, Dh)
    slot cache or the (L, NP, PS, HK, Dh) page pool. A quantized paged
    layout stores code pools in its spec's code dtype and adds the
    (L, NP, HK) f32 step pools ``k_scale`` / ``v_scale``."""
    shape = layout.kv_shape(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or L.adt(cfg)
    dev = resolve(device)
    spec = quant.spec_for(getattr(layout, "kv_dtype", "bf16"))
    if spec is not None:
        dtype = spec.code_dtype
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if spec is not None:
        sshape = layout.scale_shape(cfg.num_layers, cfg.num_kv_heads)
        for name in (kvquant.K_SCALE, kvquant.V_SCALE):
            cache[name] = torch.zeros(sshape, dtype=torch.float32,
                                      device=dev)
    return cache


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def decode_block(ctx: LayerCtx, p: Params, x, position, cache_i: dict,
                 lengths, block_tables=None, write=None, decode_groups=None):
    """One-token decode block (stages: ingest → attend → epilogue → mlp,
    split or fused as the plan says) over the dense slot cache, or over
    the page pool when ``block_tables`` is given (``write``: the step's KV
    placement; ``decode_groups``: the shared-prefix group plan's
    operands)."""
    x = decode_attention_half(ctx, p, x, position, cache_i, lengths,
                              block_tables, write, decode_groups)
    return L.decode_mlp(ctx, p["mlp_norm"], p["mlp"], x)


def decode_attention_half(ctx: LayerCtx, p: Params, x, position,
                          cache_i: dict, lengths, block_tables=None,
                          write=None, decode_groups=None):
    """Stages A-C of a decode block (ingest → attend → epilogue): x plus
    this layer's attention, the KV appended in place."""
    q, k, v = L.decode_ingest(ctx, p["attn_norm"], p["attn"], x, position)
    if block_tables is None:
        o = L.decode_attend(ctx, q, k, v, cache_i["k"], cache_i["v"],
                            lengths)
    else:
        o = L.decode_attend_paged(ctx, q, k, v, cache_i["k"], cache_i["v"],
                                  block_tables, lengths, write,
                                  decode_groups=decode_groups,
                                  k_scale=cache_i.get(kvquant.K_SCALE),
                                  v_scale=cache_i.get(kvquant.V_SCALE))
    return L.decode_epilogue(ctx, p["attn"], o, x)


def chunk_block(ctx: LayerCtx, p: Params, x, cache_i: dict, lengths,
                write, block_tables=None, chunk_lens=None):
    """Chunked-prefill block (decode-shaped path) over either layout."""
    x = chunk_attention_half(ctx, p, x, cache_i, lengths, write,
                             block_tables, chunk_lens)
    h = L.norm(ctx.cfg, p["mlp_norm"], x)
    return x + L.mlp_block(ctx, p["mlp"], h)


def chunk_attention_half(ctx: LayerCtx, p: Params, x, cache_i: dict,
                         lengths, write, block_tables=None, chunk_lens=None):
    """A chunk block's attention half: x plus the chunk's attention over
    prefix and chunk, the chunk's KV appended in place."""
    h = L.norm(ctx.cfg, p["attn_norm"], x)
    return x + L.attention_chunk_block(
        ctx, p["attn"], h, cache_i["k"], cache_i["v"], lengths, write,
        block_tables, k_scale=cache_i.get(kvquant.K_SCALE),
        v_scale=cache_i.get(kvquant.V_SCALE), chunk_lens=chunk_lens)


def prefill_block(ctx: LayerCtx, p: Params, x, positions, cache_i: dict):
    """Full-prompt block: flash prefill attention, and this layer's KV
    written into positions [0, S) of the cache."""
    x = prefill_attention_half(ctx, p, x, positions, cache_i)
    h = L.norm(ctx.cfg, p["mlp_norm"], x)
    return x + L.mlp_block(ctx, p["mlp"], h)


def prefill_attention_half(ctx: LayerCtx, p: Params, x, positions,
                           cache_i: dict):
    """A full-prompt block's attention half: x plus flash prefill
    attention, this layer's KV written into positions [0, S)."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h = L.norm(cfg, p["attn_norm"], x)
    q, k, v = L.attention_qkv(ctx, p["attn"], h, positions)
    o = ops.attention_prefill(q, k, v, phi_cfg=ctx.phi_cfg, causal=True,
                              sliding_window=cfg.sliding_window,
                              plan=ctx.plan)
    cache_i["k"][:, :s] = k.to(cache_i["k"].dtype)
    cache_i["v"][:, :s] = v.to(cache_i["v"].dtype)
    return x + ctx.matmul(o.reshape(b, s, cfg.q_dim), p["attn"]["wo"])


# ---------------------------------------------------------------------------
# Serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------


def _last_rows(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, 1, D) at position n[b] - 1 (clipped at 0)."""
    idx = (n.long() - 1).clamp(min=0).to(x.device)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict, *,
            prefill_block_fn: Callable = prefill_block):
    """Process whole prompts (B, S) in one pass, write their KV into the
    cache's positions [0, S) in place, return last-token logits (B, Vp)
    and the cache."""
    x = L.embed(ctx, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: prefill_block_fn(ctx, p_i, xx, positions, c_i))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, _last_rows(x, lengths))[:, 0]
    return logits, cache


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, block_tables=None, decode_groups=None, positions=None,
                decode_block_fn: Callable = decode_block):
    """One decode step. tokens (B,) -> logits (B, Vp); the cache is
    updated in place and returned. With ``block_tables`` (B, NB) the
    cache leaves are page pools; empty slots (all-sentinel table rows)
    write nothing. ``decode_groups`` (paged only, a
    :class:`~repro_torch.kernels.group_attention.DecodeGroups`) reads
    each shared prefix once per group. ``positions`` defaults to
    ``lengths``.

    Under the ``"looped"`` granularity on CUDA tensors the step runs
    through the context's :class:`~repro_torch.models.stack.LoopedDecode`:
    eagerly on a shape key's first call, by CUDA-graph replay after, so
    the returned logits live in the graph's static buffer until its next
    replay. On CPU tensors looped runs the fused path eagerly.
    ``decode_block_fn`` (the MoE family's hook) runs each layer; the
    looped graph captures whatever it launches."""
    if decode_groups is not None and block_tables is None:
        raise ValueError("decode_groups needs the paged layout "
                         "(block_tables)")
    inputs = dict(tokens=tokens, lengths=lengths, block_tables=block_tables,
                  decode_groups=decode_groups, positions=positions)
    step = functools.partial(_decode_step, ctx, params, cache,
                             decode_block_fn)
    if ctx.graphs is not None and tokens.is_cuda:
        anchors = tuple(t.data_ptr() for t in stack.tree_leaves(params)
                        + stack.tree_leaves(cache))
        return ctx.graphs.run(step, inputs, anchors), cache
    return step(**inputs), cache


def _paged_write(cache: dict, block_tables, lengths, chunk_lens, c: int):
    """The step's placement of its KV entries in the page pool: a
    :class:`~repro_torch.models.layers.KVWrite` for bf16 pages, a
    :class:`~repro_torch.serving.kvquant.QuantWrite` for quantized ones."""
    pool = cache["k"][0]
    if kvquant.cache_is_quantized(cache):
        return kvquant.QuantWrite.build(block_tables, lengths, chunk_lens, c,
                                        pool.shape[0], pool.shape[1])
    return L.paged_chunk_write(pool, block_tables, lengths, chunk_lens, c)


def _decode_step(ctx: LayerCtx, params: Params, cache: dict,
                 decode_block_fn: Callable, *, tokens, lengths, block_tables,
                 decode_groups, positions):
    """The decode step's work (eager): logits (B, Vp)."""
    x = L.embed(ctx, params, tokens[:, None])          # (B, 1, D)
    position = lengths if positions is None else positions
    write = None
    if block_tables is not None:
        write = _paged_write(cache, block_tables, lengths,
                             torch.ones_like(lengths), 1)
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: decode_block_fn(ctx, p_i, xx, position, c_i,
                                             lengths, block_tables, write,
                                             decode_groups))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    return L.lm_logits(ctx, params, x)[:, 0]


def prefill_chunk(ctx: LayerCtx, params: Params, tokens, chunk_lens,
                  cache: dict, lengths, *, block_tables=None,
                  chunk_block_fn: Callable = chunk_block):
    """One prompt chunk for a whole (possibly ragged) batch: row b consumes
    its first ``chunk_lens[b]`` tokens at positions ``lengths[b]...``;
    rows with ``chunk_lens[b] == 0`` are spectators. Returns per-row
    logits at each row's last chunk position and the cache. Like
    :func:`decode_step`, ``block_tables`` selects the paged layout."""
    x = L.embed(ctx, params, tokens)                   # (B, C, D)
    c = tokens.shape[1]
    if block_tables is None:
        write = L.dense_chunk_write(cache["k"][0], lengths, chunk_lens, c)
    else:
        write = _paged_write(cache, block_tables, lengths, chunk_lens, c)
    x, cache = stack.run_stack_cached(
        params["layers"], x, cache,
        lambda p_i, xx, c_i: chunk_block_fn(ctx, p_i, xx, c_i, lengths,
                                            write, block_tables, chunk_lens))
    x = L.norm(ctx.cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, _last_rows(x, chunk_lens))[:, 0]
    return logits, cache
