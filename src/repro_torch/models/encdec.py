"""Whisper-style encoder-decoder backbone (whisper-tiny).

The port of the JAX package's ``models/encdec.py`` for serving and
training (:func:`train_loss`: the frames encoded, the decoder trained on
the tokens). The
audio frontend is a stub, as there: the encoder takes precomputed frame
embeddings (B, S_enc, D), ENC_FRAMES_SERVE = 1,500 of them when serving,
and zeros when none are given. RoPE positions, layernorm and the GELU MLP
follow the JAX package.

  * ``encode``: non-causal prefill attention (row 7) over the frames.
  * ``prefill``: the decoder prompt with causal row 7 for self-attention
    and non-causal row 7 against the encoder's keys for
    cross-attention (Sq ≠ Sk); the self-attention KV and each layer's
    cross-attention KV (``attention_qkv`` with ``kv_x``, no bias) land
    in the cache in place.
  * ``decode_step``: decode attention (rows 3-4) over the self-attention
    cache, then again over the static cross-attention KV with every
    row's length the encoder's.

The cache is ``k`` / ``v`` (L, B, max_seq, HK, Dh) and ``xk`` / ``xv``
(L, B, S_enc, HK, Dh). It has no paged layout.

**Serving on a mesh** (a context with ``decode_attention_fn``: every
rank holds a slice of the sequence-split caches, ``Rules.cache_spec``'s
cut) runs the layers tensor-parallel as the trainer does; the decode
tick's q / k / v are gathered whole, both attentions run the sequence
split where their cache is cut, and ``wo`` is row-parallel. The
cross-attention cache is cut over ``model`` only where the encoder
length divides it (1,500 frames over 16 ranks do not): a rank holds its
slice of ``xk`` / ``xv`` or all of them, which its local length alone
does not tell, so on a mesh the steps take the serving cache's global
length, ENC_FRAMES_SERVE, and check the cache against it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models import transformer as tfm
from repro_torch.models.kvlayout import require_dense
from repro_torch.models.layers import LayerCtx, Params

# the self- and cross-attention caches have no paged layout
PAGED_KV = False

ENC_FRAMES_SERVE = 1500  # 30 s of audio at 50 Hz, Whisper's standard


# ---------------------------------------------------------------------------
# Params (the JAX package's distributions, stacked over L layers)
# ---------------------------------------------------------------------------


def enc_layer_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                     device) -> Params:
    lead = (n_layers,)
    return {
        "attn_norm": L.norm_params(cfg, lead, device),
        "attn": L.attention_params(cfg, gen, n_layers, device),
        "mlp_norm": L.norm_params(cfg, lead, device),
        "mlp": L.mlp_params(cfg, gen, n_layers, device),
    }


def dec_layer_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                     device) -> Params:
    lead = (n_layers,)
    return {
        "attn_norm": L.norm_params(cfg, lead, device),
        "attn": L.attention_params(cfg, gen, n_layers, device),
        "cross_norm": L.norm_params(cfg, lead, device),
        "cross": L.attention_params(cfg, gen, n_layers, device),
        "mlp_norm": L.norm_params(cfg, lead, device),
        "mlp": L.mlp_params(cfg, gen, n_layers, device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    dev = resolve(device)
    gen = L.init_generator(generator, dev)
    return {
        **L.embed_params(cfg, gen, dev),
        "enc_layers": enc_layer_params(
            cfg, gen, cfg.encoder_layers or cfg.num_layers, dev),
        "layers": dec_layer_params(cfg, gen, cfg.num_layers, dev),
        "enc_norm": L.norm_params(cfg, (), dev),
        "final_norm": L.norm_params(cfg, (), dev),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def encode(ctx: LayerCtx, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, D), the stub frontend's embeddings -> the
    normed encoder output (B, S_enc, D)."""
    cfg = ctx.cfg
    x = frames.to(L.adt(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def blk(p_i, xx):
        h = L.norm(cfg, p_i["attn_norm"], xx)
        xx = xx + L.attention_block(ctx, p_i["attn"], h, positions,
                                    causal=False)
        h = L.norm(cfg, p_i["mlp_norm"], xx)
        return xx + L.mlp_block(ctx, p_i["mlp"], h)

    x = stack.run_stack(params["enc_layers"], x, blk)
    return L.norm(cfg, params["enc_norm"], x)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def dec_block(ctx: LayerCtx, p: Params, x, positions, enc_out):
    """The decoder's train block: causal self-attention, cross-attention
    against ``enc_out``'s keys and values (no rope), the MLP, each with
    its residual; under a mesh each tensor-parallel over ``model`` (the
    embeddings and the norms replicated). Returns (x, aux = 0)."""
    cfg = ctx.cfg
    h = L.norm(cfg, p["attn_norm"], x)
    x = x + L.attention_block(ctx, p["attn"], h, positions)
    h = L.norm(cfg, p["cross_norm"], x)
    x = x + L.attention_block(ctx, p["cross"], h, positions, causal=False,
                              use_rope=False, kv_x=enc_out)
    h = L.norm(cfg, p["mlp_norm"], x)
    x = x + L.mlp_block(ctx, p["mlp"], h)
    return x, tfm.no_aux(x)


def train_loss(ctx: LayerCtx, params: Params, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    """Encode ``batch["frames"]`` (B, S_enc, D), run the decoder blocks
    (recomputed in the backward pass under ``remat``; the encoder is
    not) over ``tokens``, and the chunked cross-entropy on ``labels``
    (under a mesh, the mean over the global batch)."""
    cfg = ctx.cfg
    enc_out = encode(ctx, params, batch["frames"])
    x = L.embed(ctx, params, batch["tokens"])
    positions = _positions(x.shape[0], x.shape[1], x.device)
    blk = tfm._maybe_remat(
        lambda p_i, xx: dec_block(ctx, p_i, xx, positions, enc_out), remat)
    x, _ = stack.run_stack_aux(params["layers"], x, blk)
    x = L.norm(cfg, params["final_norm"], x)
    return tfm.global_mean(
        ctx, L.cross_entropy_loss(ctx, params, x, batch["labels"]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, layout, dtype=None, device="cuda",
               enc_len: int = ENC_FRAMES_SERVE) -> dict:
    layout = require_dense(layout, cfg.family)
    dev = resolve(device)
    dtype = dtype or L.adt(cfg)
    lead = (cfg.num_layers, layout.num_slots)
    tail = (cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros((*lead, layout.max_seq, *tail), dtype=dtype,
                         device=dev),
        "v": torch.zeros((*lead, layout.max_seq, *tail), dtype=dtype,
                         device=dev),
        "xk": torch.zeros((*lead, enc_len, *tail), dtype=dtype, device=dev),
        "xv": torch.zeros((*lead, enc_len, *tail), dtype=dtype, device=dev),
    }


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict, *,
            frames: Optional[torch.Tensor] = None, **kw):
    """Encode the frames (zeros of the cache's encoder length when none
    are given), run the decoder prompt, fill the self- and the
    cross-attention caches in place (this rank's slices of them on a
    sequence-split context). Returns last-token logits (B, Vp) and the
    cache."""
    cfg = ctx.cfg
    b, s = tokens.shape
    if frames is None:
        frames = torch.zeros((b, _enc_len(ctx, cache), cfg.d_model),
                             dtype=L.adt(cfg), device=tokens.device)
    enc_out = encode(ctx, params, frames)
    x = L.embed(ctx, params, tokens)
    positions = _positions(b, s, x.device)

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["attn_norm"], xx)
        q, k, v = L.attention_qkv(ctx, p_i["attn"], h, positions)
        xx = xx + L.attention_out(ctx, p_i["attn"], q, k, v)
        h = L.norm(cfg, p_i["cross_norm"], xx)
        q, xk, xv = L.attention_qkv(ctx, p_i["cross"], h, positions,
                                    use_rope=False, kv_x=enc_out)
        xx = xx + L.attention_out(ctx, p_i["cross"], q, xk, xv, causal=False)
        h = L.norm(cfg, p_i["mlp_norm"], xx)
        xx = xx + L.mlp_block(ctx, p_i["mlp"], h)
        L.write_prompt_kv(ctx, c_i, k, v)
        _write_cross_kv(ctx, c_i, xk, xv)
        return xx

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, tfm._last_rows(x, lengths))[:, 0]
    return logits, cache


def _enc_len(ctx: LayerCtx, cache: dict) -> int:
    """The global encoder length of the cross-attention cache: its own
    length on one device; on a sequence-split context ENC_FRAMES_SERVE,
    checked against the local cache."""
    local = cache["xk"].shape[2]
    fn = ctx.decode_attention_fn
    if fn is None:
        return local
    total = ENC_FRAMES_SERVE
    m = fn.mesh.size(fn.model_axis)
    if local != (total // m if _cross_cut(ctx, total) else total):
        raise ValueError(f"the cross-attention cache holds {local} "
                         f"positions, not this rank's part of the "
                         f"{total} encoder frames")
    return total


def _cross_cut(ctx: LayerCtx, total: int) -> bool:
    """The cross-attention cache's sequence of ``total`` positions is
    cut over ``model`` here: on a sequence-split context, where the
    axis divides it (``Rules.cache_spec``'s rule)."""
    fn = ctx.decode_attention_fn
    if fn is None:
        return False
    m = fn.mesh.size(fn.model_axis)
    return total % m == 0 and total >= m


def _write_cross_kv(ctx: LayerCtx, c_i: dict, xk, xv) -> None:
    """Each layer's cross-attention KV (B, S_enc, HK, Dh) into the cache:
    all of it, or this rank's slice where the cache is cut."""
    xk, xv = L.whole_heads(ctx, xk, xv)
    if _cross_cut(ctx, xk.shape[1]):
        n = c_i["xk"].shape[1]
        start = ctx.kv_start(n)
        xk, xv = xk[:, start:start + n], xv[:, start:start + n]
    c_i["xk"].copy_(xk)
    c_i["xv"].copy_(xv)


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, block_tables=None, decode_groups=None, positions=None):
    """One token a slot: self-attention decode over the growing cache
    (its KV appended at ``lengths`` in place), cross-attention decode
    over the static encoder KV, the MLP. The decoder's write position
    always equals ``lengths``, so ``positions`` (the uniform engine
    operand) is unused. Under the ``"looped"`` granularity on the card
    the step replays one CUDA graph (:func:`stack.run_decode`). Returns
    (logits (B, Vp), cache)."""
    if block_tables is not None or decode_groups is not None:
        raise ValueError("the encoder-decoder caches have no paged layout")
    step = functools.partial(_decode_step, ctx, params, cache,
                             _enc_len(ctx, cache))
    return stack.run_decode(ctx.graphs, step, params, cache,
                            dict(tokens=tokens, lengths=lengths)), cache


def _decode_step(ctx: LayerCtx, params: Params, cache: dict, enc_len: int,
                 *, tokens, lengths):
    """The decode step's work: logits (B, Vp), the cache written in
    place."""
    cfg = ctx.cfg
    x = L.embed(ctx, params, tokens[:, None])          # (B, 1, D)
    b = x.shape[0]
    enc_lengths = torch.full((b,), enc_len, dtype=torch.int32,
                             device=x.device)
    cross = (ctx.decode_attention_fn if _cross_cut(ctx, enc_len) else
             functools.partial(ops.attention_decode, phi_cfg=ctx.phi_cfg,
                               plan=ctx.plan))

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["attn_norm"], xx)
        xx = xx + L.attention_decode_block(ctx, p_i["attn"], h, lengths,
                                           c_i["k"], c_i["v"], lengths)
        # cross-attention against the static encoder KV (q whole)
        h = L.norm(cfg, p_i["cross_norm"], xx)
        wq = p_i["cross"]["wq"]
        q = L.gather_cut(ctx, [ctx.matmul(h, wq)], [ctx.model_sharded(
            wq, -1, cfg.q_dim)])[0].reshape(b, cfg.num_heads, cfg.head_dim)
        o = cross(q, c_i["xk"], c_i["xv"], enc_lengths)
        xx = xx + L.row_parallel(ctx, o.reshape(b, 1, cfg.q_dim),
                                 p_i["cross"]["wo"], cfg.q_dim,
                                 "act_attn_out")
        h = L.norm(cfg, p_i["mlp_norm"], xx)
        return xx + L.mlp_block(ctx, p_i["mlp"], h)

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    return L.lm_logits(ctx, params, x)[:, 0]
