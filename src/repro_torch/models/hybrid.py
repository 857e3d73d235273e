"""Hymba: hybrid layers with parallel attention and SSM heads.

The port of the JAX package's ``models/hybrid.py`` for serving and
training (:func:`train_loss`). Each
layer runs a sliding-window GQA attention path and a Mamba-2 (SSD,
scalar decay per head) path on the same normed input and sums their
projections; then the MLP. Attention is O(T·W) with a ring-buffer KV
cache of W = min(sliding_window, max_seq) entries, the SSM O(T) with an
O(1) state.

  * Prefill: attention through ``ops.attention_prefill`` with the
    window (row 7); the SSM in the chunked form (CHUNK-token chunks of
    dense products, the state carried chunk by chunk as in
    :func:`repro_torch.models.ssm._chunk_states`). The ring keeps each
    row's last W valid positions (:func:`_ring_from_prefill`), padding
    positions have dt = 0 (no decay, no write).
  * Decode: the token's KV lands at ring slot ``length % W`` in place,
    and attention over the ring is T1 in torch math
    (:func:`ring_decode_attention`: ``core/softmax.py``'s unified-max
    partial, with the synchronized partial as the overflow recompute,
    selected on the device); the SSM takes one recurrence step.

The cache is ``k`` / ``v`` (L, B, W, HK, Dh) and ``state`` (L, B, HM,
SSM_HEAD, N) f32, updated in place. It has no paged layout.

**Under a mesh** (the sharded trainer) the attention and the MLP shard
as the dense family's do (``layers.attention_block`` gathers the heads
where they do not divide over ``model``, hymba-1.5b's 25 / 5 at model
2). The SSM runs tensor-parallel on the cuts ``Rules.param_spec`` gives:
``w_in``, ``w_gate``, ``w_dt`` and ``w_bc`` column-parallel, reading x
copied into the TP region, and ``w_out`` row-parallel, followed by one
all-reduce. Where ``w_dt`` is cut (whole SSM heads a rank), each rank
scans its own heads, with ``a_log`` / ``d_skip`` cut to them in one
``split_to``; ``w_bc`` is shared by every head, so its cut (B on one
rank, C on another at model 2) is gathered whole and its gradient summed
over ``model`` before this rank's slice is kept (a whole ``w_bc``, where
2 N does not divide over ``model``, has its output's gradient summed).
Where a cut splits an SSM head, the projections are gathered whole and
the scan is replicated.

**Serving on a mesh** (a context with ``decode_attention_fn``) keeps the
JAX package's cache layout: the ring's W slots cut over ``model`` (each
rank holds slots [start, start + W / model)), the SSM state over the
heads this rank scans. The decode tick gathers q / k / v whole, writes
the new entry on the rank that holds its slot and joins the ranks' T1
partials over the ring in one SUM all-reduce (sync: a MAX, then the SUM;
as on the sequence-split cache, no overflow recompute), then ``wo`` runs
row-parallel beside the TP SSM step.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import softmax as smx
from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models import transformer as tfm
from repro_torch.models.kvlayout import require_dense
from repro_torch.models.layers import LayerCtx, Params
from repro_torch.models.ssm import _chunk_states, pad_valid

# ring-buffer KV and SSM state have no paged layout
PAGED_KV = False

CHUNK = 64
_CLAMP = 30.0
SSM_HEAD = 64


def _ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    inner = cfg.ssm.expand * cfg.d_model if cfg.ssm else 2 * cfg.d_model
    return inner, inner // SSM_HEAD, cfg.ssm.state_size if cfg.ssm else 16


# ---------------------------------------------------------------------------
# Params (the JAX package's distributions, stacked over L layers)
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                 device) -> Params:
    d, dt = cfg.d_model, L.pdt(cfg)
    inner, hm, n = _ssm_dims(cfg)
    lead = (n_layers,)

    def dense(k, nn):
        return L.dense_init(gen, (*lead, k, nn), dt, device, k)

    return {
        "norm": L.norm_params(cfg, lead, device),
        "attn": L.attention_params(cfg, gen, n_layers, device),
        "ssm": {
            "w_in": dense(d, inner),
            "w_gate": dense(d, inner),
            "w_bc": dense(d, 2 * n),
            "w_dt": dense(d, hm),
            "a_log": torch.zeros((*lead, hm), dtype=torch.float32,
                                 device=device),
            "d_skip": torch.ones((*lead, hm), dtype=torch.float32,
                                 device=device),
            "w_out": dense(inner, d),
        },
        "mlp_norm": L.norm_params(cfg, lead, device),
        "mlp": L.mlp_params(cfg, gen, n_layers, device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    return tfm.init_params(cfg, generator, device,
                           layer_params_fn=layer_params)


# ---------------------------------------------------------------------------
# SSD scalar-decay SSM: chunked (prefill) and one step (decode)
# ---------------------------------------------------------------------------


def _ssm_cut(ctx: LayerCtx, p: Params) -> list:
    """Whether w_in, w_gate, w_bc and w_dt are cut over ``model`` here."""
    inner, hm, n = _ssm_dims(ctx.cfg)
    return [ctx.model_sharded(p[w], -1, full) for w, full in (
        ("w_in", inner), ("w_gate", inner), ("w_bc", 2 * n), ("w_dt", hm))]


def state_heads(ctx: LayerCtx, p: Params) -> tuple[int, int]:
    """(first, count) of the SSM heads whose state this rank holds: its
    own where w_in, w_gate and w_dt are cut (w_dt's cut is on whole
    heads), else all of them. ``p`` is a layer's ``ssm`` params."""
    cut = _ssm_cut(ctx, p)
    return L.own_heads(ctx, cut[:2] + cut[3:], _ssm_dims(ctx.cfg)[1])


def _ssm_inputs(ctx: LayerCtx, p: Params, x: torch.Tensor):
    """xi, z, bc (whole), dt and a_log / d_skip over the SSM heads this
    rank holds (hm whole, or ``hm / model`` under TP on whole heads),
    and that head count."""
    inner, hm, _ = _ssm_dims(ctx.cfg)
    cut = _ssm_cut(ctx, p)
    xt = L.into_tp(ctx, x)[0] if any(cut) else x
    ys = [ctx.matmul(xt if c else x, p[w])
          for w, c in zip(("w_in", "w_gate", "w_bc", "w_dt"), cut)]
    _, nh = state_heads(ctx, p)
    if nh == hm:
        # whole heads on every rank: the cut projections gathered
        return (*L.gather_cut(ctx, ys, cut), p["a_log"], p["d_skip"], hm)
    L.check_shard(ctx, ys[0], "act_ffn", inner)
    # every head reads all of B and C: their gradients are partial sums
    # (summed as the cut is gathered, or by a copy where w_bc is whole)
    ys[2] = (L.gather_cut(ctx, ys[2:3], [True], summed=True) if cut[2]
             else L.into_tp(ctx, ys[2]))[0]
    a_log, d_skip = C.split_to(torch.stack([p["a_log"], p["d_skip"]]), -1,
                               ctx.mesh, ctx.rules.model_axis).unbind(0)
    return (*ys, a_log, d_skip, nh)


def ssm_chunked(ctx: LayerCtx, p: Params, x: torch.Tensor,
                state0: Optional[torch.Tensor] = None, *,
                return_state: bool = False,
                valid: Optional[torch.Tensor] = None):
    """x (B, T, D) -> (B, T, D) (+ the final state (B, HM, P, N) f32 with
    ``return_state``). ``valid`` (B, T) bool: padding positions get
    dt = 0, which zeroes both their state write and their decay. T pads
    internally to a CHUNK multiple. Under TP on whole heads ``state0``
    and the state returned hold this rank's heads."""
    inner, _, n = _ssm_dims(ctx.cfg)
    b, t_in, d = x.shape
    pad_t = (-t_in) % min(CHUNK, max(t_in, 1))
    if pad_t:
        x = F.pad(x, (0, 0, 0, pad_t))
        if valid is None:
            valid = (torch.arange(t_in + pad_t, device=x.device)[None, :]
                     < t_in)
        else:
            valid = pad_valid(valid, pad_t)
    t = x.shape[1]
    xi, z, bc, dt_, a_log, d_skip, hm = _ssm_inputs(ctx, p, x)
    bc = bc.float()
    bmat, cmat = bc[..., :n], bc[..., n:]                      # (B,T,N)
    dt_ = F.softplus(dt_.float())                              # (B,T,HM)
    if valid is not None:
        dt_ = torch.where(valid[..., None], dt_, 0.0)
    a = -torch.exp(a_log)                                      # (HM,) < 0
    la_step = a * dt_                                          # <= 0

    c = min(CHUNK, t)
    nc = t // c
    xh = xi.reshape(b, nc, c, hm, SSM_HEAD).float()
    bm = bmat.reshape(b, nc, c, n)
    cm = cmat.reshape(b, nc, c, n)
    dtc = dt_.reshape(b, nc, c, hm)
    la = torch.cumsum(la_step.reshape(b, nc, c, hm), dim=2)    # (B,NC,C,HM)
    la_end = la[:, :, -1:]

    # chunk summaries, then the states across chunks
    dec = torch.exp(la_end[:, :, 0])                           # (B,NC,HM)
    w_in = dtc * torch.exp(la_end - la)                        # exps <= 0
    u_mat = torch.einsum("bcthp,bctn->bchpn", xh * w_in[..., None], bm)
    if state0 is None:
        state0 = torch.zeros((b, hm, SSM_HEAD, n), dtype=torch.float32,
                             device=x.device)
    s_end = _chunk_states(dec, u_mat, state0)                  # (B,NC,HM,P,N)
    s_start = torch.cat([state0[:, None], s_end[:, :-1]], dim=1)

    # within each chunk (inclusive decay: y_t reads S_t)
    inter = torch.einsum("bchpn,bctn->bcthp", s_start, cm) \
        * torch.exp(la)[..., None]
    qk = torch.einsum("bctn,bcsn->bcts", cm, bm)               # (B,NC,C,C)
    decay_ts = torch.exp(torch.clamp(
        la[:, :, :, None, :] - la[:, :, None, :, :], -_CLAMP, _CLAMP))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    scores = torch.where(mask[:, :, None], qk[..., None] * decay_ts, 0.0)
    scores = scores * dtc[:, :, None]                          # (B,NC,T,S,HM)
    intra = torch.einsum("bctsh,bcshp->bcthp", scores, xh)
    y = inter + intra + d_skip[:, None] * xh

    y = y.reshape(b, t, hm * SSM_HEAD).to(x.dtype) * F.silu(z)
    out = L.row_parallel(ctx, y, p["w_out"], inner, "act_ffn")[:, :t_in]
    if return_state:
        return out, s_end[:, -1]
    return out


def ssm_step(ctx: LayerCtx, p: Params, x: torch.Tensor, state: torch.Tensor):
    """One token. x (B, D); state (B, HM, P, N) f32 (this rank's heads
    under TP on whole heads). Returns (out (B, D), new state)."""
    inner, _, n = _ssm_dims(ctx.cfg)
    b = x.shape[0]
    xi, z, bc, dt_, a_log, d_skip, hm = _ssm_inputs(ctx, p, x)
    xi = xi.float().reshape(b, hm, SSM_HEAD)
    bc = bc.float()
    bvec, cvec = bc[..., :n], bc[..., n:]
    dt_ = F.softplus(dt_.float())                              # (B,HM)
    dec = torch.exp(-torch.exp(a_log) * dt_)
    upd = (xi * dt_[..., None])[..., None] * bvec[:, None, None, :]
    new_state = dec[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec)
    y = y + d_skip[None, :, None] * xi
    y = y.reshape(b, hm * SSM_HEAD).to(x.dtype) * F.silu(z)
    return L.row_parallel(ctx, y, p["w_out"], inner, "act_ffn"), new_state


# ---------------------------------------------------------------------------
# Ring-buffer sliding-window attention (decode)
# ---------------------------------------------------------------------------


def _ring(ctx: LayerCtx, w_loc: int) -> tuple[int, int]:
    """(first slot, W) of this rank's ``w_loc`` ring slots: (0, w_loc) on
    one device, (its slice's start, w_loc x model) on a sequence-split
    context."""
    fn = ctx.decode_attention_fn
    if fn is None:
        return 0, w_loc
    return fn.kv_start(w_loc), w_loc * fn.mesh.size(fn.model_axis)


def ring_decode_attention(ctx: LayerCtx, qd: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """T1 over the ring in torch math. qd (B, HQ, Dh); cache (B, W, HK,
    Dh) ring (this rank's slots on a sequence-split context, whose
    partials meet over ``model``); ``lengths`` after this step's write.
    Every slot is valid once a row has W tokens, else the slots below its
    length. With the unified scheme and ``fallback`` the synchronized
    result replaces the unified one when max(s − φ) passes the band,
    selected on the device (the JAX package's ``lax.cond``; one device
    only)."""
    cfg = ctx.cfg
    w_loc, hk = cache_k.shape[1], cache_k.shape[2]
    start, w = _ring(ctx, w_loc)
    groups = qd.shape[1] // hk
    kf = cache_k.repeat_interleave(groups, dim=2).float()
    vf = cache_v.repeat_interleave(groups, dim=2).float().transpose(1, 2)
    s = torch.einsum("bhd,bkhd->bhk", qd.float() * cfg.head_dim ** -0.5, kf)
    slots = torch.arange(start, start + w_loc, device=qd.device)[None, None]
    lens = lengths.to(qd.device)[:, None, None]
    valid = (lens >= w) | (slots < lens)
    phi_cfg = ctx.phi_cfg
    dp = ctx.plan.attention_decode
    fn = ctx.decode_attention_fn
    if fn is not None:
        group = fn.mesh.group(fn.model_axis)
        if phi_cfg.active and dp.scheme == "unified_max":
            out, _ = smx.combine_async_collective(
                smx.async_partial(s, vf, phi_cfg.phi, valid), group)
        else:
            out = smx.combine_sync_collective(smx.sync_partial(s, vf, valid),
                                              group)
        return out.to(qd.dtype)

    def synced():
        part = smx.sync_partial(s, vf, valid)
        return part.num / torch.where(part.den == 0, 1.0,
                                      part.den)[..., None]

    if phi_cfg.active and dp.scheme == "unified_max":
        part = smx.async_partial(s, vf, phi_cfg.phi, valid)
        out = part.num / part.den[..., None]
        if dp.fallback:
            overflow = (part.max_centered > phi_cfg.band[1]).any()
            out = torch.where(overflow, synced(), out)
    else:
        out = synced()
    return out.to(qd.dtype)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def block(ctx: LayerCtx, p: Params, x, positions):
    """The train block: windowed causal attention and the chunked SSM on
    the same normed input, both added to the residual, then the MLP.
    Returns (x, aux = 0)."""
    cfg = ctx.cfg
    h = L.norm(cfg, p["norm"], x)
    attn_out = L.attention_block(ctx, p["attn"], h, positions)
    ssm_out = ssm_chunked(ctx, p["ssm"], h)
    x = x + attn_out + ssm_out
    h = L.norm(cfg, p["mlp_norm"], x)
    x = x + L.mlp_block(ctx, p["mlp"], h)
    return x, tfm.no_aux(x)


def train_loss(ctx: LayerCtx, params: Params, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    return tfm.train_loss(ctx, params, batch, remat=remat, block_fn=block)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, layout, dtype=None, device="cuda") -> dict:
    layout = require_dense(layout, cfg.family)
    inner, hm, n = _ssm_dims(cfg)
    dev = resolve(device)
    # the ring's slots: the window, at most max_seq
    w = min(cfg.sliding_window or 1024, layout.max_seq)
    kv = (cfg.num_layers, layout.num_slots, w, cfg.num_kv_heads,
          cfg.head_dim)
    dtype = dtype or L.adt(cfg)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
        "state": torch.zeros((cfg.num_layers, layout.num_slots, hm,
                              SSM_HEAD, n), dtype=torch.float32, device=dev),
    }


def _ring_from_prefill(k: torch.Tensor, lengths: torch.Tensor, w: int, *,
                       start: int = 0,
                       w_loc: Optional[int] = None) -> torch.Tensor:
    """Per-row ragged ring fill, k (B, T, H, Dh) -> (B, w, H, Dh): slot s
    holds position p(s) = (l - 1) - ((l - 1 - s) mod w), the one p in
    [l - w, l) with p % w == s; slots with p < 0 (a prompt shorter than
    the ring) are zero. With ``w_loc`` only slots [start, start + w_loc)
    (a rank's slice of a sequence-split ring)."""
    b, t = k.shape[:2]
    s = torch.arange(start, start + (w if w_loc is None else w_loc),
                     device=k.device)[None, :]
    l_ = lengths.to(k.device).long()[:, None]
    p = (l_ - 1) - torch.remainder(l_ - 1 - s, w)              # (B, w)
    rows = torch.arange(b, device=k.device)[:, None]
    out = k[rows, p.clamp(0, t - 1)]
    return torch.where((p >= 0)[..., None, None], out, 0)


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict,
            **kw):
    """Whole prompts (B, T): the windowed prefill attention (row 7) and
    the chunked SSM; each row's last W valid positions fill the ring and
    the final SSM state lands in the cache, in place. Returns last-token
    logits (B, Vp) and the cache."""
    cfg = ctx.cfg
    w_loc = cache["k"].shape[2]
    start, w = _ring(ctx, w_loc)
    x = L.embed(ctx, params, tokens)
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    valid = (torch.arange(t, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["norm"], xx)
        q, k, v = L.attention_qkv(ctx, p_i["attn"], h, positions)
        attn_out = L.attention_out(ctx, p_i["attn"], q, k, v)
        ssm_out, s_end = ssm_chunked(ctx, p_i["ssm"], h, return_state=True,
                                     valid=valid)
        xx = xx + attn_out + ssm_out
        h2 = L.norm(cfg, p_i["mlp_norm"], xx)
        xx = xx + L.mlp_block(ctx, p_i["mlp"], h2)
        for name, kv in zip(("k", "v"), L.whole_heads(ctx, k, v)):
            c_i[name].copy_(_ring_from_prefill(kv, lengths, w, start=start,
                                               w_loc=w_loc))
        c_i["state"].copy_(s_end)
        return xx

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, tfm._last_rows(x, lengths))[:, 0]
    return logits, cache


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, block_tables=None, decode_groups=None, positions=None):
    """One token a slot: its KV into ring slot ``length % W`` and T1 over
    the ring, beside one SSM step; the cache updates in place. The write
    position always equals ``lengths`` here, so ``positions`` (the
    uniform engine operand) is unused. Under the ``"looped"``
    granularity on the card the step replays one CUDA graph
    (:func:`stack.run_decode`). Returns (logits (B, Vp), cache)."""
    if block_tables is not None or decode_groups is not None:
        raise ValueError("ring KV and SSM state have no paged layout")
    step = functools.partial(_decode_step, ctx, params, cache)
    return stack.run_decode(ctx.graphs, step, params, cache,
                            dict(tokens=tokens, lengths=lengths)), cache


def _decode_step(ctx: LayerCtx, params: Params, cache: dict, *, tokens,
                 lengths):
    """The decode step's work: logits (B, Vp), the cache written in
    place."""
    cfg = ctx.cfg
    x = L.embed(ctx, params, tokens[:, None])          # (B, 1, D)
    b = x.shape[0]
    w_loc = cache["k"].shape[2]
    start, w = _ring(ctx, w_loc)
    rows = torch.arange(b, device=x.device)
    slot = torch.remainder(lengths.long(), w)
    # on a mesh the new entry lands on the rank that holds its slot
    write = (None if ctx.decode_attention_fn is None
             else L.slice_decode_write(cache["k"][0], slot, start))

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["norm"], xx)
        q, k, v = L.attention_qkv(ctx, p_i["attn"], h, lengths[:, None],
                                  whole=True)
        for name, new in (("k", k), ("v", v)):
            if write is None:
                c_i[name].index_put_((rows, slot),
                                     new[:, 0].to(c_i[name].dtype))
            else:
                write.put(c_i[name], new)
        o = ring_decode_attention(ctx, q[:, 0], c_i["k"], c_i["v"],
                                  lengths + 1)
        attn_out = L.row_parallel(ctx, o.reshape(b, 1, cfg.q_dim),
                                  p_i["attn"]["wo"], cfg.q_dim,
                                  "act_attn_out")
        ssm_out, new_state = ssm_step(ctx, p_i["ssm"], h[:, 0],
                                      c_i["state"])
        xx = xx + attn_out + ssm_out[:, None]
        h2 = L.norm(cfg, p_i["mlp_norm"], xx)
        xx = xx + L.mlp_block(ctx, p_i["mlp"], h2)
        c_i["state"].copy_(new_state)
        return xx

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    return L.lm_logits(ctx, params, x)[:, 0]
