"""Token-choice top-k MoE (the grok-1 / dbrx family).

The port of the JAX package's ``models/moe.py`` for serving and for
training (:func:`train_loss`: capacity-bounded routing, the
load-balance aux in the loss), on one card or on a mesh: routing local
to each data rank where the groups divide over the data axes (the JAX
package's ``_moe_block_manual``), across the global batch where they do
not, and the experts tensor-parallel over ``model`` (:func:`moe_block`).
Each block
is the dense block's attention half (:mod:`repro_torch.models.transformer`,
so the same kernels and fused stages run) followed by a routed expert MLP:

  * **Routing** is group-local: the tokens are reshaped to ``(G, T/G, D)``
    (G = ``LayerCtx.moe_groups``), and each group's router (f32), softmax,
    top-k and renormalisation never look past the group.
  * **Slotting**: each group's (token, choice) pairs are sorted stably by
    expert into ``cap`` slots per expert; pairs past an expert's capacity
    go to a dump slot and are dropped. Decode runs **zero-drop**
    (``cap = T_g * k``: no pair can overflow); chunk and one-shot prefill
    run zero-drop up to :data:`ZERO_DROP_MAX_GROUP_TOKENS` tokens a group
    and at :data:`PREFILL_CAPACITY_FACTOR` past it.
  * **The expert FFN** (gated swiglu / geglu with three expert matrices,
    or plain gelu with two) runs as batched products over all experts'
    slots, the weights stored unfactored ``(E, D, F)``.
  * **Combine**: each token's k expert rows, weighted by their routing
    weights, are added back in ascending expert order in the rows'
    dtype, the order the JAX package's scatter-add takes.

Three choices keep the port's bitwise contracts (paged = dense, graph
replay = eager, run to run):

  * the combine gathers each token's rows through the inverse slot map and
    adds them in a fixed order, never by an atomic ``index_add_``;
  * top-k is a stable descending sort, so a tie goes to the lower expert
    index as in ``lax.top_k`` (``torch.topk`` promises no tie order);
  * the router product runs at f32 precision, TF32 off whatever the
    process has set.

The expert products are einsums in the JAX package, outside any Pallas
kernel, so ``torch.bmm`` computes them here; they are not ``ops.matmul``
calls, and ``dispatch.called_gemm_shapes`` lists none of them.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import LayerCtx, Params

# the (L, B, S, HK, Dh) cache admits the block-paged layout
PAGED_KV = True

# Zero-drop slots cost cap = T_g * k per expert (all tokens to one expert):
# exact but E times over-allocated. Fine for decode ticks and engine-sized
# chunks; past this many tokens a group, prefill bounds the capacity at
# PREFILL_CAPACITY_FACTOR, which drops only under more than 2x average skew.
ZERO_DROP_MAX_GROUP_TOKENS = 4096
PREFILL_CAPACITY_FACTOR = 2.0


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def moe_params(cfg: ModelConfig, gen: torch.Generator, n: int,
               device) -> Params:
    """One MoE FFN per layer, stacked over ``n``: the router ``(n, D, E)``
    in f32 (drawn at the param dtype, as the JAX package draws it), the
    expert matrices ``(n, E, D, F)`` / ``(n, E, F, D)``."""
    assert cfg.moe is not None
    e, d, f, dt = cfg.moe.num_experts, cfg.d_model, cfg.d_ff, L.pdt(cfg)
    p = {"router": L.dense_init(gen, (n, d, e), dt, device, d).float()}
    if cfg.activation in ("swiglu", "geglu"):    # gated: 3 expert matrices
        p["w_gate"] = L.dense_init(gen, (n, e, d, f), dt, device, d)
    p["w_up"] = L.dense_init(gen, (n, e, d, f), dt, device, d)
    p["w_down"] = L.dense_init(gen, (n, e, f, d), dt, device, f)
    return p


def layer_params(cfg: ModelConfig, gen: torch.Generator, n: int,
                 device) -> Params:
    return {
        "attn_norm": L.norm_params(cfg, (n,), device),
        "attn": L.attention_params(cfg, gen, n, device),
        "mlp_norm": L.norm_params(cfg, (n,), device),
        "moe": moe_params(cfg, gen, n, device),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    return tfm.init_params(cfg, generator, device,
                           layer_params_fn=layer_params)


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _f32_products():
    """f32 matmuls at full f32 precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def capacity(tg: int, k: int, e: int, capacity_factor: float,
             zero_drop: bool) -> int:
    """Slots per expert for a group of ``tg`` tokens."""
    if zero_drop:
        return tg * k
    cap = int(-(-tg * k * capacity_factor // e))
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, tg * k)


def moe_block(ctx: LayerCtx, p: Params, x: torch.Tensor, *, groups: int = 1,
              capacity_factor: float = 1.25, zero_drop: bool = False):
    """x (B, S, D) -> (out (B, S, D), the GShard load-balance aux).

    Under a mesh (``ctx.mesh`` and ``ctx.rules``) x is this rank's rows
    and ``groups`` counts the global batch's routing groups, as in the
    JAX package. Where the data axes' ranks divide the groups, each rank
    routes, slots, runs the experts and combines its own ``groups /
    nshards`` groups of its own tokens (the JAX package's
    ``_moe_block_manual``): no token crosses ranks, and the aux is this
    rank's, whose mean over the data axes (the JAX package's ``pmean``)
    is the loss's own mean over the batch axes
    (``transformer.global_mean``). Otherwise the routing groups span the
    global batch (the JAX package's GSPMD path): the rows are gathered
    over the data axes (the backward pass sums each rank's part of the
    gradient, then keeps this rank's rows), dispatched as on one card,
    and this rank's rows kept. The experts' F over ``model`` runs
    tensor-parallel (:func:`_dispatch_ffn_combine`)."""
    cfg = ctx.cfg
    assert cfg.moe is not None
    e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    b, s, d = x.shape
    data = _data_axes(ctx)
    nshards = ctx.mesh.axes_size(data) if data else 1
    t = b * s * nshards
    g = groups
    while t % g:
        g //= 2
    tg = t // g
    cap = capacity(tg, k, e, capacity_factor, zero_drop)
    tp = _expert_tp(ctx, p)
    if g % nshards == 0:
        out, aux = _dispatch_ffn_combine(
            cfg, p, x.reshape(g // nshards, tg, d), e=e, k=k, cap=cap, tp=tp)
        return out.reshape(b, s, d), aux
    # the aux reads every rank's rows, so each rank's gradient of them is
    # a part: summed over the ranks, then cut (FSDP's gather and backward)
    whole = C.fsdp_gather([x], [0], ctx.mesh, data)[0]
    out, aux = _dispatch_ffn_combine(cfg, p, whole.reshape(g, tg, d), e=e,
                                     k=k, cap=cap, tp=tp)
    rows = ctx.mesh.axes_coord(data) * b
    return out.reshape(b * nshards, s, d)[rows:rows + b], aux


def _data_axes(ctx: LayerCtx) -> tuple:
    """The mesh axes the routing groups are cut over: the rules' batch
    axes of the activations (no ``pod`` under int8-EF); () without a
    mesh."""
    if ctx.mesh is None or ctx.rules is None:
        return ()
    return tuple(a for a in ctx.rules.act_batch_axes
                 if a in ctx.mesh.axis_names)


def _expert_tp(ctx: LayerCtx, p: Params):
    """(mesh, model axis) where this rank holds a slice of the experts'
    F, else None."""
    if ctx.model_sharded(p["w_down"], -2, ctx.cfg.d_ff):
        return ctx.mesh, ctx.rules.model_axis
    return None


def route(router: torch.Tensor, xg: torch.Tensor, k: int):
    """f32 router logits, softmax, top-k (ties to the lower expert) and
    renormalised weights: (probs (G, Tg, E), weights (G, Tg, k) f32,
    experts (G, Tg, k) int64)."""
    with _f32_products():
        logits = torch.matmul(xg.float(), router)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[..., :k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return probs, weights, top.indices[..., :k]


def _dispatch_ffn_combine(cfg: ModelConfig, p: Params, xg: torch.Tensor, *,
                          e: int, k: int, cap: int, tp=None):
    """Routing -> slotting -> expert FFN -> combine on (G, Tg, D) groups.
    With ``tp`` (mesh, axis) the expert matrices are this rank's slices
    of F: the slots enter the products through ``copy_to``, and the
    combined (G, Tg, D) rows, partial sums over F, leave through one
    ``reduce_from``. The reduction commutes with the linear combine, so
    it runs on the tokens, not on the k-times-capacity slots (the JAX
    package's note on the down projection). The routing weights multiply
    those partial rows: they too pass ``copy_to``, whose backward sums
    their partial gradients over the axis. The router stays
    replicated."""
    g, tg, d = xg.shape
    dev = xg.device
    probs, weights, idx = route(p["router"], xg, k)

    # ---- slotting: a stable sort of the (token, choice) pairs by expert
    eflat = idx.reshape(g, tg * k)
    wflat = weights.reshape(g, tg * k)
    order = torch.sort(eflat, dim=1, stable=True).indices
    sorted_e = eflat.gather(1, order)
    sorted_w = wflat.gather(1, order)
    sorted_tok = order // k
    counts = F.one_hot(eflat, e).sum(dim=1)                   # (G, E)
    starts = counts.cumsum(dim=1) - counts                    # exclusive
    ranks = (torch.arange(tg * k, device=dev)[None, :]
             - starts.gather(1, sorted_e))
    dump = e * cap
    dest = torch.where(ranks < cap, sorted_e * cap + ranks,
                       torch.full_like(ranks, dump))          # (G, T*k)
    # each kept pair owns its slot; the dump slot (dropped pairs, cut off
    # below) is the only index written twice
    slot_tok = torch.zeros((g, dump + 1), dtype=torch.long, device=dev)
    slot_tok.scatter_(1, dest, sorted_tok)
    slot_w = torch.zeros((g, dump + 1), dtype=torch.float32, device=dev)
    slot_w.scatter_(1, dest, sorted_w)
    slot_valid = torch.zeros((g, dump + 1), dtype=torch.bool, device=dev)
    slot_valid.scatter_(1, dest, torch.ones_like(dest, dtype=torch.bool))
    slot_tok, slot_w, slot_valid = (slot_tok[:, :dump], slot_w[:, :dump],
                                    slot_valid[:, :dump])

    # ---- gather the tokens into (E, G*cap, D) slots
    xs = xg.gather(1, slot_tok[..., None].expand(g, dump, d))
    xs = xs * slot_valid[..., None].to(xg.dtype)
    xs = xs.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    # ---- expert FFN as batched products over the experts
    if tp is not None:
        xs = C.copy_to(xs, *tp)
        slot_w = C.copy_to(slot_w, *tp)
    if "w_gate" in p:
        gate = torch.bmm(xs, p["w_gate"])
        up = torch.bmm(xs, p["w_up"])
        act = (F.silu(gate) if cfg.activation == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        h = act * up
    else:
        h = F.gelu(torch.bmm(xs, p["w_up"]), approximate="tanh")
    y = torch.bmm(h, p["w_down"])                             # (E, G*cap, D)
    y = y.reshape(e, g, cap, d).transpose(0, 1).reshape(g, dump, d)
    y = y * (slot_w.to(y.dtype) * slot_valid.to(y.dtype))[..., None]

    # ---- combine: each token's k rows, ascending expert, in y's dtype
    inv = torch.empty_like(dest).scatter_(1, order, dest)      # (G, T*k)
    inv = inv.reshape(g, tg, k)
    inv = inv.gather(2, idx.argsort(dim=-1))                  # by expert
    y = torch.cat([y, y.new_zeros((g, 1, d))], dim=1)         # dump row: 0
    rows = y.gather(1, inv.reshape(g, tg * k, 1).expand(g, tg * k, d))
    rows = rows.reshape(g, tg, k, d)
    out = rows[:, :, 0]
    for j in range(1, k):
        out = out + rows[:, :, j]

    # ---- GShard load-balance aux
    frac_tokens = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    if tp is not None:
        # last: a remat recompute stops at the last tensor saved for the
        # backward pass (the aux's), so it does not issue this again
        out = C.reduce_from(out, *tp)
    return out, aux


# ---------------------------------------------------------------------------
# Blocks: the dense attention halves, then the MoE FFN
# ---------------------------------------------------------------------------


def _moe_mlp(ctx: LayerCtx, p: Params, x, *, decode: bool):
    """``x + moe(norm(x))`` over ``ctx.moe_groups`` routing groups:
    zero-drop at decode, and for prefill while a group holds at most
    :data:`ZERO_DROP_MAX_GROUP_TOKENS` tokens."""
    h = L.norm(ctx.cfg, p["mlp_norm"], x)
    gr = ctx.moe_groups
    b, s, _ = h.shape
    small = decode or (b * s) // max(gr, 1) <= ZERO_DROP_MAX_GROUP_TOKENS
    y, _ = moe_block(ctx, p["moe"], h, groups=gr, zero_drop=small,
                     capacity_factor=PREFILL_CAPACITY_FACTOR)
    return x + y


def decode_block(ctx: LayerCtx, p: Params, x, position, cache_i, lengths,
                 block_tables=None, write=None, decode_groups=None):
    """Ingest → attend → epilogue (the dense stages, fused as the plan
    says) → the zero-drop MoE tail."""
    x = tfm.decode_attention_half(ctx, p, x, position, cache_i, lengths,
                                  block_tables, write, decode_groups)
    return _moe_mlp(ctx, p, x, decode=True)


def chunk_block(ctx: LayerCtx, p: Params, x, cache_i, lengths, write,
                block_tables=None, chunk_lens=None):
    x = tfm.chunk_attention_half(ctx, p, x, cache_i, lengths, write,
                                 block_tables, chunk_lens)
    return _moe_mlp(ctx, p, x, decode=False)


def prefill_block(ctx: LayerCtx, p: Params, x, positions, cache_i):
    x = tfm.prefill_attention_half(ctx, p, x, positions, cache_i)
    return _moe_mlp(ctx, p, x, decode=False)


def make_block(groups: int = 0, capacity_factor: float = 1.25):
    """The MoE train block: the dense block's attention half, then the
    routed MLP at ``capacity_factor`` (pairs past an expert's capacity
    are dropped) over ``groups`` routing groups (``ctx.moe_groups`` when
    0). Returns (x, the load-balance aux)."""
    def block(ctx: LayerCtx, p: Params, x, positions):
        cfg = ctx.cfg
        h = L.norm(cfg, p["attn_norm"], x)
        x = x + L.attention_block(ctx, p["attn"], h, positions)
        h = L.norm(cfg, p["mlp_norm"], x)
        y, aux = moe_block(ctx, p["moe"], h, groups=groups or ctx.moe_groups,
                           capacity_factor=capacity_factor)
        return x + y, aux

    return block


# ---------------------------------------------------------------------------
# Public API (the signatures of transformer's)
# ---------------------------------------------------------------------------


def train_loss(ctx: LayerCtx, params: Params, batch: dict, *,
               remat: bool = True, groups: int = 0,
               capacity_factor: float = 1.25) -> torch.Tensor:
    """The dense train loss over the MoE blocks, plus the config's
    ``router_aux_loss_coef`` times the summed load-balance aux."""
    aux_w = ctx.cfg.moe.router_aux_loss_coef if ctx.cfg.moe else 0.0
    return tfm.train_loss(ctx, params, batch, remat=remat,
                          block_fn=make_block(groups, capacity_factor),
                          aux_weight=aux_w)


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict):
    return tfm.prefill(ctx, params, tokens, lengths, cache,
                       prefill_block_fn=prefill_block)


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, block_tables=None, decode_groups=None, positions=None):
    return tfm.decode_step(ctx, params, tokens, cache, lengths,
                           block_tables=block_tables,
                           decode_groups=decode_groups, positions=positions,
                           decode_block_fn=decode_block)


def prefill_chunk(ctx: LayerCtx, params: Params, tokens, chunk_lens,
                  cache: dict, lengths, *, block_tables=None):
    return tfm.prefill_chunk(ctx, params, tokens, chunk_lens, cache, lengths,
                             block_tables=block_tables,
                             chunk_block_fn=chunk_block)


init_cache = tfm.init_cache
