"""RWKV6 "Finch": the attention-free family with data-dependent decay.

The port of the JAX package's ``models/ssm.py`` for serving and
training (:func:`train_loss`, the chunked form). RWKV has no
softmax attention, so T1 does not apply; its projections go through
``ops.matmul`` (T2 / T3: rows 1 and 2 at decode). Per head (head size N),
with data-dependent decay w_t ∈ (0, 1)^N and bonus u:

    S_t = diag(w_t) · S_{t-1} + k_t vᵗ_t
    o_t = r_tᵀ · (S_{t-1} + diag(u) k_t vᵗ_t)

Prefill runs the chunked-parallel form: within a CHUNK-token chunk the
recurrence expands into dense products (cumulative log-decay ``la``);
across chunks the state is carried chunk by chunk, ``S_end[j] =
dec[j] · S_end[j - 1] + U[j]`` (the JAX package's associative scan, run
as the recurrence it computes). The intra-chunk ``e^{-la}`` factor is
clamped at ±_CLAMP as there. Decode is the O(1) recurrence step. The
state stays f32; padding positions (``valid``) neither decay nor write
it, so ragged prompts give exact per-row states.

The cache is the recurrent state (O(1) in the sequence): ``state`` (L, B,
H, N, N) f32 and the token-shift features ``tm_x`` / ``cm_x`` (L, B, D).
The steps update it in place. It has no paged layout.

**Under a mesh** (the sharded trainer) the mixes run tensor-parallel
over ``model`` on the cuts ``Rules.param_spec`` gives, Megatron's way:
the time mix's ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and the channel
mix's ``w_k`` / ``w_r`` column-parallel, reading x, its predecessor
features and their mus copied into the TP region; ``w_o`` and the
channel mix's ``w_v`` row-parallel, followed by one all-reduce. Where
every column-parallel weight is cut on whole heads, each rank runs the
WKV recurrence of its own heads, and the replicated ``decay_B``,
``decay_base``, ``bonus_u`` and ``ln_out`` are cut to them in one
``split_to`` (whose backward gathers each rank's slice of their
gradients); the decay LoRA's first product reads the whole residual, its
hidden copied into the TP region before ``decay_B``'s cut. Where a cut
splits a head, the projections are gathered whole and the recurrence is
replicated. The channel mix's receptance, column-parallel by the JAX
rule, is gathered whole before its sigmoid multiplies the reduced
output. One device, or a leaf that is whole, computes as before.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import stack
from repro_torch.models import transformer as tfm
from repro_torch.models.kvlayout import require_dense
from repro_torch.models.layers import LayerCtx, Params

# the recurrent state has no paged layout
PAGED_KV = False

CHUNK = 64
_CLAMP = 30.0
_LORA = 64                  # the decay LoRA's rank


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    n = cfg.ssm.head_dim if cfg.ssm else 64
    return cfg.d_model // n, n


# ---------------------------------------------------------------------------
# Params (the JAX package's distributions, stacked over L layers)
# ---------------------------------------------------------------------------


def layer_params(cfg: ModelConfig, gen: torch.Generator, n_layers: int,
                 device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, L.pdt(cfg)
    h, n = _heads(cfg)
    lead = (n_layers,)

    def full(v, dtype=dt):
        return torch.full((*lead, d), v, dtype=dtype, device=device)

    def dense(k, nn, dtype=dt):
        return L.dense_init(gen, (*lead, k, nn), dtype, device, k)

    decay_b = torch.randn((*lead, _LORA, d), generator=gen,
                          dtype=torch.float32, device=device) * 0.01
    return {
        "tm_norm": L.norm_params(cfg, lead, device),
        "tm": {
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
            "mu_g": full(0.5), "mu_w": full(0.5),
            "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
            "w_g": dense(d, d), "w_o": dense(d, d),
            # data-dependent decay LoRA (Finch): w = exp(-exp(.))
            "decay_base": full(-6.0, torch.float32),
            "decay_A": dense(d, _LORA, torch.float32),
            "decay_B": decay_b,
            "bonus_u": torch.zeros((*lead, h, n), dtype=torch.float32,
                                   device=device),
            "ln_out": torch.ones((*lead, d), dtype=dt, device=device),
        },
        "cm_norm": L.norm_params(cfg, lead, device),
        "cm": {
            "mu_k": full(0.5), "mu_r": full(0.5),
            "w_k": dense(d, f), "w_v": dense(f, d), "w_r": dense(d, d),
        },
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    return tfm.init_params(cfg, generator, device,
                           layer_params_fn=layer_params)


# ---------------------------------------------------------------------------
# Time mixing: chunked parallel (prefill) and the recurrence step (decode)
# ---------------------------------------------------------------------------


def pad_valid(valid: torch.Tensor, pad: int) -> torch.Tensor:
    """valid (B, T) bool with ``pad`` more positions, all False."""
    return torch.cat([valid, valid.new_zeros((valid.shape[0], pad))], 1)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None):
    """Previous-token features of x (B, T, D); ``last`` (B, D) seeds
    position 0 (zeros without it)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


def _decay_logw(ctx: LayerCtx, tm: Params, xw: torch.Tensor,
                decay_b: torch.Tensor,
                decay_base: torch.Tensor) -> torch.Tensor:
    """log w_t ∈ (-inf, 0) in f32: the data-dependent per-channel decay,
    over the channels of ``decay_b`` / ``decay_base`` (this rank's heads'
    cut under TP: the LoRA's hidden then enters the TP region)."""
    hid = torch.tanh(xw.float() @ tm["decay_A"])
    if decay_b.shape[-1] != tm["decay_B"].shape[-1]:
        hid = L.into_tp(ctx, hid)[0]
    return -torch.exp(decay_base + hid @ decay_b)


def _headnorm(x: torch.Tensor, scale: torch.Tensor, h: int, n: int):
    """Per-head layernorm (no bias, eps 1e-5) of x (B, T, D) in f32."""
    b, t, d = x.shape
    xh = x.reshape(b, t, h, n).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = (xh - mu).square().mean(dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return xh.reshape(b, t, d) * scale.float()


def _chunk_states(dec: torch.Tensor, u: torch.Tensor,
                  state0: torch.Tensor) -> torch.Tensor:
    """The state at each chunk's end: S_end[j] = dec[j] · S_end[j - 1] +
    u[j] from S_end[-1] = state0, over chunk axis 1 (dec broadcast over
    u's trailing axes). The recurrence the JAX package's associative
    scan evaluates in log depth."""
    extra = u.dim() - dec.dim()
    s, out = state0, []
    for j in range(u.shape[1]):
        dj = dec[:, j].reshape(*dec[:, j].shape, *([1] * extra))
        s = dj * s + u[:, j]
        out.append(s)
    return torch.stack(out, dim=1)


def _step_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """One token's predecessor features: ``last`` itself."""
    return last


def _lerps(ctx: LayerCtx, x: torch.Tensor, last_x, shift, mus: list,
           cut: list) -> list:
    """x's lerp with its predecessor features ``shift(x, last_x)`` by
    each of ``mus``. A lerp whose ``cut`` is set feeds a column-parallel
    weight: it reads x, ``last_x`` and its mu copied into the TP region
    (one copy of each, the mus stacked), where their gradients are
    partial sums."""
    xx = shift(x, last_x)
    if any(cut):
        xt, lt = L.into_tp(ctx, x, last_x)
        xxt = shift(xt, lt)
        tp_mus = iter(L.into_tp(ctx, torch.stack(
            [mu for mu, c in zip(mus, cut) if c]))[0].unbind(0))
    out = []
    for mu, c in zip(mus, cut):
        a, b = (xt, xxt) if c else (x, xx)
        out.append(a + (b - a) * (next(tp_mus) if c else mu))
    return out


_TM = ("r", "k", "v", "g")


def _tm_cut(ctx: LayerCtx, tm: Params) -> list:
    d = ctx.cfg.d_model
    return [ctx.model_sharded(tm[f"w_{c}"], -1, d) for c in _TM]


def state_heads(ctx: LayerCtx, tm: Params) -> tuple[int, int]:
    """(first, count) of the heads whose WKV state this rank holds (its
    own under TP on whole heads, else all of them)."""
    return L.own_heads(ctx, _tm_cut(ctx, tm), _heads(ctx.cfg)[0])


def _tm_inputs(ctx: LayerCtx, tm: Params, x: torch.Tensor, last_x, shift):
    """The time mix's r, k, v, g (over this rank's heads under TP, else
    whole), the decay's lerp (of the whole residual), and the heads they
    hold (``h`` whole, or this rank's ``h / model``)."""
    h, _ = _heads(ctx.cfg)
    cut = _tm_cut(ctx, tm)
    *xs, xw = _lerps(ctx, x, last_x, shift,
                     [tm[f"mu_{c}"] for c in (*_TM, "w")], cut + [False])
    ys = [ctx.matmul(xc, tm[f"w_{c}"]) for xc, c in zip(xs, _TM)]
    _, nh = L.own_heads(ctx, cut, h)
    if nh == h:
        return L.gather_cut(ctx, ys, cut), xw, h
    for y in ys:
        L.check_shard(ctx, y, "act_qkv", ctx.cfg.d_model)
    return ys, xw, nh


def _tm_leaves(ctx: LayerCtx, tm: Params, nh: int):
    """decay_B, decay_base, bonus_u and ln_out over ``nh`` heads: the
    leaves themselves when they are all the heads, else this rank's cut
    of them, f32, in one ``split_to`` (backward: each rank's slice of
    their gradients, gathered)."""
    h, n = _heads(ctx.cfg)
    leaves = (tm["decay_B"], tm["decay_base"], tm["bonus_u"], tm["ln_out"])
    if nh == h:
        return leaves
    d = h * n
    cut = C.split_to(torch.cat([
        tm["decay_B"], tm["decay_base"][None], tm["bonus_u"].reshape(1, d),
        tm["ln_out"].float()[None]]), -1, ctx.mesh, ctx.rules.model_axis)
    return cut[:-3], cut[-3], cut[-2].reshape(nh, n), cut[-1]


def time_mix_chunked(ctx: LayerCtx, tm: Params, x: torch.Tensor,
                     state0: Optional[torch.Tensor] = None,
                     last_x: Optional[torch.Tensor] = None, *,
                     return_state: bool = False,
                     valid: Optional[torch.Tensor] = None):
    """x (B, T, D) -> out (B, T, D) (+ the final state (B, H, N, N) f32
    and x's last row, with ``return_state``). ``valid`` (B, T) bool:
    padding positions neither decay nor write the state. T pads
    internally to a CHUNK multiple. Under TP on whole heads ``state0``
    and the state returned hold this rank's heads."""
    cfg = ctx.cfg
    _, n = _heads(cfg)
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
    (r, k, v, g), xw, h = _tm_inputs(ctx, tm, x, last_x, _shift)
    decay_b, decay_base, bonus_u, ln_out = _tm_leaves(ctx, tm, h)
    gate = F.silu(g)
    logw = _decay_logw(ctx, tm, xw, decay_b, decay_base)   # (B,T,HN) f32
    if valid is not None:
        vm = valid[..., None]
        k = torch.where(vm, k, 0)        # no state write at padding
        logw = torch.where(vm, logw, 0)  # no decay at padding

    c = min(CHUNK, t)
    nc = t // c
    shape = (b, nc, c, h, n)
    rr, kk, vv = (a.reshape(shape).float() for a in (r, k, v))
    lw = logw.reshape(shape)

    la = torch.cumsum(lw, dim=2)                               # (B,NC,C,H,N)
    la_prev = la - lw
    la_end = la[:, :, -1:]

    # per-chunk summaries, then the states across chunks
    dec = torch.exp(la_end[:, :, 0])                           # (B,NC,H,N)
    kd = kk * torch.exp(la_end - la)                           # exps <= 0
    u_mat = torch.einsum("bcthn,bcthm->bchnm", kd, vv)         # (B,NC,H,N,N)
    if state0 is None:
        state0 = torch.zeros((b, h, n, n), dtype=torch.float32,
                             device=x.device)
    s_end = _chunk_states(dec, u_mat, state0)                  # (B,NC,H,N,N)
    s_start = torch.cat([state0[:, None], s_end[:, :-1]], dim=1)

    # within each chunk
    q_t = rr * torch.exp(la_prev)                              # exps <= 0
    inter = torch.einsum("bcthn,bchnm->bcthm", q_t, s_start)
    k_neg = kk * torch.exp(torch.clamp(-la, -_CLAMP, _CLAMP))
    scores = torch.einsum("bcthn,bcshn->bchts", q_t, k_neg)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=x.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    intra = torch.einsum("bchts,bcshn->bcthn", scores, vv)
    diag = (rr * bonus_u * kk).sum(-1, keepdim=True) * vv
    out = (inter + intra + diag).reshape(b, t, h * n)

    out = _headnorm(out, ln_out, h, n).to(x.dtype) * gate
    out = L.row_parallel(ctx, out, tm["w_o"], d, "act_attn_out")[:, :t_in]
    if return_state:
        return out, s_end[:, -1], x[:, t_in - 1]
    return out


def time_mix_step(ctx: LayerCtx, tm: Params, x: torch.Tensor,
                  state: torch.Tensor, last_x: torch.Tensor):
    """One token. x (B, D); state (B, H, N, N) f32 (this rank's heads
    under TP on whole heads); last_x (B, D). Returns (out (B, D), new
    state, x)."""
    _, n = _heads(ctx.cfg)
    b, d = x.shape
    (r, k, v, g), xw, h = _tm_inputs(ctx, tm, x, last_x, _step_shift)
    decay_b, decay_base, bonus_u, ln_out = _tm_leaves(ctx, tm, h)
    r, k, v = r.float(), k.float(), v.float()
    gate = F.silu(g)
    w = torch.exp(_decay_logw(ctx, tm, xw, decay_b,
                              decay_base)).reshape(b, h, n)
    rr, kk, vv = (a.reshape(b, h, n) for a in (r, k, v))

    kv = kk[..., :, None] * vv[..., None, :]                   # (B,H,N,N)
    att = state + bonus_u[None, :, :, None] * kv
    o = torch.einsum("bhn,bhnm->bhm", rr, att).reshape(b, h * n)
    new_state = w[..., None] * state + kv
    o = _headnorm(o[:, None], ln_out, h, n)[:, 0].to(x.dtype) * gate
    return (L.row_parallel(ctx, o, tm["w_o"], d, "act_attn_out"),
            new_state, x)


# ---------------------------------------------------------------------------
# Channel mixing
# ---------------------------------------------------------------------------


def channel_mix(ctx: LayerCtx, cm: Params, x: torch.Tensor,
                last_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, D) with the shift inside, or one token x (B, D) with
    ``last_x`` its predecessor's features."""
    cfg = ctx.cfg
    cut = [ctx.model_sharded(cm["w_k"], -1, cfg.d_ff),
           ctx.model_sharded(cm["w_r"], -1, cfg.d_model)]
    xk, xr = _lerps(ctx, x, last_x, _shift if x.dim() == 3 else _step_shift,
                    [cm["mu_k"], cm["mu_r"]], cut)
    k = torch.square(torch.relu(ctx.matmul(xk, cm["w_k"])))
    out = L.row_parallel(ctx, k, cm["w_v"], cfg.d_ff, "act_ffn")
    # the receptance multiplies the whole reduced output
    r = L.gather_cut(ctx, [ctx.matmul(xr, cm["w_r"])], cut[1:])[0]
    return out * torch.sigmoid(r)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def block(ctx: LayerCtx, p: Params, x, positions=None):
    """The train block: the chunked time mix, then the channel mix, each
    with its residual (no positions: RWKV has no rope). Returns
    (x, aux = 0)."""
    cfg = ctx.cfg
    h = L.norm(cfg, p["tm_norm"], x)
    x = x + time_mix_chunked(ctx, p["tm"], h)
    h = L.norm(cfg, p["cm_norm"], x)
    x = x + channel_mix(ctx, p["cm"], h)
    return x, tfm.no_aux(x)


def train_loss(ctx: LayerCtx, params: Params, batch: dict, *,
               remat: bool = True) -> torch.Tensor:
    return tfm.train_loss(ctx, params, batch, remat=remat, block_fn=block)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, layout, dtype=None, device="cuda") -> dict:
    """The recurrent state of every slot, zero-filled: O(1) in max_seq."""
    batch = require_dense(layout, cfg.family).num_slots
    h, n = _heads(cfg)
    dev = resolve(device)
    act = dtype or L.adt(cfg)
    return {
        "state": torch.zeros((cfg.num_layers, batch, h, n, n),
                             dtype=torch.float32, device=dev),
        "tm_x": torch.zeros((cfg.num_layers, batch, cfg.d_model), dtype=act,
                            device=dev),
        "cm_x": torch.zeros((cfg.num_layers, batch, cfg.d_model), dtype=act,
                            device=dev),
    }


def prefill(ctx: LayerCtx, params: Params, tokens, lengths, cache: dict,
            **kw):
    """Whole prompts (B, T) in the chunked-parallel form; each layer's
    final state and shift features land in the cache in place. Ragged
    rows are exact: positions >= lengths are masked out of the
    recurrence, and the shift features come from each row's own last
    position. Returns last-token logits (B, Vp) and the cache."""
    cfg = ctx.cfg
    x = L.embed(ctx, params, tokens)
    t = x.shape[1]
    valid = (torch.arange(t, device=x.device)[None, :]
             < lengths.to(x.device)[:, None])

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["tm_norm"], xx)
        tm_out, s_end, _ = time_mix_chunked(ctx, p_i["tm"], h,
                                            return_state=True, valid=valid)
        xx = xx + tm_out
        h2 = L.norm(cfg, p_i["cm_norm"], xx)
        xx = xx + channel_mix(ctx, p_i["cm"], h2)
        c_i["state"].copy_(s_end)
        # the shift features at each row's own last position
        c_i["tm_x"].copy_(tfm._last_rows(h, lengths)[:, 0])
        c_i["cm_x"].copy_(tfm._last_rows(h2, lengths)[:, 0])
        return xx

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    logits = L.lm_logits(ctx, params, tfm._last_rows(x, lengths))[:, 0]
    return logits, cache


def decode_step(ctx: LayerCtx, params: Params, tokens, cache: dict, lengths,
                *, block_tables=None, decode_groups=None, positions=None):
    """One token a slot through the recurrence; the state and shift
    features update in place. ``lengths`` and ``positions`` are accepted
    for the uniform engine operands (the state has no rope). Under the
    ``"looped"`` granularity on the card the step replays one CUDA graph
    (:func:`stack.run_decode`), its logits in the graph's static output.
    Returns (logits (B, Vp), cache)."""
    if block_tables is not None or decode_groups is not None:
        raise ValueError("the ssm state cache has no paged layout")
    step = functools.partial(_decode_step, ctx, params, cache)
    return stack.run_decode(ctx.graphs, step, params, cache,
                            dict(tokens=tokens)), cache


def _decode_step(ctx: LayerCtx, params: Params, cache: dict, *, tokens):
    """The decode step's work: logits (B, Vp), the cache written in
    place."""
    cfg = ctx.cfg
    x = L.embed(ctx, params, tokens)                  # (B, D)

    def blk(p_i, xx, c_i):
        h = L.norm(cfg, p_i["tm_norm"], xx)
        o, new_state, tm_last = time_mix_step(ctx, p_i["tm"], h,
                                              c_i["state"], c_i["tm_x"])
        xx = xx + o
        h2 = L.norm(cfg, p_i["cm_norm"], xx)
        xx = xx + channel_mix(ctx, p_i["cm"], h2, last_x=c_i["cm_x"])
        c_i["state"].copy_(new_state)
        c_i["tm_x"].copy_(tm_last)
        c_i["cm_x"].copy_(h2)
        return xx

    x, cache = stack.run_stack_cached(params["layers"], x, cache, blk)
    x = L.norm(cfg, params["final_norm"], x)
    return L.lm_logits(ctx, params, x[:, None])[:, 0]
