"""Shared building blocks of the model families.

Plain functions over params dicts of tensors (layer params stacked on a
leading L axis by the model constructors). Every GEMM goes through
:func:`repro_torch.kernels.ops.matmul` (the gated FFN's gate and up
through ``ops.fused_ffn`` when the plan fuses them) and every attention
through the ``ops`` front doors, so the plan decides which kernel runs.

The decode layer keeps the JAX package's four stage boundaries, which a
fusion backend can claim (``DecodeFusionPlan.granularity``):

  A. ingest   — norm → QKV → bias → rope         (:func:`decode_ingest`)
  B. attend   — KV write → decode attention      (:func:`decode_attend`,
                :func:`decode_attend_paged`)
  C. epilogue — o_proj → residual add            (:func:`decode_epilogue`)
  D. mlp      — norm → gate/up → act → down → residual (:func:`decode_mlp`)

``"split"`` composes each stage from the op chain; ``"fused"`` and
``"looped"`` send the A, C and D seams through ``ops.decode_ingest`` /
``ops.oproj_residual`` / ``ops.ffn_norm`` (one kernel per seam on
``"cuda"``, the oracles that compose the split chain's expressions on
``"torch"``); ``"looped"`` also replays the whole decode step as one CUDA
graph (:class:`~repro_torch.models.stack.LoopedDecode`, kept on the
context). Stage B keeps its own plan-governed dispatch. KV appends update
the dense cache or the paged pool in place through one sync-free masked
write (:class:`KVWrite`); a quantized pool (int8 / fp8 codes with
``k_scale`` / ``v_scale`` step pools) appends through the step's
:class:`~repro_torch.serving.kvquant.QuantWrite` instead, and its scale
views ride into the attention front doors.

Training adds :func:`cross_entropy_loss`, the next-token loss over
chunks of the sequence, recomputed chunk by chunk in the backward pass.
Under a mesh (``LayerCtx.mesh`` / ``rules``) the train layers compute on
this rank's tensor-parallel param shards, Megatron's way: column-parallel
``wq`` / ``wk`` / ``wv`` and ``w_gate`` / ``w_up`` behind
``collectives.copy_to``, row-parallel ``wo`` / ``w_down`` followed by one
SUM all-reduce over ``model`` (``collectives.reduce_from``), the
embedding and the tied head vocabulary-parallel (a masked lookup, then an
all-reduce; the loss's log-sum-exp reduced over ``model`` by a max and a
sum, so the (B, S, V) logits are never gathered). A leaf is model-sharded
where its shape is (``Rules.param_spec``'s divisibility); whole params
compute as on one card. FSDP is the caller's (the train step, or
``serving/sharded.py``): the layers see the FSDP dims gathered.

Serving on a mesh keeps the JAX package's layout: the decode tick's
q / k / v gathered whole on every rank (:func:`attention_qkv` with
``whole``), attention over this rank's slice of the sequence-split cache
(``LayerCtx.decode_attention_fn``), ``wo`` row-parallel, the MLP column-
then row-parallel, the embedding vocabulary-parallel and the logits
gathered whole (:func:`lm_logits`); prefill writes this rank's slice of
each cache (:func:`write_prompt_kv`).

A GEMM weight leaf (``wq`` … ``w_down``) is a tensor or, under a quantized
``weight_dtype``, the ``{"codes", "scale"}`` dict of ``models/wquant.py``.
Nothing here reads a weight's shape, dtype or transpose: every GEMM goes
through an ``ops`` front door, which takes either form, and the looped
graph reads the codes and steps in place like any other param.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, SoftmaxPhiConfig
from repro_torch.core.plan import DEFAULT_PLAN, ExecutionPlan
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import no_shard
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ffn_activation
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm
from repro_torch.kernels.ref import rope_ref as rope
from repro_torch.models.stack import LoopedDecode

Params = dict

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def adt(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.activation_dtype)


@dataclasses.dataclass(frozen=True)
class LayerCtx:
    """Per-call context threaded through every layer. Under the
    ``"looped"`` granularity it makes and carries the decode step's CUDA
    graphs (``graphs``), so every step run through one context shares
    them, and no other plan can replay them."""

    cfg: ModelConfig
    plan: ExecutionPlan = DEFAULT_PLAN
    # MoE routing group count (the data-parallel shard count at scale)
    moe_groups: int = 1
    # sequence-split decode attention over this rank's slice of the dense
    # cache, (q, k_loc, v_loc, lengths) -> o, with kv_start(s_loc) the
    # slice's first position (core.attention.make_decode_attention_fn)
    decode_attention_fn: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    # the sharded train path: shard(x, role, global_shape) checks an
    # activation's local shard (distributed.make_shard_fn), mesh is this
    # rank's launch.mesh.Mesh and rules its distributed.Rules; None on
    # one device
    shard: Callable = dataclasses.field(default=no_shard, compare=False,
                                        repr=False)
    mesh: Optional[object] = dataclasses.field(default=None, compare=False,
                                               repr=False)
    rules: Optional[object] = None
    graphs: Optional[LoopedDecode] = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.plan.decode_fusion.granularity == "looped":
            if self.decode_attention_fn is not None:
                raise ValueError(
                    "decode_fusion='looped' with a sharded decode_attention_"
                    "fn: a CUDA graph cannot capture the gloo collectives of "
                    "the sequence split (ROADMAP.md, slice 8b-3c); use "
                    "'split' or 'fused'")
            object.__setattr__(self, "graphs", LoopedDecode())

    @property
    def fused(self) -> bool:
        """The decode stages go through the fused seams."""
        return self.plan.decode_fusion.granularity != "split"

    @property
    def phi_cfg(self) -> SoftmaxPhiConfig:
        if not self.cfg.has_softmax_attention:
            return SoftmaxPhiConfig(enabled=False)
        return self.cfg.softmax_phi

    def matmul(self, x: torch.Tensor, w) -> torch.Tensor:
        return ops.matmul(x, w, plan=self.plan)

    def model_sharded(self, w, dim: int, full: int) -> bool:
        """Dim ``dim`` of the param ``w`` (``full`` elements whole) is cut
        over ``model`` here. Never without a mesh (nor is ``w`` read
        then); a quantized weight is read through its codes."""
        if self.mesh is None:
            return False
        if isinstance(w, dict):
            w = w["codes"]
        return w.shape[dim] != full

    def kv_start(self, s_loc: int) -> int:
        """The first position of this rank's ``s_loc``-wide slice of a
        sequence-split cache: 0 unless ``decode_attention_fn`` splits the
        cache (every rank of a sharded serving context holds a slice)."""
        fn = self.decode_attention_fn
        return 0 if fn is None else fn.kv_start(s_loc)


def check_shard(ctx: LayerCtx, x: torch.Tensor, role: str,
                width: int) -> None:
    """``ctx.shard`` on this rank's ``x`` (B_loc, ..., n) whose global
    shape is (B_loc x the batch shards, ..., width)."""
    if ctx.mesh is not None:
        nb = ctx.mesh.axes_size(ctx.rules.act_batch_axes)
        ctx.shard(x, role, (x.shape[0] * nb, *x.shape[1:-1], width))


def _model(ctx: LayerCtx) -> str:
    return ctx.rules.model_axis


def own_heads(ctx: LayerCtx, cut: list, h: int) -> tuple[int, int]:
    """(first, count) of the ``h`` heads this rank computes: its own
    ``h / model`` where every weight that forms them is ``cut`` on whole
    heads, else all of them (the cut outputs are gathered)."""
    m = 1 if ctx.mesh is None else ctx.mesh.size(_model(ctx))
    if all(cut) and m > 1 and h % m == 0:
        return ctx.mesh.coord(_model(ctx)) * (h // m), h // m
    return 0, h


def into_tp(ctx: LayerCtx, *xs):
    """Each of ``xs`` copied into the tensor-parallel region
    (``collectives.copy_to`` over ``model``: its gradient there is a
    partial sum on each rank, summed by one all-reduce in the backward
    pass); None stays None."""
    return [None if x is None else C.copy_to(x, ctx.mesh, _model(ctx))
            for x in xs]


def gather_cut(ctx: LayerCtx, ys: list, cut: list, *,
               summed: bool = False) -> list:
    """``ys`` with each one whose ``cut`` is set gathered whole over
    ``model`` (one all-gather). The backward pass keeps this rank's slice
    of each gradient, summed over ``model`` first with ``summed`` (where
    each rank uses the whole tensor on its own share of the work)."""
    idx = [i for i, c in enumerate(cut) if c]
    if not idx:
        return list(ys)
    cuts = [ys[i] for i in idx]
    whole = (C.fsdp_gather(cuts, [-1] * len(cuts), ctx.mesh, _model(ctx))
             if summed else C.gather_from(cuts, -1, ctx.mesh, _model(ctx)))
    out = list(ys)
    for i, y in zip(idx, whole):
        out[i] = y
    return out


def row_parallel(ctx: LayerCtx, y: torch.Tensor, w, full: int,
                 role: str) -> torch.Tensor:
    """y (..., ``full`` features, or this rank's cut of them) through w
    (``full``, N): row-parallel where w's input dim is cut over ``model``
    (y cut here if it came whole, checked as the activation ``role``,
    then one all-reduce after the product), else whole (y gathered if it
    came cut)."""
    if not ctx.model_sharded(w, 0, full):
        if y.shape[-1] != full:
            y = C.gather_from([y], -1, ctx.mesh, _model(ctx))[0]
        return ctx.matmul(y, w)
    if y.shape[-1] == full:
        y = C.split_to(y, -1, ctx.mesh, _model(ctx))
    check_shard(ctx, y, role, full)
    return C.reduce_from(ctx.matmul(y, w), ctx.mesh, _model(ctx))


# ---------------------------------------------------------------------------
# Norms, activations (rmsnorm and rope are ref.rmsnorm_ref / ref.rope_ref)
# ---------------------------------------------------------------------------


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The JAX package's layernorm: mean and (population) variance in f32,
    ``(x - mu) * rsqrt(var + eps) * scale + bias``, one rounding."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# Initializers (stacked over L layers; same distributions as the JAX
# package's layers.dense_init: normal * fan_in^-1/2, zero biases, unit norms)
# ---------------------------------------------------------------------------


def init_generator(generator: Optional[torch.Generator],
                   device: torch.device) -> Optional[torch.Generator]:
    """The generator an ``init_params`` draws from: ``generator``, or one
    on ``device`` seeded with 0. On the meta device there is nothing to
    draw (and torch makes no meta generator): ``None``, and every init
    call then builds its leaf's shape and dtype only."""
    if device.type == "meta":
        return None
    return generator or torch.Generator(device=device).manual_seed(0)


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               fan_in: int) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * fan_in ** -0.5).to(dtype)


def norm_params(cfg: ModelConfig, lead: tuple, device) -> Params:
    shape = (*lead, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=pdt(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=pdt(cfg), device=device)
    return p


def attention_params(cfg: ModelConfig, gen, num_layers: int,
                     device) -> Params:
    d, dt, L = cfg.d_model, pdt(cfg), num_layers
    p = {
        "wq": dense_init(gen, (L, d, cfg.q_dim), dt, device, d),
        "wk": dense_init(gen, (L, d, cfg.kv_dim), dt, device, d),
        "wv": dense_init(gen, (L, d, cfg.kv_dim), dt, device, d),
        "wo": dense_init(gen, (L, cfg.q_dim, d), dt, device, cfg.q_dim),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((L, n), dtype=dt, device=device)
    return p


def mlp_params(cfg: ModelConfig, gen, num_layers: int, device) -> Params:
    d, f, dt, L = cfg.d_model, cfg.d_ff, pdt(cfg), num_layers
    p = {}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (L, d, f), dt, device, d)
    p["w_up"] = dense_init(gen, (L, d, f), dt, device, d)
    p["w_down"] = dense_init(gen, (L, f, d), dt, device, f)
    return p


def vocab_padded(cfg: ModelConfig, multiple: int = 256) -> int:
    v = cfg.vocab_size
    return (v + multiple - 1) // multiple * multiple


def embed_params(cfg: ModelConfig, gen, device) -> Params:
    vp = vocab_padded(cfg)
    p = {"embedding": dense_init(gen, (vp, cfg.d_model), pdt(cfg), device,
                                 cfg.d_model)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, vp), pdt(cfg), device,
                                  cfg.d_model)
    return p


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_qkv(ctx: LayerCtx, p: Params, x: torch.Tensor,
                  positions: torch.Tensor, *, use_rope: bool = True,
                  kv_x: Optional[torch.Tensor] = None, whole: bool = False):
    """x: (B, S, D) -> q (B,S,HQ,Dh), k/v (B,S,HK,Dh), rope applied
    unless ``use_rope=False``; with ``kv_x`` (B, Sk, D) the keys and
    values are projected from it, without bias (cross-attention). Under a
    mesh, model-sharded (column-parallel) projections give this rank's
    heads when every one of them splits on whole heads (HQ and HK
    divisible over ``model``); where a split cuts a head (qwen2-0.5b's
    14 / 2 heads over ``model`` = 4), the sharded outputs are
    all-gathered over ``model`` before the heads are formed, and the
    attention that follows is replicated. With ``whole`` they are
    gathered whatever the head count: the decode tick's layout, in which
    the new token's q / k / v are whole on every rank (the JAX package's
    ``act_decode_rep``) and the cache holds whole heads."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    q, k, v = _qkv_proj(ctx, p, x, kv_x, whole)
    sk = s if kv_x is None else kv_x.shape[1]
    q = q.reshape(b, s, -1, cfg.head_dim)
    k = k.reshape(b, sk, -1, cfg.head_dim)
    v = v.reshape(b, sk, -1, cfg.head_dim)
    if not use_rope:
        return q, k, v
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _qkv_proj(ctx: LayerCtx, p: Params, x: torch.Tensor,
              kv_x: Optional[torch.Tensor] = None,
              whole: bool = False) -> list:
    cfg = ctx.cfg
    cross = kv_x is not None
    src = (x, x, x) if not cross else (x, kv_x, kv_x)
    parts = (("wq", "bq", cfg.q_dim, "act_qkv"),
             ("wk", "bk", cfg.kv_dim, "act_kv"),
             ("wv", "bv", cfg.kv_dim, "act_kv"))
    sharded = [ctx.model_sharded(p[w], -1, n) for w, _, n, _ in parts]
    # one copy into the TP region per input the sharded projections
    # read; a replicated one reads its input itself (its gradient is
    # already whole)
    tp_in = {}
    for inp, sh in zip(src, sharded):
        if sh and id(inp) not in tp_in:
            tp_in[id(inp)] = C.copy_to(inp, ctx.mesh, _model(ctx))
    outs = []
    for (w, bias, n, role), inp, sh in zip(parts, src, sharded):
        y = ctx.matmul(tp_in[id(inp)] if sh else inp, p[w])
        if cfg.qkv_bias and (w == "wq" or not cross):
            y = y + p[bias]
        if sh:
            check_shard(ctx, y, role, n)
        outs.append(y)
    if any(sharded):
        m = ctx.mesh.size(_model(ctx))
        if whole or not (all(sharded) and cfg.num_heads % m == 0
                         and cfg.num_kv_heads % m == 0):
            outs = gather_cut(ctx, outs, sharded)
    return outs


def attention_block(ctx: LayerCtx, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    use_rope: bool = True,
                    kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (an encoder; cross-attention with
    ``kv_x``, the encoder's output, whose keys and values
    :func:`attention_qkv` projects) and its output projection
    (:func:`attention_out`). x: (B, S, D) -> (B, S, D)."""
    q, k, v = attention_qkv(ctx, p, x, positions, use_rope=use_rope,
                            kv_x=kv_x)
    return attention_out(ctx, p, q, k, v, causal=causal)


def attention_out(ctx: LayerCtx, p: Params, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """q (B, S, H, Dh) against k / v (B, Sk, HK, Dh) through the prefill
    kernel (``ops.attention_prefill``, row 7), then the output projection
    (row-parallel under a mesh): (B, S, D)."""
    cfg = ctx.cfg
    b, s = q.shape[:2]
    o = ops.attention_prefill(q, k, v, phi_cfg=ctx.phi_cfg, causal=causal,
                              sliding_window=cfg.sliding_window,
                              plan=ctx.plan)
    # row-parallel wo under TP: this rank's columns of o (cut there when
    # the heads were gathered), then one all-reduce before the residual
    return row_parallel(ctx, o.reshape(b, s, -1), p["wo"], cfg.q_dim,
                        "act_attn_out")


def decode_ingest(ctx: LayerCtx, norm_p: Params, p: Params, x: torch.Tensor,
                  position: torch.Tensor):
    """Stage A: norm → QKV → bias → rope. x: (B, 1, D); position (B,).
    Returns q (B, 1, HQ, Dh), k / v (B, 1, HK, Dh), whole on every rank
    under a mesh. The fused seam claims rmsnorm models with whole
    weights only; others, and model-cut weights, keep the split
    composition (column-parallel, then gathered): on the ``"torch"``
    backend the seam's oracle is that composition (the JAX package's
    layers.py:217-222), and the seam's kernel takes whole weights."""
    cfg = ctx.cfg
    if (ctx.fused and cfg.norm == "rmsnorm"
            and not ctx.model_sharded(p["wq"], -1, cfg.q_dim)):
        return ops.decode_ingest(
            x, norm_p["scale"], p["wq"], p["wk"], p["wv"], position,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"), plan=ctx.plan)
    h = norm(cfg, norm_p, x)
    return attention_qkv(ctx, p, h, position[:, None], whole=True)


def whole_heads(ctx: LayerCtx, *ts) -> list:
    """k / v (B, S, HK_loc, Dh) with their heads gathered whole over
    ``model`` where the column-parallel projection left them cut (one
    all-gather): what a cache of whole heads stores."""
    if ctx.mesh is None or ts[0].shape[-2] == ctx.cfg.num_kv_heads:
        return list(ts)
    return C.gather_from(list(ts), -2, ctx.mesh, _model(ctx))


def write_prompt_kv(ctx: LayerCtx, cache_i: dict, k, v) -> None:
    """A prompt's KV (B, S, HK, Dh) into positions [0, S) of a layer's
    dense cache, in place; positions past the cache's width are prompt
    padding (a prompt fits ``max_seq``) and are dropped. On a
    sequence-split context this rank's slice takes positions [start,
    start + S_loc) (``ctx.kv_start``), the heads gathered whole first."""
    k, v = whole_heads(ctx, k, v)
    ck, cv = cache_i["k"], cache_i["v"]
    s_loc = ck.shape[1]
    start = ctx.kv_start(s_loc)
    n = max(0, min(k.shape[1] - start, s_loc))
    ck[:, :n] = k[:, start:start + n].to(ck.dtype)
    cv[:, :n] = v[:, start:start + n].to(cv.dtype)


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """cache (B, S, H, D) <- new (B, H, D) at each row's length, in place
    (the JAX package donates its buffers instead)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache.index_put_((rows, lengths.long()), new.to(cache.dtype))


@dataclasses.dataclass(frozen=True)
class KVWrite:
    """Where one step's new KV entries land, as flat row ids into a
    layer's KV storage viewed as ``(N, HK, Dh)`` rows. The same for every
    layer of a step, so the model computes it once per step.

    Dropped entries (chunk padding, spectator rows, sentinel pages) must
    write nothing, and without a host sync: :meth:`put` folds them into
    the index instead. A dropped entry rewrites the first kept entry's
    row with that entry's own value, or, when no entry is kept, its own
    row's current value; every row named twice thus receives one value,
    and ``index_put_``'s unspecified order among duplicates cannot
    matter.
    """

    target: torch.Tensor    # (M,) int64 row ids, inside the storage
    keep: torch.Tensor      # (M,) bool
    first: torch.Tensor     # (1,) int64, first kept entry (0 if none)
    some: torch.Tensor      # (1,) bool, any entry kept

    @classmethod
    def build(cls, target, keep, n_rows: int) -> "KVWrite":
        # (1,)-shaped selectors, never 0-dim ones: indexing with a 0-dim
        # device tensor would read it back to the host
        target = target.reshape(-1).clamp(0, n_rows - 1)
        keep = keep.reshape(-1)
        first = torch.argmax(keep.to(torch.uint8), dim=0, keepdim=True)
        some = keep.index_select(0, first)
        target = torch.where(keep, target, torch.where(
            some, target.index_select(0, first), target))
        return cls(target, keep, first, some)

    def put(self, store: torch.Tensor, new: torch.Tensor) -> None:
        """store (..., HK, Dh) contiguous <- new (B, C, HK, Dh), in place."""
        rows = store.view(-1, *store.shape[-2:])
        vals = new.reshape(-1, *rows.shape[1:]).to(rows.dtype)
        vals = torch.where(self.keep[:, None, None], vals, torch.where(
            self.some[:, None, None], vals.index_select(0, self.first),
            rows[self.target]))
        rows.index_put_((self.target,), vals)


def dense_chunk_write(cache: torch.Tensor, lengths: torch.Tensor,
                      chunk_lens: torch.Tensor, c: int) -> KVWrite:
    """Chunk entries into a dense (B, S, HK, Dh) layer cache: row b's
    entry i lands at position ``lengths[b] + i`` while ``i <
    chunk_lens[b]``; the rest are dropped."""
    b, s = cache.shape[:2]
    ar = torch.arange(c, device=cache.device)
    pos = lengths[:, None].long() + ar[None, :]
    keep = ar[None, :] < chunk_lens[:, None]
    rows = torch.arange(b, device=cache.device)[:, None] * s \
        + pos.clamp(0, s - 1)
    return KVWrite.build(rows, keep, b * s)


def paged_chunk_write(pool: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor, chunk_lens: torch.Tensor,
                      c: int) -> KVWrite:
    """Chunk entries into an (NP, PS, HK, Dh) layer pool: logical position
    ``lengths[b] + i`` lands at page ``block_tables[b, pos // PS]``, row
    ``pos % PS``. Entries past a row's ``chunk_lens`` and entries whose
    table entry is the unassigned sentinel ``NP`` (empty slots) are
    dropped, as the JAX package's out-of-bounds ``mode="drop"`` scatter
    drops them."""
    num_pages, ps = pool.shape[:2]
    ar = torch.arange(c, device=pool.device)
    pos = lengths[:, None].long() + ar[None, :]
    page = (pos // ps).clamp(0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, page)
    keep = (ar[None, :] < chunk_lens[:, None]) & (phys < num_pages)
    return KVWrite.build(phys * ps + pos % ps, keep, num_pages * ps)


def slice_decode_write(cache: torch.Tensor, lengths: torch.Tensor,
                       start: int) -> KVWrite:
    """One new entry a row into a rank's slice (B, S_loc, HK, Dh) of a
    sequence-split dense cache, positions ``start .. start + S_loc - 1``:
    row b's entry lands at ``lengths[b] - start`` where the slice holds
    position ``lengths[b]``, and is dropped on every other rank."""
    b, s = cache.shape[:2]
    pos = lengths.long() - start
    keep = (pos >= 0) & (pos < s)
    rows = torch.arange(b, device=cache.device) * s + pos.clamp(0, s - 1)
    return KVWrite.build(rows, keep, b * s)


def decode_attend(ctx: LayerCtx, q, k, v, cache_k, cache_v, lengths):
    """Stage B (dense layout): append this token's KV at each row's
    length, attend over the cache. Returns o (B, 1, HQ*Dh). With a
    ``ctx.decode_attention_fn`` the caches are this rank's slice of a
    sequence-split cache: the KV lands only on the rank that holds
    position ``lengths[b]`` and the function attends across the ranks
    (``lengths`` stay global)."""
    fn = ctx.decode_attention_fn
    if fn is None:
        _scatter_kv(cache_k, k[:, 0], lengths)
        _scatter_kv(cache_v, v[:, 0], lengths)
        o = ops.attention_decode(q[:, 0], cache_k, cache_v, lengths + 1,
                                 phi_cfg=ctx.phi_cfg, plan=ctx.plan)
    else:
        write = slice_decode_write(cache_k, lengths,
                                   fn.kv_start(cache_k.shape[1]))
        write.put(cache_k, k)
        write.put(cache_v, v)
        o = fn(q[:, 0], cache_k, cache_v, lengths + 1)
    return o.reshape(q.shape[0], 1, ctx.cfg.q_dim)


def attention_decode_block(ctx: LayerCtx, p: Params, x, position, cache_k,
                           cache_v, lengths, *, use_rope: bool = True):
    """One-token decode attention in the split composition, for callers
    that norm outside and own the residual (the encoder-decoder's
    self-attention): QKV at ``position`` → the KV appended at each row's
    length in place → decode attention (rows 3-4) → the output
    projection (row-parallel under a mesh). x: (B, 1, D) -> (B, 1, D)."""
    q, k, v = attention_qkv(ctx, p, x, position[:, None], use_rope=use_rope,
                            whole=True)
    o = decode_attend(ctx, q, k, v, cache_k, cache_v, lengths)
    return row_parallel(ctx, o, p["wo"], ctx.cfg.q_dim, "act_attn_out")


def decode_epilogue(ctx: LayerCtx, p: Params, o, resid):
    """Stage C: ``resid + o @ wo``, one fused launch when claimed and
    ``wo`` is whole; a model-cut ``wo`` is row-parallel (the split
    composition, which the seam's oracle equals on ``"torch"``)."""
    if ctx.fused and not ctx.model_sharded(p["wo"], 0, ctx.cfg.q_dim):
        return ops.oproj_residual(o, p["wo"], resid, plan=ctx.plan)
    return resid + row_parallel(ctx, o, p["wo"], ctx.cfg.q_dim,
                                "act_attn_out")


def decode_mlp(ctx: LayerCtx, norm_p: Params, p: Params, x):
    """Stage D: norm → gate/up → act → down → residual. When claimed, two
    fused launches: ``ops.ffn_norm`` (the norm inside the gate/up pair)
    and ``ops.oproj_residual`` reused for ``x + h @ w_down``. The seam
    claims rmsnorm models with a gated (swiglu / geglu) FFN and whole
    weights only; others keep the split composition (column- then
    row-parallel under a mesh, as the trainer's)."""
    cfg = ctx.cfg
    if (ctx.fused and cfg.norm == "rmsnorm"
            and cfg.activation in ("swiglu", "geglu")
            and not ctx.model_sharded(p["w_down"], 0, cfg.d_ff)):
        h = ops.ffn_norm(x, norm_p["scale"], p["w_gate"], p["w_up"],
                         activation=cfg.activation, plan=ctx.plan)
        return ops.oproj_residual(h, p["w_down"], x, plan=ctx.plan)
    h = norm(cfg, norm_p, x)
    return x + mlp_block(ctx, p, h)


def _append(write, store_k, store_v, k, v, k_scale, v_scale) -> None:
    """The step's KV entries into this layer's storage, in place: through
    the quantized scatter when step pools ride along (``write`` is then
    the step's ``QuantWrite``), else through the masked ``KVWrite``."""
    if k_scale is None:
        write.put(store_k, k)
        write.put(store_v, v)
    else:
        write.put(store_k, k_scale, k)
        write.put(store_v, v_scale, v)


def attention_chunk_block(ctx: LayerCtx, p: Params, x, cache_k, cache_v,
                          lengths, write, block_tables=None, *,
                          k_scale=None, v_scale=None, chunk_lens=None):
    """Chunked-prefill step: C prompt tokens append in place (through the
    step's ``write``) to the dense slot cache or, with ``block_tables``,
    to the page pool, and attend causally to prefix + chunk. With
    ``k_scale`` / ``v_scale`` (a quantized pool's (NP, HK) step pools)
    the chunk lands as codes and attention dequantizes in place.
    ``chunk_lens`` (the step's valid tokens per row) keeps the paged
    kernels off the pool rows past each row's last written position.
    x: (B, C, D) -> (B, C, D)."""
    cfg = ctx.cfg
    b, c, _ = x.shape
    positions = lengths[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k, v = attention_qkv(ctx, p, x, positions)
    _append(write, cache_k, cache_v, k, v, k_scale, v_scale)
    if block_tables is None:
        o = ops.attention_chunk(q, cache_k, cache_v, lengths,
                                phi_cfg=ctx.phi_cfg, plan=ctx.plan)
    else:
        o = ops.attention_chunk_paged(q, cache_k, cache_v, block_tables,
                                      lengths, phi_cfg=ctx.phi_cfg,
                                      plan=ctx.plan, k_scale=k_scale,
                                      v_scale=v_scale, chunk_lens=chunk_lens)
    return ctx.matmul(o.reshape(b, c, cfg.q_dim), p["wo"])


def decode_attend_paged(ctx: LayerCtx, q, k, v, pool_k, pool_v,
                        block_tables, lengths, write, *,
                        decode_groups=None, k_scale=None, v_scale=None):
    """Stage B (paged layout): append this token's KV through the block
    tables (``write`` drops empty slots' sentinel entries), attend over
    the page pool, through the shared-prefix grouped path when
    ``decode_groups`` is given. A quantized pool (``k_scale`` /
    ``v_scale``) appends through the quantized scatter and attends
    through the quantized kernels. Returns o (B, 1, HQ*Dh)."""
    _append(write, pool_k, pool_v, k, v, k_scale, v_scale)
    o = ops.attention_decode_paged(q[:, 0], pool_k, pool_v, block_tables,
                                   lengths + 1, phi_cfg=ctx.phi_cfg,
                                   plan=ctx.plan, groups=decode_groups,
                                   k_scale=k_scale, v_scale=v_scale)
    return o.reshape(q.shape[0], 1, ctx.cfg.q_dim)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def mlp_block(ctx: LayerCtx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The FFN; under a mesh with a model-sharded hidden width,
    column-parallel gate / up and row-parallel down with one all-reduce
    over ``model``."""
    cfg = ctx.cfg
    tp = ctx.model_sharded(p["w_down"], 0, cfg.d_ff)
    if tp:
        x = C.copy_to(x, ctx.mesh, _model(ctx))
    if cfg.activation in ("swiglu", "geglu") and ctx.plan.fused_ffn.fused:
        # one kernel for gate + up + activation: the (M, F) gate and up
        # tensors never reach device memory
        h = ops.fused_ffn(x, p["w_gate"], p["w_up"],
                          activation=cfg.activation, plan=ctx.plan)
    elif cfg.activation in ("swiglu", "geglu"):
        g = ctx.matmul(x, p["w_gate"])
        u = ctx.matmul(x, p["w_up"])
        h = ffn_activation(g, cfg.activation) * u
    else:
        h = _gelu(ctx.matmul(x, p["w_up"]))
    return row_parallel(ctx, h, p["w_down"], cfg.d_ff, "act_ffn")


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed(ctx: LayerCtx, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows; a vocabulary-parallel embedding (rows cut over
    ``model``) looks up the tokens of its own rows, zero for the rest,
    and the all-reduce over ``model`` adds them (exactly: one rank holds
    each row)."""
    e = p["embedding"]
    if not ctx.model_sharded(e, 0, vocab_padded(ctx.cfg)):
        return e[tokens].to(adt(ctx.cfg))
    n = e.shape[0]
    local = tokens.long() - ctx.mesh.coord(_model(ctx)) * n
    inside = (local >= 0) & (local < n)
    x = torch.where(inside[..., None], e[local.clamp(0, n - 1)], 0)
    x = C.reduce_from(x, ctx.mesh, _model(ctx)).to(adt(ctx.cfg))
    check_shard(ctx, x, "act_resid", ctx.cfg.d_model)
    return x


def _head(p: Params) -> torch.Tensor:
    """The LM head (D, V), or the tied ``embedding.T`` view."""
    w = p.get("lm_head")
    return p["embedding"].T if w is None else w


def lm_logits(ctx: LayerCtx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The serving logits (..., Vp). Tied heads read ``embedding.T`` as a
    view: the GEMM kernels take the (N, K) row-major layout in place. A
    vocabulary-parallel head's columns are gathered whole (one
    all-gather): the JAX package replicates the logits."""
    head = _head(p)
    y = ctx.matmul(x, head)
    return gather_cut(ctx, [y], [ctx.model_sharded(
        head, -1, vocab_padded(ctx.cfg))])[0]


def cross_entropy_loss(ctx: LayerCtx, p: Params, x: torch.Tensor,
                       labels: torch.Tensor, *,
                       seq_chunks: int = 8) -> torch.Tensor:
    """The mean next-token loss of x (B, S, D) against labels (B, S),
    over ``seq_chunks`` chunks of the sequence so that the (B, S, V) f32
    logits never live at once: under autograd each chunk's loss is
    recomputed in the backward pass (``checkpoint``), so a chunk's logits
    live only while its own loss or gradient is computed. The padded
    vocabulary tail is masked to -1e9 before the logsumexp."""
    b, s, _ = x.shape
    seq_chunks = min(seq_chunks, s)
    if s % seq_chunks:
        raise ValueError(f"sequence {s} is not a multiple of {seq_chunks} "
                         "chunks")
    cs = s // seq_chunks
    nll = functools.partial(_chunk_nll, ctx, p)
    if torch.is_grad_enabled():
        nll = functools.partial(checkpoint, nll, use_reentrant=False)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(seq_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        total = total + nll(x[:, sl], labels[:, sl])
    return total / (b * s)


def _chunk_nll(ctx: LayerCtx, p: Params, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Summed -log p(label) over one chunk, in f32. With a vocabulary-
    parallel head each rank holds its columns of the logits: the max
    (no gradient: the log-sum-exp does not depend on it) meets in a MAX
    all-reduce, the exponent sum and the label's logit in one SUM
    all-reduce."""
    cfg = ctx.cfg
    vp = vocab_padded(cfg)
    n = _head(p).shape[-1]
    tp = ctx.model_sharded(_head(p), -1, vp)
    if tp:
        x = C.copy_to(x, ctx.mesh, _model(ctx))
    logits = ctx.matmul(x, _head(p)).float()     # this rank's columns
    start = ctx.mesh.coord(_model(ctx)) * n if tp else 0
    if vp != cfg.vocab_size:
        cols = start + torch.arange(n, device=logits.device)
        logits = torch.where(cols >= cfg.vocab_size, -1e9, logits)
    if not tp:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return torch.sum(logz - gold)
    check_shard(ctx, logits, "act_logits", vp)
    m = C.max_over(logits.detach().amax(-1), ctx.mesh, _model(ctx))
    se = torch.exp(logits - m[..., None]).sum(-1)
    local = labels.long() - start
    inside = (local >= 0) & (local < n)
    gold = torch.where(inside, logits.gather(
        -1, local.clamp(0, n - 1)[..., None])[..., 0], 0.0)
    se, gold = C.reduce_from(torch.stack([se, gold]), ctx.mesh,
                             _model(ctx)).unbind(0)
    return torch.sum(m + torch.log(se) - gold)
