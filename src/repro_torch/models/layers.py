"""Shared building blocks for the dense model family.

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

A GEMM weight leaf (``wq`` … ``w_down``) is a tensor or, under a quantized
``weight_dtype``, the ``{"codes", "scale"}`` dict of ``models/wquant.py``.
Nothing here reads a weight's shape, dtype or transpose: every GEMM goes
through an ``ops`` front door, which takes either form, and the looped
graph reads the codes and steps in place like any other param.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SoftmaxPhiConfig
from repro_torch.core.plan import DEFAULT_PLAN, ExecutionPlan
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
    graphs: Optional[LoopedDecode] = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.plan.decode_fusion.granularity == "looped":
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


# ---------------------------------------------------------------------------
# Norms, activations (rmsnorm and rope are ref.rmsnorm_ref / ref.rope_ref)
# ---------------------------------------------------------------------------


def norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, p["scale"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# Initializers (stacked over L layers; same distributions as the JAX
# package's layers.dense_init: normal * fan_in^-1/2, zero biases, unit norms)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device,
               fan_in: int) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * fan_in ** -0.5).to(dtype)


def norm_params(cfg: ModelConfig, lead: tuple, device) -> Params:
    return {"scale": torch.ones((*lead, cfg.d_model), dtype=pdt(cfg),
                                device=device)}


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
                  positions: torch.Tensor):
    """x: (B, S, D) -> q (B,S,HQ,Dh), k/v (B,S,HK,Dh), rope applied."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    q = ctx.matmul(x, p["wq"])
    k = ctx.matmul(x, p["wk"])
    v = ctx.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def decode_ingest(ctx: LayerCtx, norm_p: Params, p: Params, x: torch.Tensor,
                  position: torch.Tensor):
    """Stage A: norm → QKV → bias → rope. x: (B, 1, D); position (B,).
    Returns q (B, 1, HQ, Dh), k / v (B, 1, HK, Dh). The fused seam
    claims rmsnorm models only; others keep the split composition."""
    cfg = ctx.cfg
    if ctx.fused and cfg.norm == "rmsnorm":
        return ops.decode_ingest(
            x, norm_p["scale"], p["wq"], p["wk"], p["wv"], position,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            bq=p.get("bq"), bk=p.get("bk"), bv=p.get("bv"), plan=ctx.plan)
    h = norm(cfg, norm_p, x)
    return attention_qkv(ctx, p, h, position[:, None])


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


def decode_attend(ctx: LayerCtx, q, k, v, cache_k, cache_v, lengths):
    """Stage B (dense layout): append this token's KV at each row's
    length, attend over the cache. Returns o (B, 1, HQ*Dh)."""
    _scatter_kv(cache_k, k[:, 0], lengths)
    _scatter_kv(cache_v, v[:, 0], lengths)
    o = ops.attention_decode(q[:, 0], cache_k, cache_v, lengths + 1,
                             phi_cfg=ctx.phi_cfg, plan=ctx.plan)
    return o.reshape(q.shape[0], 1, ctx.cfg.q_dim)


def decode_epilogue(ctx: LayerCtx, p: Params, o, resid):
    """Stage C: ``resid + o @ wo``, one fused launch when claimed."""
    if ctx.fused:
        return ops.oproj_residual(o, p["wo"], resid, plan=ctx.plan)
    return resid + ctx.matmul(o, p["wo"])


def decode_mlp(ctx: LayerCtx, norm_p: Params, p: Params, x):
    """Stage D: norm → gate/up → act → down → residual. When claimed, two
    fused launches: ``ops.ffn_norm`` (the norm inside the gate/up pair)
    and ``ops.oproj_residual`` reused for ``x + h @ w_down``. The seam
    claims rmsnorm models with a gated (swiglu / geglu) FFN only; others
    keep the split composition."""
    cfg = ctx.cfg
    if (ctx.fused and cfg.norm == "rmsnorm"
            and cfg.activation in ("swiglu", "geglu")):
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
    cfg = ctx.cfg
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
    return ctx.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed(ctx: LayerCtx, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens].to(adt(ctx.cfg))


def lm_logits(ctx: LayerCtx, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied heads read ``embedding.T`` as a view: the GEMM kernels take
    the (N, K) row-major layout in place."""
    w = p.get("lm_head")
    if w is None:
        w = p["embedding"].T
    return ctx.matmul(x, w)
