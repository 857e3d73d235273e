"""Shared building blocks for the dense model family.

Plain functions over params dicts of tensors (layer params stacked on a
leading L axis by the model constructors). Every GEMM goes through
:func:`repro_torch.kernels.ops.matmul` and every attention through the
``ops`` front doors, so the plan decides which kernel runs.

The decode layer keeps the JAX package's four stage boundaries (ingest →
attend → epilogue → mlp); only the ``"split"`` granularity — one op per
stage — is ported, the fused and looped ones come with the decode-fusion
slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SoftmaxPhiConfig
from repro_torch.core.plan import DEFAULT_PLAN, ExecutionPlan
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rmsnorm_ref as rmsnorm
from repro_torch.kernels.ref import rope_ref as rope

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
    """Per-call context threaded through every layer."""

    cfg: ModelConfig
    plan: ExecutionPlan = DEFAULT_PLAN

    def __post_init__(self):
        if self.plan.decode_fusion.granularity != "split":
            raise NotImplementedError(
                "decode_fusion granularity "
                f"{self.plan.decode_fusion.granularity!r} comes with the "
                "decode-fusion slice of the port; use 'split'")
        if self.plan.fused_ffn.fused:
            raise NotImplementedError(
                "the fused FFN kernel comes with a later slice of the "
                "port; use fused_ffn.fused=False")

    @property
    def phi_cfg(self) -> SoftmaxPhiConfig:
        if not self.cfg.has_softmax_attention:
            return SoftmaxPhiConfig(enabled=False)
        return self.cfg.softmax_phi

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
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
    """Stage A: norm → QKV → bias → rope. x: (B, 1, D); position (B,)."""
    h = norm(ctx.cfg, norm_p, x)
    return attention_qkv(ctx, p, h, position[:, None])


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """cache (B, S, H, D) <- new (B, H, D) at each row's length, in place
    (the JAX package donates its buffers instead)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache.index_put_((rows, lengths.long()), new.to(cache.dtype))


def _scatter_kv_chunk(cache: torch.Tensor, new: torch.Tensor,
                      lengths: torch.Tensor,
                      chunk_lens: torch.Tensor) -> None:
    """cache (B, S, H, D) <- new (B, C, H, D): row b writes its first
    ``chunk_lens[b]`` entries at ``lengths[b] + i``, in place; the rest
    (padding, spectator rows) are dropped."""
    b, c = new.shape[:2]
    ar = torch.arange(c, device=cache.device)
    keep = ar[None, :] < chunk_lens[:, None]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, c)
    pos = lengths[:, None].long() + ar[None, :]
    cache.index_put_((rows[keep], pos[keep]), new[keep].to(cache.dtype))


def decode_attend(ctx: LayerCtx, q, k, v, cache_k, cache_v, lengths):
    """Stage B (dense layout): append this token's KV at each row's
    length, attend over the cache. Returns o (B, 1, HQ*Dh)."""
    _scatter_kv(cache_k, k[:, 0], lengths)
    _scatter_kv(cache_v, v[:, 0], lengths)
    o = ops.attention_decode(q[:, 0], cache_k, cache_v, lengths + 1,
                             phi_cfg=ctx.phi_cfg, plan=ctx.plan)
    return o.reshape(q.shape[0], 1, ctx.cfg.q_dim)


def decode_epilogue(ctx: LayerCtx, p: Params, o, resid):
    """Stage C: ``resid + o @ wo``."""
    return resid + ctx.matmul(o, p["wo"])


def decode_mlp(ctx: LayerCtx, norm_p: Params, p: Params, x):
    """Stage D: norm → gate/up → act → down → residual."""
    h = norm(ctx.cfg, norm_p, x)
    return x + mlp_block(ctx, p, h)


def attention_chunk_block(ctx: LayerCtx, p: Params, x, cache_k, cache_v,
                          lengths, chunk_lens):
    """Chunked-prefill step: C prompt tokens append to the dense slot
    cache (in place) and attend causally to prefix + chunk.
    x: (B, C, D) -> (B, C, D)."""
    cfg = ctx.cfg
    b, c, _ = x.shape
    positions = lengths[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k, v = attention_qkv(ctx, p, x, positions)
    _scatter_kv_chunk(cache_k, k, lengths, chunk_lens)
    _scatter_kv_chunk(cache_v, v, lengths, chunk_lens)
    o = ops.attention_chunk(q, cache_k, cache_v, lengths,
                            phi_cfg=ctx.phi_cfg, plan=ctx.plan)
    return ctx.matmul(o.reshape(b, c, cfg.q_dim), p["wo"])


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def mlp_block(ctx: LayerCtx, p: Params, x: torch.Tensor) -> torch.Tensor:
    cfg = ctx.cfg
    if cfg.activation in ("swiglu", "geglu"):
        g = ctx.matmul(x, p["w_gate"])
        u = ctx.matmul(x, p["w_up"])
        act = F.silu(g) if cfg.activation == "swiglu" else _gelu(g)
        h = act * u
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
