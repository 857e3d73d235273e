"""Fused decode-layer stages — the three seams of ``DecodeFusionPlan``
(kernels: ``csrc/decode_fuse.cu``).

Replaces ``repro/kernels/decode_fuse.py``:

  * :func:`decode_ingest_fused` (``decode_ingest_fused``) — rmsnorm → x ·
    [Wq Wk Wv] → bias → rope in one launch. One block per head of the q,
    k and v streams and per K split (:func:`ingest_tiles`); each block
    normalises its rows over its K range into shared memory itself, and
    the splits of a head fold their f32 partials in split order before
    the epilogue.
  * :func:`oproj_residual_fused` (``oproj_residual_fused``) — ``resid +
    o @ wo``: flat_gemm's bodies with the residual add in their epilogue
    (the split body at narrow N, the ``wgmma`` one otherwise, as
    ``flat_gemm.gemm_tiles`` picks); it serves the o_proj and the FFN
    down projection.
  * :func:`ffn_norm_fused` (``ffn_norm_fused``) — rmsnorm → x · Wg, x · Wu
    → act(g) · u on the f32 accumulators: the ``wgmma`` / TMA body
    (``csrc/ffn_norm_wgmma.cuh``) for bf16 weights and codes alike, with
    the rmsnorm applied as x is staged and K split over a cluster
    (:func:`ffn_norm_splits`).

On a CUDA tensor each wrapper launches its kernel and counts the launch
in ``.launches``; on a CPU tensor it runs its plain version, which walks
the kernel's K splits and tiles with ``flat_gemm.split_acc`` (f32 sums,
each row its own product, the splits' sums in split order) and rounds
where the kernel rounds. The kernels round where the split chain rounds
(normed x to the activation dtype, each GEMM output, the bias add, rope
once), so they agree with the ``"torch"`` oracles in ``ref.py`` to bf16
rounding. Every split count is a function of K, N (or the head count)
and the card, never of M, so a row's bits are the same alone and in any
batch.

The ingest kernel (mma.sync) holds ``mt`` token rows per block: the
smallest multiple of 8 covering M, at most 64, halved until the rows and
the weight stages fit a block's shared memory; M is tiled over the
grid's second axis, as it is in 64-row tiles for the wgmma body.

Quantized weights (``{"codes", "scale"}`` leaves, ``models/wquant.py``)
reach each wrapper as int8 / fp8 codes with (N,) f32 steps
(``wq_scale`` …, ``w_scale``, ``wg_scale`` / ``wu_scale``): the same
kernels, instantiated for 1-byte codes, stream them at their width and
apply the steps on the f32 accumulators where the JAX package's quantized
bodies do (before the rounding, the bias and rope; before the rounding
and the residual add; before the activation). Their launches count in
the ``*_quant`` counters, apart from the bf16 kernels'.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import hardware
from repro_torch.kernels import _build
from repro_torch.kernels.flat_gemm import (BLOCK_M, SPLIT_ROWS, TILE_BYTES,
                                           blocks_per_sm, cluster_splits,
                                           gemm_tiles, round_up, split_acc,
                                           split_tiles)
from repro_torch.kernels.fused_ffn import ACTIVATIONS, scale_pair
from repro_torch.kernels.gemv import check_codes, vector_ok, weight_layout
from repro_torch.kernels.ref import ffn_activation, rmsnorm_ref, rope_ref

HEAD_TILES = (32, 64, 128)     # head_dim the ingest kernel takes
MAX_SPLITS = 8                 # K splits: a portable cluster at most
INGEST_STAGES = 4              # the ingest kernel's cp.async ring
INGEST_PER_SM = 2              # ingest blocks a SM its splits count on
# the bf16 wgmma ffn_norm body (csrc/ffn_norm_wgmma.cuh)
FN_BN = 64                     # output columns per block: the wgmma's m64
FN_TOKENS = 64                 # token rows per block, whatever M (n64)
FN_STAGES = 4                  # TMA ring depth at most
FN_THREADS = 160               # a consumer warpgroup and a producer warp
FN_MAX_BLOCKS = 4              # blocks a SM its register cap allows

# one library, loaded once with every entry's argument types
_SIG = {"decode_ingest_bf16": [_build.VP] * 12 + [_build.I32] * 4
        + [_build.I64] + [_build.I32] * 4 + [_build.F32, _build.F32,
                                             _build.VP],
        "oproj_residual_bf16": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64] * 2 + [_build.I32] * 3 + [_build.VP],
        "ffn_norm_bf16": [_build.VP] * 5 + [_build.I32] * 3 + [_build.I64]
        + [_build.I32] * 2 + [_build.F32, _build.VP],
        "decode_ingest_q8": [_build.VP] * 15 + [_build.I32] * 4
        + [_build.I64] + [_build.I32] * 4 + [_build.F32, _build.F32,
                                             _build.I32, _build.VP],
        "oproj_residual_q8": [_build.VP] * 5 + [_build.I32] * 3
        + [_build.I64] * 2 + [_build.I32] * 4 + [_build.VP],
        "ffn_norm_q8": [_build.VP] * 7 + [_build.I32] * 3 + [_build.I64]
        + [_build.I32] * 2 + [_build.F32, _build.I32, _build.VP]}

decode_ingest_fused_quant = _build.LaunchCounter("decode_ingest_fused_quant")
oproj_residual_fused_quant = _build.LaunchCounter(
    "oproj_residual_fused_quant")
ffn_norm_fused_quant = _build.LaunchCounter("ffn_norm_fused_quant")


def ingest_smem(mt: int, span: int, head_dim: int, w_bytes: int = 2) -> int:
    """Shared memory of an ingest launch: INGEST_STAGES (SPLIT_ROWS,
    head_dim) weight tiles of ``w_bytes``-byte elements, rows padded by
    16 bytes, and ``mt`` bf16 normed rows of a split's ``span`` columns
    (pitch span + 8). The f32 partials reuse the ring."""
    return (INGEST_STAGES * SPLIT_ROWS * (head_dim * w_bytes + 16)
            + 2 * mt * (span + 8))


@functools.lru_cache(maxsize=None)
def ingest_splits(k: int, heads: int, *,
                  spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of an ingest launch over ``heads`` head blocks (the q, k
    and v heads together): the most, at most MAX_SPLITS (a portable
    cluster) and one per SPLIT_ROWS chunk, none empty, whose clusters all
    run at once with INGEST_PER_SM blocks a SM
    (``flat_gemm.cluster_splits``: one wave); 1 where none do. K, the
    head count and the card only: qwen2-0.5b (K = 896, 18 heads) 7,
    llama2-7b (K = 4,096, 96 heads) 2."""
    best, _ = cluster_splits(k, heads, lambda per: INGEST_PER_SM, spec=spec)
    return best or 1


def ingest_tiles(m: int, k: int, head_dim: int, heads: int, *,
                 w_bytes: int = 2,
                 spec: hardware.HardwareSpec = hardware.DEFAULT
                 ) -> tuple[int, int]:
    """(mt, splits) of an ingest launch: :func:`ingest_splits`, then
    ``mt`` token rows a block from min(64, round_up(M, 8)), halved until
    the rows of one split's range fit beside the ring."""
    splits = ingest_splits(k, heads, spec=spec)
    span = split_tiles(k, splits) * SPLIT_ROWS
    mt = min(BLOCK_M, round_up(max(m, 1), 8))
    while ingest_smem(mt, span, head_dim, w_bytes) > spec.smem_per_block:
        if mt == 8:
            raise ValueError(f"K={k}: a split's rows do not fit a block's "
                             "shared memory beside the weight ring")
        mt //= 2
    return mt, splits


def wgmma_norm_smem(x_tiles: int, w_bytes: int = 2) -> int:
    """Shared memory of an ffn_norm launch whose splits hold ``x_tiles``
    K tiles: a ring of min(FN_STAGES, x_tiles) stages (at least two) of
    two (SPLIT_ROWS x FN_BN) weight tiles of ``w_bytes``-byte elements,
    the normed rows' (FN_TOKENS x SPLIT_ROWS) tiles, for codes two
    buffers of both streams' converted bf16 tiles, two mbarriers a stage,
    and 1024 bytes to align the ring to the 128-byte swizzle's period.
    The f32 partials reuse the ring."""
    stages = min(FN_STAGES, max(2, x_tiles))
    conv = 2 * 2 * TILE_BYTES if w_bytes == 1 else 0
    return (stages * 2 * SPLIT_ROWS * FN_BN * w_bytes
            + x_tiles * 2 * FN_TOKENS * SPLIT_ROWS + conv
            + 2 * FN_STAGES * 8 + 1024)


def wgmma_norm_blocks_per_sm(x_tiles: int, w_bytes: int = 2, *,
                             spec: hardware.HardwareSpec = hardware.DEFAULT
                             ) -> int:
    """Blocks of an ffn_norm launch one SM holds: as many as its shared
    memory takes (each block also holding the reserved share), at most
    FN_MAX_BLOCKS (the kernel's register cap); 0 where one block's
    shared memory does not fit."""
    return blocks_per_sm(wgmma_norm_smem(x_tiles, w_bytes), FN_MAX_BLOCKS,
                         spec=spec)


@functools.lru_cache(maxsize=None)
def ffn_norm_splits(k: int, n: int, w_bytes: int = 2, *,
                    spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of an ffn_norm launch over ceil(N / FN_BN) column tiles:
    the most (at most MAX_SPLITS, none empty) whose clusters all run at
    once at the occupancy their shared memory allows
    (``flat_gemm.cluster_splits``); where none do, the fewest whose
    normed rows fit a block. K, N, the weight width and the card only.
    qwen2-0.5b (896 -> 4,864): 76 tiles x 3 splits of 5 K tiles, 2 blocks
    a SM, bf16 and codes; llama2-7b (4,096 -> 11,008): 172 tiles, whose
    rows fit from 4 splits of 16 tiles."""
    best, fit = cluster_splits(
        k, -(-n // FN_BN),
        lambda per: wgmma_norm_blocks_per_sm(per, w_bytes, spec=spec),
        spec=spec)
    if fit is None:
        raise ValueError(f"K={k}: no split of at most {MAX_SPLITS} fits its "
                         "normed rows beside the ring in a block")
    return best or fit


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _qkv_scales(wq_scale, wk_scale, wv_scale) -> tuple:
    scales = (wq_scale, wk_scale, wv_scale)
    if len({s is None for s in scales}) != 1:
        raise ValueError("decode_ingest: the q, k and v weights quantize "
                         "together (all three steps or none)")
    return scales


def decode_ingest_plain(x, norm_scale, wq, wk, wv, positions, *,
                        num_heads: int, num_kv_heads: int, head_dim: int,
                        rope_theta: float = 1e4, eps: float = 1e-6,
                        use_rope: bool = True, bq=None, bk=None, bv=None,
                        wq_scale=None, wk_scale=None, wv_scale=None):
    """Plain version: normed rows rounded to x's dtype, each stream's
    splits of SPLIT_ROWS tiles in f32 (``split_acc``: the kernel's
    :func:`ingest_splits`, summed in split order), times its step if
    quantized, and rounded, the bias added (rounded), rope on q and k in
    f32 (one rounding)."""
    m, d = x.shape
    splits = ingest_splits(d, num_heads + 2 * num_kv_heads)
    xn = rmsnorm_ref(x, norm_scale, eps)
    scales = _qkv_scales(wq_scale, wk_scale, wv_scale)
    outs = []
    for w, sc, b, heads, rot in ((wq, scales[0], bq, num_heads, use_rope),
                                 (wk, scales[1], bk, num_kv_heads, use_rope),
                                 (wv, scales[2], bv, num_kv_heads, False)):
        t = split_acc(xn, w, SPLIT_ROWS, splits, sc).to(x.dtype)
        if b is not None:
            t = t + b
        if rot:
            t = rope_ref(t.reshape(m, heads, head_dim), positions,
                         rope_theta).reshape(m, heads * head_dim)
        outs.append(t)
    return tuple(outs)


def oproj_residual_plain(o, wo, resid, *, w_scale=None):
    """Plain version: the kernel's splits of K tiles in f32, summed in
    split order, times the step if quantized, rounded to o's dtype, added
    to the residual (one rounding)."""
    _, bk, splits = gemm_tiles(o.shape[1], wo.shape[1],
                               w_bytes=wo.element_size())
    return resid + split_acc(o, wo, bk, splits, w_scale).to(o.dtype)


def ffn_norm_plain(x, norm_scale, w_gate, w_up, *,
                   activation: str = "swiglu", eps: float = 1e-6,
                   wg_scale=None, wu_scale=None):
    """Plain version: normed rows rounded to x's dtype, both streams in
    f32 through ``split_acc`` (the body's :func:`ffn_norm_splits` of
    SPLIT_ROWS tiles, summed in split order, times their steps for
    codes), the activation on the f32 sums, one rounding."""
    scale_pair("ffn_norm", wg_scale, wu_scale)
    k, n = w_gate.shape
    splits = ffn_norm_splits(k, n, w_gate.element_size())
    xn = rmsnorm_ref(x, norm_scale, eps)
    g = split_acc(xn, w_gate, SPLIT_ROWS, splits, wg_scale)
    u = split_acc(xn, w_up, SPLIT_ROWS, splits, wu_scale)
    return (ffn_activation(g, activation) * u).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_bf16(what: str, dev, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bf16, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: inputs on different devices")


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(1) == 1 else x.contiguous()


def _check_weights(what: str, x: torch.Tensor, weights, scales) -> int:
    """Validate a launch's weights: all bf16 with no steps, or all codes
    of one dtype with their (N,) f32 steps, each contiguous (K, N) with
    aligned rows. Returns the C entries' ``fp8`` flag (-1 for bf16)."""
    flags = set()
    for w, sc in zip(weights, scales):
        if w.device != x.device:
            raise ValueError(f"{what}: inputs on different devices")
        if sc is None:
            if w.dtype != torch.bfloat16:
                raise TypeError(f"{what} kernel takes bf16 weights (or "
                                f"codes with steps), got {w.dtype}")
            flags.add(-1)
        else:
            flags.add(check_codes(what, w, sc))
        kn, ldw = weight_layout(w)
        if not kn or ldw != w.shape[1] or not vector_ok(x, w, kn, ldw):
            raise ValueError(
                f"{what} kernel needs contiguous (K, N) weights with K a "
                "multiple of 8, N a multiple of 8 (16 for codes) and "
                "16-byte aligned rows")
    if len(flags) != 1:
        raise TypeError(f"{what}: the weights of one launch share one dtype")
    return flags.pop()


def _check_scale(what: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    if scale.shape != (x.shape[1],) or scale.stride(0) != 1 \
            or scale.data_ptr() % 16:
        raise ValueError(f"{what}: norm scale must be a contiguous, 16-byte "
                         f"aligned ({x.shape[1]},) vector")


@_build.forward_only
def decode_ingest_fused(x, norm_scale, wq, wk, wv, positions, *,
                        num_heads: int, num_kv_heads: int, head_dim: int,
                        rope_theta: float = 1e4, eps: float = 1e-6,
                        use_rope: bool = True, bq=None, bk=None, bv=None,
                        wq_scale=None, wk_scale=None, wv_scale=None):
    """x (M, D), norm_scale (D,), wq (D, HQ·Dh), wk / wv (D, HK·Dh),
    positions (M,) -> q (M, HQ·Dh), k / v (M, HK·Dh) in x's dtype (the
    caller owns the head reshape). Absent biases read as zero; with the
    steps ``w*_scale`` the weights hold codes."""
    m, d = x.shape
    nq, nk = wq.shape[1], wk.shape[1]
    if (nq != num_heads * head_dim or nk != num_kv_heads * head_dim
            or wq.shape[0] != d or wk.shape != (d, nk) or wv.shape != (d, nk)
            or positions.shape != (m,)):
        raise ValueError(
            f"decode_ingest: x {tuple(x.shape)} wq {tuple(wq.shape)} wk "
            f"{tuple(wk.shape)} wv {tuple(wv.shape)} positions "
            f"{tuple(positions.shape)} for {num_heads}/{num_kv_heads} heads "
            f"of {head_dim}")
    if (bq is None) != (bk is None) or (bq is None) != (bv is None):
        raise ValueError("decode_ingest: the q, k and v biases come "
                         "together")
    scales = _qkv_scales(wq_scale, wk_scale, wv_scale)
    if not x.is_cuda:
        return decode_ingest_plain(
            x, norm_scale, wq, wk, wv, positions, num_heads=num_heads,
            num_kv_heads=num_kv_heads, head_dim=head_dim,
            rope_theta=rope_theta, eps=eps, use_rope=use_rope, bq=bq, bk=bk,
            bv=bv, wq_scale=wq_scale, wk_scale=wk_scale, wv_scale=wv_scale)
    if head_dim not in HEAD_TILES:
        raise ValueError(f"decode_ingest kernel takes head_dim in "
                         f"{HEAD_TILES}, got {head_dim}")
    _check_bf16("decode_ingest", x.device, x, norm_scale, bq, bk, bv)
    x = _rows(x)
    fp8 = _check_weights("decode_ingest", x, (wq, wk, wv), scales)
    _check_scale("decode_ingest", x, norm_scale)
    biases = [b if b is None else b.contiguous() for b in (bq, bk, bv)]
    pos = positions.to(device=x.device, dtype=torch.int32).contiguous()
    mt, splits = ingest_tiles(m, d, head_dim, num_heads + 2 * num_kv_heads,
                              w_bytes=wq.element_size())
    q = torch.empty((m, nq), dtype=x.dtype, device=x.device)
    k = torch.empty((m, nk), dtype=x.dtype, device=x.device)
    v = torch.empty((m, nk), dtype=x.dtype, device=x.device)
    lib = _build.load("decode_fuse", _SIG)
    weights = (_build.ptr(wq), _build.ptr(wk), _build.ptr(wv))
    tail = (*(_build.VP(None) if b is None else _build.ptr(b)
              for b in biases),
            _build.ptr(pos), _build.ptr(q), _build.ptr(k), _build.ptr(v),
            m, d, nq, nk, x.stride(0), head_dim, mt, splits, int(use_rope),
            rope_theta, eps)
    if fp8 >= 0:
        code = lib.decode_ingest_q8(
            _build.ptr(x), _build.ptr(norm_scale), *weights,
            *(_build.ptr(sc) for sc in scales), *tail, fp8,
            _build.stream_of(x))
        _build.check(lib, "decode_ingest_q8", code)
        decode_ingest_fused_quant.launches += 1
        return q, k, v
    code = lib.decode_ingest_bf16(
        _build.ptr(x), _build.ptr(norm_scale), *weights, *tail,
        _build.stream_of(x))
    _build.check(lib, "decode_ingest_bf16", code)
    decode_ingest_fused.launches += 1
    return q, k, v


@_build.forward_only
def oproj_residual_fused(o, wo, resid, *, w_scale=None):
    """o (M, Q), wo (Q, D), resid (M, D) -> resid + o @ wo, (M, D) in
    resid's dtype; with the step ``w_scale`` ``wo`` holds codes."""
    m, k = o.shape
    n = wo.shape[1]
    if wo.shape[0] != k or resid.shape != (m, n):
        raise ValueError(f"oproj_residual: o {tuple(o.shape)} wo "
                         f"{tuple(wo.shape)} resid {tuple(resid.shape)}")
    if not o.is_cuda:
        return oproj_residual_plain(o, wo, resid, w_scale=w_scale)
    _check_bf16("oproj_residual", o.device, o, resid)
    o, resid = _rows(o), _rows(resid)
    fp8 = _check_weights("oproj_residual", o, (wo,), (w_scale,))
    body, bk, splits = gemm_tiles(k, n, w_bytes=wo.element_size())
    split = int(body == "split")
    out = torch.empty((m, n), dtype=resid.dtype, device=o.device)
    lib = _build.load("decode_fuse", _SIG)
    if fp8 >= 0:
        code = lib.oproj_residual_q8(
            _build.ptr(o), _build.ptr(wo), _build.ptr(w_scale),
            _build.ptr(resid), _build.ptr(out), m, k, n, o.stride(0),
            resid.stride(0), split, bk, splits, fp8, _build.stream_of(o))
        _build.check(lib, "oproj_residual_q8", code)
        oproj_residual_fused_quant.launches += 1
        return out
    code = lib.oproj_residual_bf16(
        _build.ptr(o), _build.ptr(wo), _build.ptr(resid), _build.ptr(out),
        m, k, n, o.stride(0), resid.stride(0), split, bk, splits,
        _build.stream_of(o))
    _build.check(lib, "oproj_residual_bf16", code)
    oproj_residual_fused.launches += 1
    return out


@_build.forward_only
def ffn_norm_fused(x, norm_scale, w_gate, w_up, *,
                   activation: str = "swiglu", eps: float = 1e-6,
                   wg_scale=None, wu_scale=None):
    """x (M, D), norm_scale (D,), w_gate / w_up (D, F) -> act(xn @ w_gate)
    * (xn @ w_up), (M, F) in x's dtype, xn = rmsnorm(x); with the steps
    the weights hold codes."""
    m, d = x.shape
    if w_gate.shape != w_up.shape or w_gate.shape[0] != d:
        raise ValueError(f"ffn_norm: x {tuple(x.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"ffn_norm: activation must be one of "
                         f"{ACTIVATIONS}, got {activation!r}")
    scale_pair("ffn_norm", wg_scale, wu_scale)
    if not x.is_cuda:
        return ffn_norm_plain(x, norm_scale, w_gate, w_up,
                              activation=activation, eps=eps,
                              wg_scale=wg_scale, wu_scale=wu_scale)
    _check_bf16("ffn_norm", x.device, x, norm_scale)
    x = _rows(x)
    fp8 = _check_weights("ffn_norm", x, (w_gate, w_up), (wg_scale, wu_scale))
    _check_scale("ffn_norm", x, norm_scale)
    n = w_gate.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("decode_fuse", _SIG)
    gelu = int(activation == "geglu")
    splits = ffn_norm_splits(d, n, w_gate.element_size())
    if fp8 >= 0:
        code = lib.ffn_norm_q8(
            _build.ptr(x), _build.ptr(norm_scale), _build.ptr(w_gate),
            _build.ptr(w_up), _build.ptr(wg_scale), _build.ptr(wu_scale),
            _build.ptr(out), m, d, n, x.stride(0), gelu, splits, eps, fp8,
            _build.stream_of(x))
        _build.check(lib, "ffn_norm_q8", code)
        ffn_norm_fused_quant.launches += 1
        return out
    code = lib.ffn_norm_bf16(
        _build.ptr(x), _build.ptr(norm_scale), _build.ptr(w_gate),
        _build.ptr(w_up), _build.ptr(out), m, d, n, x.stride(0), gelu,
        splits, eps, _build.stream_of(x))
    _build.check(lib, "ffn_norm_bf16", code)
    ffn_norm_fused.launches += 1
    return out


decode_ingest_fused.launches = 0
oproj_residual_fused.launches = 0
ffn_norm_fused.launches = 0
