"""T2 extension — the fused FFN-up ``act(x @ w_gate) * (x @ w_up)``
(kernel: ``csrc/fused_ffn.cu``).

Replaces ``repro/kernels/fused_ffn.py::fused_ffn_up``. On a CUDA tensor the
wrapper launches the kernel, whose epilogue applies the activation to the
unrounded f32 sums of both products and writes only ``h`` (one
rounding); on a CPU tensor it runs :func:`fused_ffn_up_plain`.
``fused_ffn_up.launches`` counts the bf16 launches.

One body for both weight types, the wgmma + TMA kernel
(``csrc/ffn_wgmma.cuh``): blocks of WG_BN output columns and WG_TILES
token tiles of WG_TOKENS rows, K in WG_BK tiles through a WG_STAGES-deep
ring (:func:`wgmma_smem_bytes`), the same instruction sequence for every
row at every M. Its plain version walks the same fixed K tiles, each one
batched product per row (``flat_gemm.split_acc``), so a row's CPU bits do
not depend on its batch either.

``wg_scale`` / ``wu_scale`` ((N,) f32 steps, given together) mark the
weights as the int8 / fp8 codes of quantized weights: the body streams
both at 1 byte, turns them into bf16 exactly in shared memory and
multiplies each f32 sum by its step before the activation (the
quantized branch of ``_fused_ffn_kernel``); :data:`fused_ffn_up_quant`
counts those launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flat_gemm import TILE_BYTES, split_acc
from repro_torch.kernels.gemv import check_codes, vector_ok, weight_layout
from repro_torch.kernels.ref import ffn_activation

ACTIVATIONS = ("swiglu", "geglu")

# the wgmma body (csrc/ffn_wgmma.cuh)
WG_BN = 64          # output columns per block: the wgmma's m64
WG_BK = 64          # K per stage: one 128-byte swizzled row of bf16
WG_TOKENS = 64      # token rows per tile, whatever M: the wgmma's n64
WG_TILES = 4        # token tiles per block, two per consumer warpgroup
WG_STAGES = 4       # TMA ring depth

_SIG = {"fused_ffn_up_bf16": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64, _build.I32, _build.VP],
        "fused_ffn_up_q8": [_build.VP] * 6 + [_build.I32] * 3
        + [_build.I64] + [_build.I32] * 2 + [_build.VP]}

fused_ffn_up_quant = _build.LaunchCounter("fused_ffn_up_quant")


def wgmma_smem_bytes(w_bytes: int = 2) -> int:
    """Shared memory of a launch: WG_STAGES ring stages of the two
    (WG_BK x WG_BN) weight tiles of ``w_bytes``-byte elements and WG_TILES
    (WG_TOKENS x WG_BK) bf16 x tiles, for codes two buffers of both
    streams' converted bf16 tiles, two mbarriers a stage, and 1024 bytes
    to align the ring to the 128-byte swizzle's period."""
    stage = 2 * WG_BK * WG_BN * w_bytes + 2 * WG_TILES * WG_TOKENS * WG_BK
    conv = 2 * 2 * TILE_BYTES if w_bytes == 1 else 0
    return WG_STAGES * stage + conv + 2 * WG_STAGES * 8 + 1024


def scale_pair(what: str, wg_scale, wu_scale) -> bool:
    """True when the gate / up weights are quantized; they quantize
    together."""
    if (wg_scale is None) != (wu_scale is None):
        raise ValueError(f"{what}: the gate and up weights quantize "
                         "together (both steps or neither)")
    return wg_scale is not None


def fused_ffn_up_plain(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, *, activation: str = "swiglu",
                       wg_scale: torch.Tensor | None = None,
                       wu_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the body's fixed WG_BK tiles accumulated in f32,
    each one batched product per row (``split_acc``; codes cast to f32,
    exactly), the steps (codes) and the activation on the f32 sums, one
    rounding to x's dtype."""
    scale_pair("fused_ffn_up", wg_scale, wu_scale)
    g = split_acc(x, w_gate, WG_BK, 1, wg_scale)
    u = split_acc(x, w_up, WG_BK, 1, wu_scale)
    return (ffn_activation(g, activation) * u).to(x.dtype)


@_build.forward_only
def fused_ffn_up(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 *, activation: str = "swiglu",
                 wg_scale: torch.Tensor | None = None,
                 wu_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K), w_gate / w_up (K, N) -> act(x @ w_gate) * (x @ w_up),
    (M, N) in x's dtype; with the steps the weights hold codes."""
    m, k = x.shape
    if w_gate.shape != w_up.shape or w_gate.shape[0] != k:
        raise ValueError(f"fused_ffn_up: x {tuple(x.shape)} w_gate "
                         f"{tuple(w_gate.shape)} w_up {tuple(w_up.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_ffn_up: activation must be one of "
                         f"{ACTIVATIONS}, got {activation!r}")
    quantized = scale_pair("fused_ffn_up", wg_scale, wu_scale)
    if not x.is_cuda:
        return fused_ffn_up_plain(x, w_gate, w_up, activation=activation,
                                  wg_scale=wg_scale, wu_scale=wu_scale)
    n = w_gate.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_ffn_up kernel takes bf16 x, got {x.dtype}")
    for t in (w_gate, w_up):
        if t.device != x.device:
            raise ValueError("fused_ffn_up: inputs on different devices")
    if quantized:
        fp8 = check_codes("fused_ffn_up", w_gate, wg_scale)
        if check_codes("fused_ffn_up", w_up, wu_scale) != fp8:
            raise TypeError("fused_ffn_up: gate and up codes differ in "
                            "dtype")
    elif w_gate.dtype != torch.bfloat16 or w_up.dtype != torch.bfloat16:
        raise TypeError(f"fused_ffn_up kernel takes bf16 weights (or codes "
                        f"with steps), got {w_gate.dtype}/{w_up.dtype}")
    if x.stride(1) != 1:
        x = x.contiguous()
    for w in (w_gate, w_up):
        kn, ldw = weight_layout(w)
        if not kn or ldw != n or not vector_ok(x, w, kn, ldw):
            raise ValueError(
                "fused_ffn_up kernel needs contiguous (K, N) weights with K "
                "a multiple of 8, N a multiple of 8 (16 for codes) and "
                "16-byte aligned rows")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("fused_ffn", _SIG)
    if quantized:
        code = lib.fused_ffn_up_q8(
            _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
            _build.ptr(wg_scale), _build.ptr(wu_scale), _build.ptr(out),
            m, k, n, x.stride(0), int(activation == "geglu"), fp8,
            _build.stream_of(x))
        _build.check(lib, "fused_ffn_up_q8", code)
        fused_ffn_up_quant.launches += 1
        return out
    code = lib.fused_ffn_up_bf16(
        _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(out),
        m, k, n, x.stride(0), int(activation == "geglu"),
        _build.stream_of(x))
    _build.check(lib, "fused_ffn_up_bf16", code)
    fused_ffn_up.launches += 1
    return out


fused_ffn_up.launches = 0
