"""T2 extension — the fused FFN-up ``act(x @ w_gate) * (x @ w_up)``
(kernel: ``csrc/fused_ffn.cu``).

Replaces ``repro/kernels/fused_ffn.py::fused_ffn_up``. On a CUDA tensor the
wrapper launches the kernel: flat_gemm's mma.sync design with two weight
streams sharing one staged x tile, two f32 accumulators, and an epilogue
that applies the activation to the unrounded accumulators and writes only
``h`` (one rounding). M is padded to 8 inside the kernel and tiled in
64-row blocks, so the same kernel serves one decode row, a 256-row chunk
step and a one-shot prefill's B*S rows. On a CPU tensor it runs
:func:`fused_ffn_up_plain`, which walks the kernel's K tiles with f32
accumulation. ``fused_ffn_up.launches`` counts the bf16 kernel's
launches.

``wg_scale`` / ``wu_scale`` ((N,) f32 steps, given together) mark the
weights as the int8 / fp8 codes of quantized weights: the kernel streams
both at 1 byte and multiplies each f32 accumulator by its step before the
activation (the quantized branch of ``_fused_ffn_kernel``);
:data:`fused_ffn_up_quant` counts its launches.

The tiles come from :func:`~repro_torch.kernels.flat_gemm.pick_bn` /
``pick_bk`` with the shared-memory budget counted for two weight streams
of the launched element width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flat_gemm import pick_bk, pick_bn, round_up
from repro_torch.kernels.gemv import check_codes, vector_ok, weight_layout
from repro_torch.kernels.ref import ffn_activation

ACTIVATIONS = ("swiglu", "geglu")

_SIG = {"fused_ffn_up_bf16": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64] + [_build.I32] * 3 + [_build.VP],
        "fused_ffn_up_q8": [_build.VP] * 6 + [_build.I32] * 3
        + [_build.I64] + [_build.I32] * 4 + [_build.VP]}

fused_ffn_up_quant = _build.LaunchCounter("fused_ffn_up_quant")


def tiles(m: int, k: int, n: int, w_bytes: int = 2) -> tuple[int, int]:
    """(BN, BK) of one launch: flat_gemm's pickers, budgeted for the two
    weight tiles of ``w_bytes``-byte elements each stage holds."""
    m_pad = round_up(max(m, 1), 8)
    bn = pick_bn(m_pad, n, k, w_bytes=w_bytes, streams=2)
    return bn, pick_bk(m_pad, bn, k, w_bytes=w_bytes, streams=2)


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
    """Plain version: the kernel's K tiles accumulated in f32 (codes cast
    tile by tile), the steps on the f32 sums, the activation, one rounding
    to x's dtype."""
    m, k = x.shape
    _, bk = tiles(m, k, w_gate.shape[1], w_gate.element_size())
    g = torch.zeros((m, w_gate.shape[1]), dtype=torch.float32,
                    device=x.device)
    u = torch.zeros_like(g)
    for lo in range(0, k, bk):
        xs = x[:, lo:lo + bk].float()
        g += xs @ w_gate[lo:lo + bk].float()
        u += xs @ w_up[lo:lo + bk].float()
    if scale_pair("fused_ffn_up", wg_scale, wu_scale):
        g, u = g * wg_scale.float(), u * wu_scale.float()
    return (ffn_activation(g, activation) * u).to(x.dtype)


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
    bn, bk = tiles(m, k, n, w_gate.element_size())
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("fused_ffn", _SIG)
    if quantized:
        code = lib.fused_ffn_up_q8(
            _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
            _build.ptr(wg_scale), _build.ptr(wu_scale), _build.ptr(out),
            m, k, n, x.stride(0), int(activation == "geglu"), bn, bk, fp8,
            _build.stream_of(x))
        _build.check(lib, "fused_ffn_up_q8", code)
        fused_ffn_up_quant.launches += 1
        return out
    code = lib.fused_ffn_up_bf16(
        _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(out),
        m, k, n, x.stride(0), int(activation == "geglu"), bn, bk,
        _build.stream_of(x))
    _build.check(lib, "fused_ffn_up_bf16", code)
    fused_ffn_up.launches += 1
    return out


fused_ffn_up.launches = 0
