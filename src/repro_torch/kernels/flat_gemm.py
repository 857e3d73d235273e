"""T2 — flat GEMM with M padded only to 8 (kernel: ``csrc/flat_gemm.cu``).

Replaces ``repro/kernels/flat_gemm.py::flat_gemm``. On a CUDA tensor the
wrapper launches the mma.sync kernel (operands swapped so N fills the
MMA's 16-row slot and the tokens fill n8; K tiles double-buffered with
cp.async; see the source's header); on a CPU tensor it runs
:func:`flat_gemm_plain`. ``flat_gemm.launches`` counts the bf16 kernel's
launches.

``w_scale`` ((N,) f32 steps) marks ``w`` as the (K, N) int8 / fp8 codes of
a quantized weight: the same kernel streams the codes at 1 byte, turns
them into bf16 exactly in its fragment loads and multiplies the f32
accumulator by the step before the rounding (``_flat_gemm_quant_kernel``'s
port); :data:`flat_gemm_quant` counts its launches.

:func:`pick_bn` / :func:`pick_bk` are the paper's Eq. 5 re-derived for
the H100: a block covers ``BN`` output columns and up to 64 token rows
and streams K in ``BK`` tiles through two shared-memory stages. Larger
BN reuses each staged x tile over more columns; smaller BN gives more
blocks to spread over the SMs. The budget is the shared memory a block
may claim, counted for the weight layout and the weight element width
(2-byte bf16 or 1-byte codes; x is always bf16) that is launched.
"""
from __future__ import annotations

import torch

from repro_torch import hardware
from repro_torch.kernels import _build
from repro_torch.kernels.gemv import (check_codes, gemv_plain, vector_ok,
                                      weight_layout)

BLOCK_M = 64                       # token rows per block (8 n8 MMA tiles)
BN_CHOICES = (32, 64, 128)
BK_CHOICES = (32, 64, 128)

_SIG = {"flat_gemm_bf16": [_build.VP, _build.VP, _build.VP, _build.I32,
                           _build.I32, _build.I32, _build.I64, _build.I64,
                           _build.I32, _build.I32, _build.I32, _build.VP],
        "flat_gemm_q8": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64] * 2 + [_build.I32] * 3 + [_build.VP]}

flat_gemm_quant = _build.LaunchCounter("flat_gemm_quant")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(bn: int, bk: int, *, w_kn: bool = False, w_bytes: int = 2,
               streams: int = 1) -> int:
    """Shared memory of one launch: two stages of the bf16 x tile
    (BLOCK_M x BK) and ``streams`` W tiles (two for the fused FFN-up's
    gate and up) of ``w_bytes``-byte elements, every row padded by 16
    bytes (8 bf16, 16 codes)."""
    x_tile = BLOCK_M * (bk + 8) * 2
    w_tile = bk * (bn * w_bytes + 16) if w_kn else bn * (bk * w_bytes + 16)
    return 2 * (x_tile + streams * w_tile)


def pick_bn(m: int, n: int, k: int, *, w_kn: bool = True,
            w_bytes: int = 2, streams: int = 1,
            spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """Eq. 5 on the H100: the widest BN whose grid still gives every SM
    a block (more x-tile reuse at no cost in parallelism); when no BN
    fills the card, the narrowest (most parallel) one. BN must leave room
    for a double-buffered K tile in shared memory."""
    m_blocks = -(-max(m, 1) // BLOCK_M)
    fits = [bn for bn in BN_CHOICES
            if smem_bytes(bn, BK_CHOICES[0], w_kn=w_kn, w_bytes=w_bytes,
                          streams=streams) <= spec.smem_per_block]
    filling = [bn for bn in fits if -(-n // bn) * m_blocks >= spec.num_sms]
    return max(filling) if filling else min(fits)


def pick_bk(m: int, bn: int, k: int, *, w_kn: bool = True,
            w_bytes: int = 2, streams: int = 1,
            spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """The deepest K tile (fewer pipeline steps per block) whose two
    stages fit the shared-memory budget and that does not overshoot K."""
    best = BK_CHOICES[0]
    for bk in BK_CHOICES:
        if bk > round_up(k, BK_CHOICES[0]):
            break
        if smem_bytes(bn, bk, w_kn=w_kn, w_bytes=w_bytes,
                      streams=streams) <= spec.smem_per_block:
            best = bk
    return best


# the plain version is the GEMV's: bf16 products (or codes, cast exactly)
# accumulated in f32, the step applied to the f32 sum, rounded once to x's
# dtype
flat_gemm_plain = gemv_plain


def flat_gemm(x: torch.Tensor, w: torch.Tensor, *,
              w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype. M is padded to 8 inside
    the kernel (masked loads), never on the host. With ``w_scale`` ``w``
    holds codes and the result is (x @ codes) * step."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"flat_gemm: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if not x.is_cuda:
        return flat_gemm_plain(x, w, w_scale=w_scale)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flat_gemm kernel takes bf16 x, got {x.dtype}")
    if w_scale is None and w.dtype != torch.bfloat16:
        raise TypeError(f"flat_gemm kernel takes bf16 weights (or codes "
                        f"with w_scale), got {w.dtype}")
    if w.device != x.device:
        raise ValueError("flat_gemm: x and w on different devices")
    if x.stride(1) != 1:
        x = x.contiguous()
    kn, ldw = weight_layout(w)
    if w_scale is not None:
        fp8 = check_codes("flat_gemm", w, w_scale)
        if not kn or not vector_ok(x, w, kn, ldw):
            raise ValueError(
                "quantized flat_gemm kernel needs (K, N) codes with N a "
                "multiple of 16, K a multiple of 8 and 16-byte aligned rows")
    elif not vector_ok(x, w, kn, ldw):
        raise ValueError(
            "flat_gemm kernel needs K (and N for a (K, N) weight) to be a "
            "multiple of 8 with 16-byte aligned rows")
    m_pad = round_up(m, 8)
    wb = w.element_size()
    bn = pick_bn(m_pad, n, k, w_kn=kn, w_bytes=wb)
    bk = pick_bk(m_pad, bn, k, w_kn=kn, w_bytes=wb)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("flat_gemm", _SIG)
    if w_scale is not None:
        code = lib.flat_gemm_q8(_build.ptr(x), _build.ptr(w),
                                _build.ptr(w_scale), _build.ptr(out), m, k,
                                n, x.stride(0), ldw, bn, bk, fp8,
                                _build.stream_of(x))
        _build.check(lib, "flat_gemm_q8", code)
        flat_gemm_quant.launches += 1
        return out
    code = lib.flat_gemm_bf16(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                              m, k, n, x.stride(0), ldw, int(kn), bn, bk,
                              _build.stream_of(x))
    _build.check(lib, "flat_gemm_bf16", code)
    flat_gemm.launches += 1
    return out


flat_gemm.launches = 0
