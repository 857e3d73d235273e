"""T2 — flat GEMM with M padded only to 8 (kernel: ``csrc/flat_gemm.cu``).

Replaces ``repro/kernels/flat_gemm.py::flat_gemm``. On a CUDA tensor the
wrapper launches the mma.sync kernel (operands swapped so N fills the
MMA's 16-row slot and the tokens fill n8; K tiles double-buffered with
cp.async; see the source's header); on a CPU tensor it runs
:func:`flat_gemm_plain`. ``flat_gemm.launches`` counts kernel launches.

:func:`pick_bn` / :func:`pick_bk` are the paper's Eq. 5 re-derived for
the H100: a block covers ``BN`` output columns and up to 64 token rows
and streams K in ``BK`` tiles through two shared-memory stages. Larger
BN reuses each staged x tile over more columns; smaller BN gives more
blocks to spread over the SMs. The budget is the shared memory a block
may claim, counted for the weight layout that is launched.
"""
from __future__ import annotations

import torch

from repro_torch import hardware
from repro_torch.kernels import _build
from repro_torch.kernels.gemv import gemv_plain, vector_ok, weight_layout

BLOCK_M = 64                       # token rows per block (8 n8 MMA tiles)
BN_CHOICES = (32, 64, 128)
BK_CHOICES = (32, 64, 128)

_SIG = {"flat_gemm_bf16": [_build.VP, _build.VP, _build.VP, _build.I32,
                           _build.I32, _build.I32, _build.I64, _build.I64,
                           _build.I32, _build.I32, _build.I32, _build.VP]}


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(bn: int, bk: int, *, w_kn: bool = False,
               dtype_bytes: int = 2) -> int:
    """Shared memory of one launch: two stages of the x tile
    (BLOCK_M x BK) and the W tile, rows padded by 8 elements."""
    x_tile = BLOCK_M * (bk + 8)
    w_tile = bk * (bn + 8) if w_kn else bn * (bk + 8)
    return 2 * (x_tile + w_tile) * dtype_bytes


def pick_bn(m: int, n: int, k: int, *, w_kn: bool = True,
            dtype_bytes: int = 2,
            spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """Eq. 5 on the H100: the widest BN whose grid still gives every SM
    a block (more x-tile reuse at no cost in parallelism); when no BN
    fills the card, the narrowest (most parallel) one. BN must leave room
    for a double-buffered K tile in shared memory."""
    m_blocks = -(-max(m, 1) // BLOCK_M)
    fits = [bn for bn in BN_CHOICES
            if smem_bytes(bn, BK_CHOICES[0], w_kn=w_kn,
                          dtype_bytes=dtype_bytes) <= spec.smem_per_block]
    filling = [bn for bn in fits if -(-n // bn) * m_blocks >= spec.num_sms]
    return max(filling) if filling else min(fits)


def pick_bk(m: int, bn: int, k: int, *, w_kn: bool = True,
            dtype_bytes: int = 2,
            spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """The deepest K tile (fewer pipeline steps per block) whose two
    stages fit the shared-memory budget and that does not overshoot K."""
    best = BK_CHOICES[0]
    for bk in BK_CHOICES:
        if bk > round_up(k, BK_CHOICES[0]):
            break
        if smem_bytes(bn, bk, w_kn=w_kn,
                      dtype_bytes=dtype_bytes) <= spec.smem_per_block:
            best = bk
    return best


# the plain version is the GEMV's: bf16 products accumulated in f32,
# rounded once to x's dtype
flat_gemm_plain = gemv_plain


def flat_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype. M is padded to 8 inside
    the kernel (masked loads), never on the host."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"flat_gemm: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if not x.is_cuda:
        return flat_gemm_plain(x, w)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"flat_gemm kernel takes bf16, got "
                        f"{x.dtype}/{w.dtype}")
    if w.device != x.device:
        raise ValueError("flat_gemm: x and w on different devices")
    if x.stride(1) != 1:
        x = x.contiguous()
    kn, ldw = weight_layout(w)
    if not vector_ok(x, w, kn, ldw):
        raise ValueError(
            "flat_gemm kernel needs K (and N for a (K, N) weight) to be a "
            "multiple of 8 with 16-byte aligned rows")
    m_pad = round_up(m, 8)
    bn = pick_bn(m_pad, n, k, w_kn=kn)
    bk = pick_bk(m_pad, bn, k, w_kn=kn)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("flat_gemm", _SIG)
    code = lib.flat_gemm_bf16(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                              m, k, n, x.stride(0), ldw, int(kn), bn, bk,
                              _build.stream_of(x))
    _build.check(lib, "flat_gemm_bf16", code)
    flat_gemm.launches += 1
    return out


flat_gemm.launches = 0
