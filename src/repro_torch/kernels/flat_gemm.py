"""T2 — flat GEMM with M padded only to 8 (kernel: ``csrc/flat_gemm.cu``).

Replaces ``repro/kernels/flat_gemm.py::flat_gemm``. On a CUDA tensor the
wrapper launches the mma.sync kernel (operands swapped so N fills the
MMA's 16-row slot and the tokens fill n8; K tiles double-buffered with
cp.async; see the source's header); on a CPU tensor it runs
:func:`flat_gemm_plain`. ``flat_gemm.launches`` counts the bf16 kernel's
launches.

Split K: where the grid's columns leave SMs idle, :func:`pick_splits`
cuts K into fixed ranges of whole BK tiles, and one thread-block cluster
per output tile sums the ranges' f32 partials in split order before the
epilogue (no atomics). :func:`gemm_tiles` takes the split count from
the tiles of one 64-row block, so it never depends on M: a row's bits
are the same alone and in any batch. :func:`split_acc` is the plain
walk of the same splits, each row its own product.

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
from repro_torch.kernels.gemv import check_codes, vector_ok, weight_layout

BLOCK_M = 64                       # token rows per block (8 n8 MMA tiles)
BN_CHOICES = (32, 64, 128)
BK_CHOICES = (32, 64, 128)
MAX_SPLITS = 8                     # K splits: a portable cluster at most
SPLIT_BN = 64                      # the split kernel's column tile
SPLIT_STAGES = 4                   # the split kernel's cp.async ring

_SIG = {"flat_gemm_bf16": [_build.VP, _build.VP, _build.VP, _build.I32,
                           _build.I32, _build.I32, _build.I64, _build.I64,
                           _build.I32, _build.I32, _build.I32, _build.I32,
                           _build.VP],
        "flat_gemm_q8": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64] * 2 + [_build.I32] * 4 + [_build.VP]}

flat_gemm_quant = _build.LaunchCounter("flat_gemm_quant")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def smem_bytes(bn: int, bk: int, *, w_kn: bool = False, w_bytes: int = 2,
               streams: int = 1, stages: int = 2) -> int:
    """Shared memory of one launch: ``stages`` stages of the bf16 x tile
    (BLOCK_M x BK) and ``streams`` W tiles (two for the fused FFN-up's
    gate and up) of ``w_bytes``-byte elements, every row padded by 16
    bytes (8 bf16, 16 codes)."""
    x_tile = BLOCK_M * (bk + 8) * 2
    w_tile = bk * (bn * w_bytes + 16) if w_kn else bn * (bk * w_bytes + 16)
    return stages * (x_tile + streams * w_tile)


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


def pick_splits(k: int, n: int, bn: int, bk: int, *,
                spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of a grid of ceil(N / BN) column blocks: enough for two
    blocks per SM, at most MAX_SPLITS (a portable cluster) and at most
    one per K tile; 1 where the columns alone give every SM two blocks.
    A split is ceil(n_kt / splits) whole BK tiles counted from K = 0, and
    the count is trimmed so that every split holds at least one tile.
    On the H100 the time falls with each block's share of K: more
    splits beat deeper rings."""
    blocks = -(-n // bn)
    n_kt = -(-k // bk)
    want = min(n_kt, MAX_SPLITS, -(-2 * spec.num_sms // blocks))
    return -(-n_kt // -(-n_kt // want))


def gemm_tiles(m: int, k: int, n: int, *, w_kn: bool = True,
               w_bytes: int = 2,
               spec: hardware.HardwareSpec = hardware.DEFAULT
               ) -> tuple[int, int, int]:
    """(BN, BK, splits) of a flat-GEMM launch (and of oproj_residual's).
    Where the columns of one 64-row block at pick_bn's BN leave SMs idle,
    the launch splits K at BN = SPLIT_BN, with pick_bk's BK for it and a
    count that depends on K, N and the card only, so it is the same at
    every M; otherwise (or when the 4-stage ring does not fit a block)
    it picks BN and BK for its M as before, unsplit."""
    kw = dict(w_kn=w_kn, w_bytes=w_bytes, spec=spec)
    if -(-n // pick_bn(1, n, k, **kw)) < spec.num_sms:
        bk = pick_bk(1, SPLIT_BN, k, **kw)
        splits = pick_splits(k, n, SPLIT_BN, bk, spec=spec)
        if splits > 1 and smem_bytes(
                SPLIT_BN, bk, w_kn=w_kn, w_bytes=w_bytes,
                stages=SPLIT_STAGES) <= spec.smem_per_block:
            return SPLIT_BN, bk, splits
    m_pad = round_up(max(m, 1), 8)
    bn = pick_bn(m_pad, n, k, **kw)
    return bn, pick_bk(m_pad, bn, k, **kw), 1


def split_acc(x: torch.Tensor, w: torch.Tensor, bk: int, splits: int,
              w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 (M, N) sums the split kernel forms: each split's BK tiles
    accumulated in f32 in K order (codes cast to f32, exactly), the
    splits' sums added in split order, times the per-column step if
    given. Each tile is a batched product with one row per batch entry:
    the CPU's 2-D matmul picks its summation order by the operands'
    shape, and a row's bits must not depend on its batch."""
    (m, k), n = x.shape, w.shape[1]
    xf = x.float()[:, None]
    n_kt = -(-k // bk)
    span = -(-n_kt // splits) * bk               # K elements per split
    total = None
    for lo in range(0, k, span):
        part = torch.zeros((m, n), dtype=torch.float32, device=x.device)
        for t in range(lo, min(lo + span, k), bk):
            wt = w[t:t + bk].float()
            part += torch.bmm(xf[..., t:t + bk],
                              wt.expand(m, *wt.shape))[:, 0]
        total = part if total is None else total + part
    return total if w_scale is None else total * w_scale.float()


def flat_gemm_plain(x: torch.Tensor, w: torch.Tensor, *,
                    w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the kernel's splits walked by :func:`split_acc`,
    rounded once to x's dtype."""
    m, k = x.shape
    _, bk, splits = gemm_tiles(m, k, w.shape[1], w_kn=w.stride(1) == 1,
                               w_bytes=w.element_size())
    return split_acc(x, w, bk, splits, w_scale).to(x.dtype)


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
    bn, bk, splits = gemm_tiles(m, k, n, w_kn=kn, w_bytes=w.element_size())
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("flat_gemm", _SIG)
    if w_scale is not None:
        code = lib.flat_gemm_q8(_build.ptr(x), _build.ptr(w),
                                _build.ptr(w_scale), _build.ptr(out), m, k,
                                n, x.stride(0), ldw, bn, bk, splits, fp8,
                                _build.stream_of(x))
        _build.check(lib, "flat_gemm_q8", code)
        flat_gemm_quant.launches += 1
        return out
    code = lib.flat_gemm_bf16(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                              m, k, n, x.stride(0), ldw, int(kn), bn, bk,
                              splits, _build.stream_of(x))
    _build.check(lib, "flat_gemm_bf16", code)
    flat_gemm.launches += 1
    return out


flat_gemm.launches = 0
