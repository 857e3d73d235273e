"""T2 — flat GEMM at small M (kernels: ``csrc/flat_gemm.cu``).

Replaces ``repro/kernels/flat_gemm.py::flat_gemm``. On a CUDA tensor the
wrapper launches one of two bodies, which :func:`gemm_tiles` picks from
K, N, the weight width and the card, never from M:

  * the ``wgmma`` / TMA body (``csrc/gemm_wgmma.cuh``) wherever N is wide
    enough that NARROW_BN-column blocks alone fill the card (gate / up,
    the tied head): 64 output columns by a fixed 64-row token operand a
    block (WG_BN, WG_TOKENS), K in WG_BK tiles through a ring at most
    WG_STAGES deep, K split over a thread-block cluster where 64-column
    tiles leave SMs idle (:func:`wgmma_splits`);
  * the split mma.sync body (``csrc/flat_stream.cuh``'s
    ``gemm_split_kernel``) at narrow N: BN = SPLIT_BN columns, K in
    :func:`pick_splits` ranges of whole :func:`pick_bk` tiles.

Either way one thread-block cluster per output tile sums the ranges' f32
partials in split order before the epilogue (no atomics), so a row's
bits are the same alone and in any batch. On a CPU tensor the wrapper
runs :func:`flat_gemm_plain`, which walks the launched body's tiles and
splits with :func:`split_acc`, each row its own product.
``flat_gemm.launches`` counts the bf16 launches.

Any N: a bf16 (K, N) weight whose rows are not 16-byte aligned (N or the
leading dimension not a multiple of 8, :func:`gemv.kn_tail`) cannot feed
TMA, so it always runs the split body, whose tail loads read it element
by element (columns past N as zero); the epilogue writes columns below N
only.

``w_scale`` ((N,) f32 steps) marks ``w`` as the (K, N) int8 / fp8 codes of
a quantized weight: the same bodies stream the codes at 1 byte, turn them
into bf16 exactly and multiply the f32 sum by the step before the
rounding (``_flat_gemm_quant_kernel``'s port); :data:`flat_gemm_quant`
counts their launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import hardware
from repro_torch.kernels import _build
from repro_torch.kernels.gemv import kn_tail, launch_layout

BLOCK_M = 64                       # token rows per split block (8 n8 tiles)
BK_CHOICES = (32, 64, 128)         # the split body's K tiles
MAX_SPLITS = 8                     # K splits: a portable cluster at most
NARROW_BN = 32                     # N is narrow below num_sms such blocks
SPLIT_BN = 64                      # the split body's column tile
SPLIT_STAGES = 4                   # the split body's cp.async ring
SPLIT_ROWS = 64                    # K rows per wgmma tile and split chunk
# the wgmma body (csrc/gemm_wgmma.cuh)
WG_BN = 64                         # output columns per block: the m64
WG_BK = SPLIT_ROWS                 # K per tile: one 128-byte bf16 row
WG_TOKENS = 64                     # token rows per block whatever M (n64)
WG_STAGES = 4                      # TMA ring depth at most
WG_MAX_BLOCKS = 4                  # blocks a SM its register cap allows
TILE_BYTES = WG_BK * WG_BN * 2     # one bf16 weight tile (8 KB)

_SIG = {"flat_gemm_bf16": [_build.VP, _build.VP, _build.VP, _build.I32,
                           _build.I32, _build.I32, _build.I64, _build.I64,
                           _build.I32, _build.I32, _build.I32, _build.I32,
                           _build.VP],
        "flat_gemm_q8": [_build.VP] * 4 + [_build.I32] * 3
        + [_build.I64] * 2 + [_build.I32] * 4 + [_build.VP]}

flat_gemm_quant = _build.LaunchCounter("flat_gemm_quant")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def split_smem(bk: int, *, w_kn: bool = True, w_bytes: int = 2) -> int:
    """Shared memory of a split-body launch: SPLIT_STAGES stages of the
    bf16 x tile (BLOCK_M x BK) and the (BK, SPLIT_BN) weight tile of
    ``w_bytes``-byte elements, every row padded by 16 bytes (8 bf16, 16
    codes)."""
    x_tile = BLOCK_M * (bk + 8) * 2
    w_tile = (bk * (SPLIT_BN * w_bytes + 16) if w_kn
              else SPLIT_BN * (bk * w_bytes + 16))
    return SPLIT_STAGES * (x_tile + w_tile)


def pick_bk(k: int, *, w_kn: bool = True, w_bytes: int = 2,
            spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """The split body's K tile: the deepest (fewer pipeline steps per
    block) whose ring fits a block's shared memory and that does not
    overshoot K."""
    best = BK_CHOICES[0]
    for bk in BK_CHOICES:
        if bk > round_up(k, BK_CHOICES[0]):
            break
        if split_smem(bk, w_kn=w_kn, w_bytes=w_bytes) <= spec.smem_per_block:
            best = bk
    return best


def pick_splits(k: int, n: int, bn: int, bk: int, *,
                spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of the split body's grid of ceil(N / BN) column blocks:
    enough for two blocks per SM, at most MAX_SPLITS (a portable cluster)
    and at most one per K tile; 1 where the columns alone give every SM
    two blocks. A split is ceil(n_kt / splits) whole BK tiles counted from
    K = 0, and the count is trimmed so that every split holds at least
    one tile. On the H100 the time falls with each block's share of K:
    more splits beat deeper rings."""
    blocks = -(-n // bn)
    n_kt = -(-k // bk)
    want = min(n_kt, MAX_SPLITS, -(-2 * spec.num_sms // blocks))
    return -(-n_kt // -(-n_kt // want))


def split_tiles(k: int, splits: int) -> int:
    """Whole SPLIT_ROWS tiles a split of K holds: ceil(n_kt / splits),
    counted from K = 0 (the last split may hold fewer)."""
    return -(-(-(-k // SPLIT_ROWS)) // splits)


def trim_splits(k: int, want: int) -> int:
    """``want`` splits of K in SPLIT_ROWS tiles, trimmed so that none is
    empty."""
    return -(-(-(-k // SPLIT_ROWS)) // split_tiles(k, want))


def cluster_splits(k: int, blocks: int, occupancy, *,
                   spec: hardware.HardwareSpec = hardware.DEFAULT
                   ) -> tuple[int | None, int | None]:
    """(most, fewest) splits of K in whole SPLIT_ROWS tiles (at most
    MAX_SPLITS, none empty) over ``blocks`` column tiles: the most whose
    clusters all run at once when an SM holds ``occupancy(tiles a
    split)`` blocks (:func:`hardware.cluster_slots`: one wave), and the
    fewest whose blocks fit at all (occupancy > 0); None where none
    do."""
    best = fit = None
    for want in range(1, min(MAX_SPLITS, -(-k // SPLIT_ROWS)) + 1):
        splits = trim_splits(k, want)
        occ = occupancy(split_tiles(k, splits))
        if occ == 0:
            continue
        fit = fit or splits
        if blocks <= hardware.cluster_slots(spec, splits, occ):
            best = splits
    return best, fit


def wgmma_smem(per: int, w_bytes: int = 2) -> int:
    """Shared memory of a wgmma-body launch whose splits hold ``per`` K
    tiles: a ring of min(WG_STAGES, per) stages (at least two) of a
    (WG_BK x WG_BN) weight tile of ``w_bytes``-byte elements and a
    (WG_TOKENS x WG_BK) bf16 x tile, two bf16 conversion tiles for
    codes, two mbarriers a stage, and 1024 bytes to align the ring to the
    128-byte swizzle's period. The f32 partials reuse the ring."""
    stages = min(WG_STAGES, max(2, per))
    conv = 2 * TILE_BYTES if w_bytes == 1 else 0
    return (stages * (WG_BK * WG_BN * w_bytes + WG_TOKENS * WG_BK * 2)
            + conv + 2 * WG_STAGES * 8 + 1024)


def blocks_per_sm(smem: int, max_blocks: int, *,
                  spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """Blocks of ``smem`` bytes one SM holds (each also holding the
    reserved share), at most ``max_blocks`` (the kernel's register cap);
    0 where one block does not fit."""
    if smem > spec.smem_per_block:
        return 0
    return min(max_blocks,
               spec.smem_per_sm // (smem + spec.smem_reserved_per_block))


@functools.lru_cache(maxsize=None)
def wgmma_splits(k: int, n: int, w_bytes: int = 2, *,
                 spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of a wgmma-body launch over ceil(N / WG_BN) column tiles:
    the most whose clusters all run at once at the occupancy their shared
    memory allows (:func:`cluster_splits`), 1 where none do (the tied
    head's 2,376 tiles fill the card alone). K, N, the weight width and
    the card only: qwen2-0.5b's gate / up (896 -> 4,864) 5 splits of
    three tiles, bf16 and codes; llama2-7b's (4,096 -> 11,008) 2."""
    best, _ = cluster_splits(
        k, -(-n // WG_BN),
        lambda per: blocks_per_sm(wgmma_smem(per, w_bytes), WG_MAX_BLOCKS,
                                  spec=spec), spec=spec)
    return best or 1


def gemm_tiles(k: int, n: int, *, w_kn: bool = True, w_bytes: int = 2,
               tail: bool = False,
               spec: hardware.HardwareSpec = hardware.DEFAULT
               ) -> tuple[str, int, int]:
    """(body, BK, splits) of a flat-GEMM launch (and of oproj_residual's),
    from K, N, the weight width and the card, never M. Narrow N (fewer
    than num_sms blocks of NARROW_BN columns) runs the split body
    ("split") at SPLIT_BN with :func:`pick_bk`'s BK and
    :func:`pick_splits`' count when that splits K; every other launch
    runs the wgmma body ("wgmma") at WG_BK with :func:`wgmma_splits`.
    ``tail`` (a weight with unaligned rows, :func:`gemv.kn_tail`) always
    runs the split body, whatever the count."""
    if tail or -(-n // NARROW_BN) < spec.num_sms:
        bk = pick_bk(k, w_kn=w_kn, w_bytes=w_bytes, spec=spec)
        splits = pick_splits(k, n, SPLIT_BN, bk, spec=spec)
        if splits > 1 or tail:
            return "split", bk, splits
    return "wgmma", WG_BK, wgmma_splits(k, n, w_bytes, spec=spec)


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
    _, bk, splits = gemm_tiles(x.shape[1], w.shape[1],
                               w_kn=w.stride(1) == 1,
                               w_bytes=w.element_size(), tail=kn_tail(w))
    return split_acc(x, w, bk, splits, w_scale).to(x.dtype)


@_build.forward_only
def flat_gemm(x: torch.Tensor, w: torch.Tensor, *,
              w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, any M >= 1 (rows past
    M are masked inside the kernel, never padded on the host). With
    ``w_scale`` ``w`` holds codes and the result is (x @ codes) * step."""
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
    kn, ldw, fp8 = launch_layout("flat_gemm", x, w, w_scale)
    body, bk, splits = gemm_tiles(k, n, w_kn=kn, w_bytes=w.element_size(),
                                  tail=kn_tail(w))
    split = int(body == "split")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("flat_gemm", _SIG)
    if w_scale is not None:
        code = lib.flat_gemm_q8(_build.ptr(x), _build.ptr(w),
                                _build.ptr(w_scale), _build.ptr(out), m, k,
                                n, x.stride(0), ldw, split, bk, splits, fp8,
                                _build.stream_of(x))
        _build.check(lib, "flat_gemm_q8", code)
        flat_gemm_quant.launches += 1
        return out
    code = lib.flat_gemm_bf16(_build.ptr(x), _build.ptr(w), _build.ptr(out),
                              m, k, n, x.stride(0), ldw, int(kn), split, bk,
                              splits, _build.stream_of(x))
    _build.check(lib, "flat_gemm_bf16", code)
    flat_gemm.launches += 1
    return out


flat_gemm.launches = 0
