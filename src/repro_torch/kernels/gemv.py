"""ImplA — FastGEMV, four token rows a launch (kernel: ``csrc/gemv.cu``).

Replaces ``repro/kernels/gemv.py::gemv``. On a CUDA tensor the wrapper
launches the CUDA-core GEMV (bound: the weight bytes over device-memory
bandwidth; see the source's header for the design); on a CPU tensor it
runs :func:`gemv_plain`, the same arithmetic (bf16 products accumulated
in f32, rounded once to x's dtype). ``gemv.launches`` counts the bf16
kernel's launches.

The weight may be a row-major (K, N) tensor or the transposed view of a
row-major (N, K) tensor (the tied LM head ``embedding.T``); the kernel
reads either layout in place, chosen from the strides.

Split K: a (K, N) launch covers ``cols`` output columns per block (64,
or 32 where even the most splits leave 64-column blocks short of the
SMs) and cuts K into :func:`pick_splits` ranges of whole ``SPLIT_ROWS``
chunks counted from K = 0; one thread-block cluster per column tile sums
the ranges' f32 partials in split order before the epilogue. Both come
from :func:`gemv_tiles`, a function of K, N and the card, never of M, so
a row's bits are the same alone and in any batch. :func:`gemv_plain`
walks the same splits (``flat_gemm.split_acc``). The (N, K) view (the
tied head) launches unsplit: its columns fill the card.

``w_scale`` ((N,) f32, one step per output channel) marks ``w`` as the
int8 / fp8 codes of a quantized weight (``models/wquant.py``): the
quantized kernel (``_gemv_quant_kernel``'s port) streams the codes at 1
byte and multiplies the summed f32 partials by the step before the one
rounding, and :data:`gemv_quant` counts its launches. Codes come in the
(K, N) layout only: a quantized (N, K) view raises.

Any N: a bf16 (K, N) weight whose N or leading dimension is not a
multiple of 8 (hymba's ``w_dt``, 1,600 -> 50) has rows that are not
16-byte aligned; the kernel then loads each thread's 8 columns element by
element, those past N as zero, and writes only the live ones, with the
same products in the same order (no padded copy of the weight). Codes
keep N a multiple of 16 with aligned rows, and x's rows must be aligned
(K a multiple of 8): :func:`launch_layout` checks both.

Rows: the kernel holds at most MAX_M token rows. A call with more (a
plan may route M up to its ``m1`` here) launches the same kernel on
consecutive slices of at most MAX_M rows (:func:`row_slices`), each
writing its rows of one output; the tiles do not depend on M, so every
row gets the bits it gets alone, and each slice counts as one launch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import hardware
from repro_torch.kernels import _build

MAX_M = 4
MAX_SPLITS = 8                     # K splits: a portable cluster at most
SPLIT_ROWS = 64                    # K rows per split chunk (csrc: kSplitRows)

# a quantized weight's code dtypes -> the C entries' ``fp8`` flag
CODE_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}

_SIG = {"gemv_bf16": [_build.VP] * 3 + [_build.I32] * 3 + [_build.I64] * 2
        + [_build.I32] * 3 + [_build.VP],
        "gemv_q8": [_build.VP] * 4 + [_build.I32] * 3 + [_build.I64] * 2
        + [_build.I32] * 3 + [_build.VP]}

gemv_quant = _build.LaunchCounter("gemv_quant")


def pick_cols(n: int, *,
              spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """Columns per (K, N) block: 64 (128-byte rows of bf16 weights), or
    32 where even MAX_SPLITS splits of 64-column blocks leave SMs idle
    (k / v at N = 128, q / o_proj / down at N = 896), which doubles the
    blocks."""
    return 64 if -(-n // 64) * MAX_SPLITS >= spec.num_sms else 32


def pick_splits(k: int, n: int, *,
                spec: hardware.HardwareSpec = hardware.DEFAULT) -> int:
    """K splits of a (K, N) launch over :func:`pick_cols`'s column
    blocks: as many as keep the grid within two blocks per SM (one wave
    at the kernel's occupancy), at most MAX_SPLITS (a portable cluster)
    and one per SPLIT_ROWS chunk, trimmed so that none is empty; 1 where
    the columns alone give every SM two blocks. A function of K, N and
    the card only."""
    blocks = -(-n // pick_cols(n, spec=spec))
    n_ch = -(-k // SPLIT_ROWS)
    want = max(1, min(n_ch, MAX_SPLITS, 2 * spec.num_sms // blocks))
    return -(-n_ch // -(-n_ch // want))


@functools.lru_cache(maxsize=None)
def gemv_tiles(k: int, n: int, kn: bool = True, *,
               spec: hardware.HardwareSpec = hardware.DEFAULT
               ) -> tuple[int, int]:
    """(cols, splits) of a launch; the (N, K) view runs unsplit."""
    if not kn:
        return 64, 1
    return pick_cols(n, spec=spec), pick_splits(k, n, spec=spec)


def row_slices(m: int) -> list[tuple[int, int]]:
    """The (lo, hi) row ranges of a launch sequence: consecutive slices
    of at most MAX_M rows covering 0 .. M - 1, one kernel launch each."""
    if m < 1:
        raise ValueError(f"gemv kernel takes at least one row, got {m}")
    return [(lo, min(lo + MAX_M, m)) for lo in range(0, m, MAX_M)]


def gemv_plain(x: torch.Tensor, w: torch.Tensor, *,
               w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the kernel's splits walked by ``flat_gemm.split_acc``
    (each split's SPLIT_ROWS chunks in f32 in K order, codes cast to f32
    exactly, the splits' sums in split order, the step on the sum), one
    rounding to x's dtype."""
    from repro_torch.kernels.flat_gemm import split_acc
    _, splits = gemv_tiles(x.shape[1], w.shape[1], w.stride(1) == 1)
    return split_acc(x, w, SPLIT_ROWS, splits, w_scale).to(x.dtype)


def check_codes(what: str, w: torch.Tensor, w_scale: torch.Tensor) -> int:
    """Validate a quantized weight's codes ``w`` (K, N) and steps
    ``w_scale`` (N,) for a kernel; returns the C entries' ``fp8`` flag."""
    if w.dtype not in CODE_DTYPES:
        raise TypeError(f"{what}: quantized weights are int8 or "
                        f"float8_e4m3fn codes, got {w.dtype}")
    if (w_scale.dtype != torch.float32 or w_scale.shape != (w.shape[1],)
            or w_scale.stride(0) != 1 or w_scale.device != w.device):
        raise ValueError(f"{what}: the steps must be a contiguous "
                         f"({w.shape[1]},) f32 vector on the weight's "
                         f"device, got {tuple(w_scale.shape)} "
                         f"{w_scale.dtype}")
    return CODE_DTYPES[w.dtype]


def weight_layout(w: torch.Tensor) -> tuple[bool, int]:
    """(``kn``, leading stride) of a 2-D weight the kernels read in place:
    ``kn=True`` for row-major (K, N), ``False`` for the transposed view of
    a row-major (N, K) tensor. Raises for any other layout."""
    if w.stride(1) == 1:
        return True, w.stride(0)
    if w.stride(0) == 1:
        return False, w.stride(1)
    raise ValueError(f"weight strides {tuple(w.stride())} have no unit "
                     "stride; the kernels read (K, N) or (N, K) rows")


def x_ok(x: torch.Tensor) -> bool:
    """True when x's rows are 16-byte aligned bf16 vectors: K and the row
    stride multiples of 8, the base 16-byte aligned."""
    return (x.shape[1] % 8 == 0 and x.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0)


def w_aligned(w: torch.Tensor, kn: bool, ldw: int) -> bool:
    """True when every weight row is 16-byte aligned and whole 16-byte
    vectors (8 bf16, 16 codes) cover the contiguous axis."""
    inner = w.shape[1] if kn else w.shape[0]
    per = 16 // w.element_size()
    return inner % per == 0 and ldw % per == 0 and w.data_ptr() % 16 == 0


def vector_ok(x: torch.Tensor, w: torch.Tensor, kn: bool, ldw: int) -> bool:
    """True when every row the kernel reads, x's and the weight's, is
    16-byte aligned and covered by whole 16-byte vectors."""
    return x_ok(x) and w_aligned(w, kn, ldw)


def kn_tail(w: torch.Tensor) -> bool:
    """True for a bf16 (K, N) weight whose rows are not 16-byte aligned
    (N or the leading dimension not a multiple of 8): the GEMM kernels
    load it element by element (the TAIL loads of ``csrc/gemv.cu`` and
    ``csrc/flat_stream.cuh``)."""
    if w.element_size() != 2 or w.stride(1) != 1:
        return False
    return not w_aligned(w, True, w.stride(0))


def launch_layout(what: str, x: torch.Tensor, w: torch.Tensor,
                  w_scale: torch.Tensor | None) -> tuple[bool, int, int]:
    """(``kn``, leading stride, the C entries' ``fp8`` flag) of a GEMV or
    flat-GEMM launch, after checking what the kernels need: x's rows
    aligned (K a multiple of 8); codes in the (K, N) layout with N a
    multiple of 16 and aligned rows; a bf16 (N, K) view with aligned
    rows. A bf16 (K, N) weight may have any N and leading stride."""
    kn, ldw = weight_layout(w)
    if w_scale is not None:
        fp8 = check_codes(what, w, w_scale)
        if not kn or not vector_ok(x, w, kn, ldw):
            raise ValueError(
                f"quantized {what} kernel needs (K, N) codes with N a "
                "multiple of 16, K a multiple of 8 and 16-byte aligned rows")
        return kn, ldw, fp8
    if not x_ok(x) or not (kn or w_aligned(w, kn, ldw)):
        raise ValueError(
            f"{what} kernel needs K a multiple of 8 with 16-byte aligned "
            "rows of x (and of an (N, K) weight view)")
    return kn, ldw, 0


@_build.forward_only
def gemv(x: torch.Tensor, w: torch.Tensor, *,
         w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, any M >= 1 (one launch
    per :func:`row_slices` slice); with ``w_scale`` ``w`` holds codes and
    the result is (x @ codes) * step."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"gemv: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not x.is_cuda:
        return gemv_plain(x, w, w_scale=w_scale)
    slices = row_slices(m)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gemv kernel takes bf16 x, got {x.dtype}")
    if w_scale is None and w.dtype != torch.bfloat16:
        raise TypeError(f"gemv kernel takes bf16 weights (or codes with "
                        f"w_scale), got {w.dtype}")
    if w.device != x.device:
        raise ValueError("gemv: x and w on different devices")
    if x.stride(1) != 1:
        x = x.contiguous()
    kn, ldw, fp8 = launch_layout("gemv", x, w, w_scale)
    cols, splits = gemv_tiles(k, n, kn)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("gemv", _SIG)
    for lo, hi in slices:
        xs, os_ = x[lo:hi], out[lo:hi]
        if w_scale is not None:
            code = lib.gemv_q8(_build.ptr(xs), _build.ptr(w),
                               _build.ptr(w_scale), _build.ptr(os_), hi - lo,
                               k, n, x.stride(0), ldw, cols, splits, fp8,
                               _build.stream_of(x))
            _build.check(lib, "gemv_q8", code)
            gemv_quant.launches += 1
        else:
            code = lib.gemv_bf16(_build.ptr(xs), _build.ptr(w),
                                 _build.ptr(os_), hi - lo, k, n, x.stride(0),
                                 ldw, int(kn), cols, splits,
                                 _build.stream_of(x))
            _build.check(lib, "gemv_bf16", code)
            gemv.launches += 1
    return out


gemv.launches = 0
