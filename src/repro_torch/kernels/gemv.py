"""ImplA — FastGEMV for M <= 4 token rows (kernel: ``csrc/gemv.cu``).

Replaces ``repro/kernels/gemv.py::gemv``. On a CUDA tensor the wrapper
launches the CUDA-core GEMV (bound: the weight bytes over device-memory
bandwidth; see the source's header for the design); on a CPU tensor it
runs :func:`gemv_plain`, the same arithmetic (bf16 products accumulated
in f32, rounded once to x's dtype). ``gemv.launches`` counts kernel
launches.

The weight may be a row-major (K, N) tensor or the transposed view of a
row-major (N, K) tensor (the tied LM head ``embedding.T``); the kernel
reads either layout in place, chosen from the strides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_M = 4

_SIG = {"gemv_bf16": [_build.VP, _build.VP, _build.VP, _build.I32,
                      _build.I32, _build.I32, _build.I64, _build.I64,
                      _build.I32, _build.VP]}


def gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 accumulation, result in x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


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


def vector_ok(x: torch.Tensor, w: torch.Tensor, kn: bool, ldw: int) -> bool:
    """True when every row the kernel reads is 16-byte aligned and whole
    16-byte vectors cover the contiguous axis."""
    inner = w.shape[1] if kn else w.shape[0]
    return (inner % 8 == 0 and ldw % 8 == 0 and x.shape[1] % 8 == 0
            and x.stride(0) % 8 == 0 and w.data_ptr() % 16 == 0
            and x.data_ptr() % 16 == 0)


def gemv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, M <= 4."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"gemv: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if not x.is_cuda:
        return gemv_plain(x, w)
    if not 1 <= m <= MAX_M:
        raise ValueError(f"gemv kernel takes 1..{MAX_M} rows, got {m}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemv kernel takes bf16, got {x.dtype}/{w.dtype}")
    if w.device != x.device:
        raise ValueError("gemv: x and w on different devices")
    if x.stride(1) != 1:
        x = x.contiguous()
    kn, ldw = weight_layout(w)
    if not vector_ok(x, w, kn, ldw):
        raise ValueError(
            "gemv kernel needs K (and N for a (K, N) weight) to be a "
            "multiple of 8 with 16-byte aligned rows")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load("gemv", _SIG)
    code = lib.gemv_bf16(_build.ptr(x), _build.ptr(w), _build.ptr(out), m, k,
                         n, x.stride(0), ldw, int(kn), _build.stream_of(x))
    _build.check(lib, "gemv_bf16", code)
    gemv.launches += 1
    return out


gemv.launches = 0
