"""T3 — the GEMM routing ladder (paper §5).

A transformer has only a few GEMM ``[K, N]`` shapes and only ``M`` (the
number of token rows) varies at run time, so an offline profile per
[K, N] finds two inflection points

    M < M₁            → ImplA  (CUDA-core GEMV — FastGEMV)
    M₁ ≤ M < M₂       → ImplB  (flat GEMM, M padded to 8 — T2)
    M₂ ≤ M            → ImplC  (cuBLAS through ``torch.matmul``)

and the runtime consults a zero-overhead lookup. This module holds the
ladder and one tuned record; the offline tuning flow (cost models and
sweeps) comes with a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import enum


class Impl(enum.Enum):
    GEMV = "ImplA"        # CUDA-core GEMV (kernels/gemv.py)
    FLAT_GEMM = "ImplB"   # minimal-pad flat GEMM (kernels/flat_gemm.py)
    XLA_DOT = "ImplC"     # generic library GEMM (torch.matmul / cuBLAS)


def pick_impl(m: int, m1: int, m2: int) -> Impl:
    """The piecewise routing ladder every GEMM decision reduces to."""
    if m < m1:
        return Impl.GEMV
    if m < m2:
        return Impl.FLAT_GEMM
    return Impl.XLA_DOT


@dataclasses.dataclass(frozen=True)
class DispatchEntry:
    """One tuned [K, N] inflection record (a matmul-plan entry)."""

    k: int
    n: int
    m1: int  # first M where ImplB beats ImplA
    m2: int  # first M where ImplC beats ImplB

    def pick(self, m: int) -> Impl:
        return pick_impl(m, self.m1, self.m2)
