"""ExecutionPlan — one kernel-dispatch surface for every op.

Every implementation decision (GEMM routing by M, decode softmax scheme
and ``block_k``, the overflow-recompute branch, the prefill chunking
threshold, fused-FFN on/off, the decode-layer granularity) lives in one
frozen record that ``ops.*``, ``LayerCtx`` and ``Engine`` take as their
single ``plan=`` operand. Plans choose *which* implementation runs, never
the math.

Backends:
  * ``"cuda"`` — the hand-written Hopper kernels under ``csrc/`` (the
    role ``"pallas"`` plays in the JAX package). On a CPU tensor each
    kernel wrapper runs its plain PyTorch version instead; on a CUDA
    tensor it launches the kernel or raises.
  * ``"torch"`` — plain PyTorch reference math (``kernels/ref.py``; the
    role of ``"xla"``).

The offline tuning flow and JSON save/load come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import dispatch

BACKENDS = ("torch", "cuda")
SCHEMES = ("sync", "unified_max")
FUSION_MODES = ("split", "fused", "looped")  # decode-layer stage granularity


class PlanError(ValueError):
    """Malformed plan (unknown knob value)."""


def _check(value: str, allowed: Tuple[str, ...], what: str) -> None:
    if value not in allowed:
        raise PlanError(f"{what} must be one of {allowed}, got {value!r}")


def _check_pos(value: int, what: str) -> None:
    if not isinstance(value, int) or isinstance(value, bool) or value < 1:
        raise PlanError(f"{what} must be a positive int, got {value!r}")


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """GEMM routing: tuned [K, N] inflection entries plus the default
    ladder for unseen shapes (GEMV only at M <= 2, cuBLAS from M = 128)."""

    backend: str = "cuda"
    default_m1: int = 3
    default_m2: int = 128
    entries: Dict[Tuple[int, int], dispatch.DispatchEntry] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _check(self.backend, BACKENDS, "matmul.backend")
        _check_pos(self.default_m1, "matmul.default_m1")
        _check_pos(self.default_m2, "matmul.default_m2")
        if self.default_m2 < self.default_m1:
            raise PlanError(
                f"matmul default ladder inverted: m1={self.default_m1} > "
                f"m2={self.default_m2}")
        for (k, n), e in self.entries.items():
            if e.m2 < e.m1:
                raise PlanError(
                    f"matmul entry [{k}, {n}] inverted: m1={e.m1} > "
                    f"m2={e.m2}")

    def pick(self, m: int, k: int, n: int) -> dispatch.Impl:
        e = self.entries.get((k, n))
        if e is None:
            return dispatch.pick_impl(m, self.default_m1, self.default_m2)
        return e.pick(m)


@dataclasses.dataclass(frozen=True)
class AttentionDecodePlan:
    """Decode-phase attention: softmax scheme, KV tile, overflow
    recompute. ``scheme="unified_max"`` is effective only when the
    model's φ config is active; ``fallback=False`` drops the recompute."""

    backend: str = "cuda"
    scheme: str = "unified_max"
    block_k: int = 512
    fallback: bool = True

    def __post_init__(self):
        _check(self.backend, BACKENDS, "attention_decode.backend")
        _check(self.scheme, SCHEMES, "attention_decode.scheme")
        _check_pos(self.block_k, "attention_decode.block_k")


@dataclasses.dataclass(frozen=True)
class AttentionPrefillPlan:
    """Prefill-phase attention: softmax scheme, overflow recompute, and
    the sequence threshold above which the torch path switches from the
    materialized (S, S) scores to the blockwise scheme."""

    backend: str = "cuda"
    scheme: str = "unified_max"
    fallback: bool = True
    chunk_threshold: int = 2048

    def __post_init__(self):
        _check(self.backend, BACKENDS, "attention_prefill.backend")
        _check(self.scheme, SCHEMES, "attention_prefill.scheme")
        _check_pos(self.chunk_threshold, "attention_prefill.chunk_threshold")


@dataclasses.dataclass(frozen=True)
class FusedFFNPlan:
    """Gate+up epilogue fusion. ``fused=True`` needs the fused FFN kernel,
    which a later slice of the port brings."""

    backend: str = "cuda"
    fused: bool = False

    def __post_init__(self):
        _check(self.backend, BACKENDS, "fused_ffn.backend")


@dataclasses.dataclass(frozen=True)
class DecodeFusionPlan:
    """Decode-layer granularity. Only ``"split"`` (one op per stage) is
    ported; ``"fused"``/``"looped"`` come with the decode-fusion slice."""

    backend: str = "cuda"
    granularity: str = "split"

    def __post_init__(self):
        _check(self.backend, BACKENDS, "decode_fusion.backend")
        _check(self.granularity, FUSION_MODES, "decode_fusion.granularity")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    matmul: MatmulPlan = dataclasses.field(default_factory=MatmulPlan)
    attention_decode: AttentionDecodePlan = dataclasses.field(
        default_factory=AttentionDecodePlan)
    attention_prefill: AttentionPrefillPlan = dataclasses.field(
        default_factory=AttentionPrefillPlan)
    fused_ffn: FusedFFNPlan = dataclasses.field(default_factory=FusedFFNPlan)
    decode_fusion: DecodeFusionPlan = dataclasses.field(
        default_factory=DecodeFusionPlan)


DEFAULT_PLAN = ExecutionPlan()


def make_plan(backend: str = "cuda") -> ExecutionPlan:
    """The untuned plan with every op on ``backend``."""
    return ExecutionPlan(
        matmul=MatmulPlan(backend=backend),
        attention_decode=AttentionDecodePlan(backend=backend),
        attention_prefill=AttentionPrefillPlan(backend=backend),
        fused_ffn=FusedFFNPlan(backend=backend),
        decode_fusion=DecodeFusionPlan(backend=backend),
    )
