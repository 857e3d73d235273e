"""ExecutionPlan — one kernel-dispatch surface for every op.

Every implementation decision (GEMM routing by M, decode softmax scheme
and ``block_k``, the overflow-recompute branch, the prefill chunking
threshold, fused-FFN on/off, the paged-KV knobs, the decode-layer
granularity) lives in one
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
from typing import Dict, Optional, Tuple

from repro_torch.core import dispatch

BACKENDS = ("torch", "cuda")
SCHEMES = ("sync", "unified_max")
GATHER_MODES = ("dense", "fused")  # chunk-path page access discipline
GROUP_MODES = ("off", "grouped")   # decode-path shared-prefix discipline
KV_DTYPES = ("bf16", "int8", "fp8")  # paged KV page storage precision
WEIGHT_DTYPES = ("bf16", "int8", "fp8")  # GEMM weight storage precision
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
    ladder for unseen shapes (GEMV only at M <= 2, cuBLAS from M = 128).

    ``weight_dtype`` is the GEMM weight storage precision
    (:data:`WEIGHT_DTYPES`): ``"int8"`` / ``"fp8"`` make the engine
    quantize every layer GEMM weight at load into 1-byte codes with one
    f32 step per output channel (``models/wquant.py``), which the kernels
    apply on their f32 accumulators. The kernels key off the quantized
    leaf itself, not this knob; ``"bf16"`` is the bitwise path."""

    backend: str = "cuda"
    default_m1: int = 3
    default_m2: int = 128
    weight_dtype: str = "bf16"
    entries: Dict[Tuple[int, int], dispatch.DispatchEntry] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self):
        _check(self.backend, BACKENDS, "matmul.backend")
        _check(self.weight_dtype, WEIGHT_DTYPES, "matmul.weight_dtype")
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
    """Gate+up epilogue fusion: ``fused=True`` routes every gated
    ``mlp_block`` through ``ops.fused_ffn`` (the fused FFN-up kernel on
    ``"cuda"``). Off by default, as in the JAX package; ``make_plan``
    turns it on for the kernel backend."""

    backend: str = "cuda"
    fused: bool = False

    def __post_init__(self):
        _check(self.backend, BACKENDS, "fused_ffn.backend")


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """Block-paged KV path: softmax scheme and recompute for paged decode
    and chunk attention, and the chunked-prefill page-access discipline.

    ``gather_chunk`` names how chunked prefill reads resident KV:

      * ``"dense"`` — gather the full ``(B, NB*PS)`` per-sequence view
        per layer per chunk step and run the reference chunk math.
      * ``"fused"`` — the fused chunk kernel (``kernels/chunk_attention``)
        reads K/V pages in place through the block tables, which the
        engine bounds to a power-of-two count of resident pages.

    ``fused_threshold`` is the prompt length from which a wave runs the
    fused discipline; ``chunk_block`` is the prefill chunk size
    ``Engine(prefill_chunk=None)`` adopts (it must divide the page size
    for prefix sharing). The defaults are the chunk decision of the JAX
    package's tuned plans (``plans/qwen2-0.5b-tpu-v5e.json``).
    ``decode_group="grouped"`` reads each shared-prefix group's pages
    once per (group, kv head) at decode (the two-stage grouped kernels);
    a group is formed only when ``members * prefix_pages >=
    group_threshold``. ``kv_dtype`` is the pages' storage precision a
    paged engine adopts unless ``Engine(kv_dtype=)`` says otherwise:
    ``"bf16"`` values, or ``"int8"`` / ``"fp8"`` codes with one f32 step
    per (page, kv head), read by the paged kernels' quantized bodies.
    ``swap_threshold`` (tiers, slice 6) is accepted so that plans keep the
    JAX schema; nothing reads it yet.
    """

    backend: str = "cuda"
    scheme: str = "unified_max"
    fallback: bool = True
    gather_chunk: str = "fused"
    fused_threshold: int = 64
    chunk_block: int = 64
    decode_group: str = "off"
    group_threshold: int = 2
    swap_threshold: int = 1
    kv_dtype: str = "bf16"

    def __post_init__(self):
        _check(self.backend, BACKENDS, "paged.backend")
        _check(self.scheme, SCHEMES, "paged.scheme")
        _check(self.gather_chunk, GATHER_MODES, "paged.gather_chunk")
        _check_pos(self.fused_threshold, "paged.fused_threshold")
        _check_pos(self.chunk_block, "paged.chunk_block")
        _check(self.decode_group, GROUP_MODES, "paged.decode_group")
        _check_pos(self.group_threshold, "paged.group_threshold")
        _check_pos(self.swap_threshold, "paged.swap_threshold")
        _check(self.kv_dtype, KV_DTYPES, "paged.kv_dtype")


@dataclasses.dataclass(frozen=True)
class DecodeFusionPlan:
    """Decode-layer fusion granularity: how much of the per-layer decode
    chain one launch claims (:data:`FUSION_MODES`).

      * ``"split"`` — the op chain: every stage (norm, QKV GEMMs, bias,
        rope, KV write, attention, o_proj, residual, FFN) is its own
        launch, the depth a Python loop over per-layer views. The
        reference path.
      * ``"fused"`` — the memory-bound seams collapse into the fused
        stage kernels: ``ops.decode_ingest`` (norm → QKV → bias → rope),
        ``ops.oproj_residual`` (GEMM into the residual stream, serving
        both the o_proj and the FFN down projection) and
        ``ops.ffn_norm`` (norm → gate/up → activation), four launches
        per layer in place of the split chain's GEMMs and elementwise
        ops. The depth stays a Python loop.
      * ``"looped"`` — the ``fused`` per-layer math with the whole
        decode step (embed, every layer with its KV writes and
        attention, the final norm, the lm_head) captured once into a
        CUDA graph and replayed each tick
        (:class:`repro_torch.models.stack.LoopedDecode`): one host
        dispatch per tick, the port's counterpart of the JAX package's
        single ``lax.scan``. On CPU tensors there is no graph and the
        fused path runs eagerly.

    On ``"cuda"`` the stage kernels (``kernels/decode_fuse``) run; they
    accumulate the GEMMs over K tiles in f32, so they agree with the
    split chain to bf16 rounding, not bitwise. On ``"torch"`` the fused
    granularities call the stage oracles (``ref.decode_ingest_ref`` /
    ``ref.oproj_residual_ref`` / ``ref.ffn_norm_ref``), which compose
    exactly the split chain's expressions in the same order, so split,
    fused and looped give bitwise equal logits. On the card looped is
    bitwise fused: the same kernels on the same inputs in the same
    order, and no kernel of the port uses atomics.
    """

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
    paged: PagedPlan = dataclasses.field(default_factory=PagedPlan)
    decode_fusion: DecodeFusionPlan = dataclasses.field(
        default_factory=DecodeFusionPlan)


DEFAULT_PLAN = ExecutionPlan()


def make_plan(backend: str = "cuda", *, fused_ffn: Optional[bool] = None,
              gather_chunk: str = "fused", fused_threshold: int = 64,
              decode_group: str = "off",
              group_threshold: int = 2,
              decode_fusion: str = "split",
              weight_dtype: Optional[str] = "bf16",
              kv_dtype: str = "bf16") -> ExecutionPlan:
    """The untuned plan with every op on ``backend``. ``fused_ffn=None``
    fuses the FFN-up on the kernel backend (``"cuda"``) only, as the JAX
    package does for ``"pallas"``; ``gather_chunk`` and
    ``fused_threshold`` pin the paged chunk discipline, ``decode_group``
    and ``group_threshold`` the shared-prefix decode grouping,
    ``decode_fusion`` the decode-layer granularity, ``weight_dtype``
    the GEMM weight precision and ``kv_dtype`` the KV page precision of
    paged engines. ``weight_dtype=None`` (the JAX package's
    cost-model pick, ``dispatch.find_weight_dtype``) is refused: the cost
    models wait with item 2 of slice 1's remainder in ROADMAP.md."""
    if weight_dtype is None:
        raise PlanError(
            "weight_dtype=None asks dispatch.find_weight_dtype's cost model "
            "to pick the precision; the port's cost models are not ported "
            "yet (ROADMAP.md, slice 1's remainder, item 2): pass one of "
            f"{WEIGHT_DTYPES}")
    if fused_ffn is None:
        fused_ffn = backend == "cuda"
    return ExecutionPlan(
        matmul=MatmulPlan(backend=backend, weight_dtype=weight_dtype),
        attention_decode=AttentionDecodePlan(backend=backend),
        attention_prefill=AttentionPrefillPlan(backend=backend),
        fused_ffn=FusedFFNPlan(backend=backend, fused=fused_ffn),
        paged=PagedPlan(backend=backend, gather_chunk=gather_chunk,
                        fused_threshold=fused_threshold,
                        decode_group=decode_group,
                        group_threshold=group_threshold,
                        kv_dtype=kv_dtype),
        decode_fusion=DecodeFusionPlan(backend=backend,
                                       granularity=decode_fusion),
    )
