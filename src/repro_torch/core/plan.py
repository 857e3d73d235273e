"""ExecutionPlan — one tuned, serializable kernel-dispatch surface for
every op (T3 generalized beyond GEMM).

Every implementation decision (GEMM routing by M, decode softmax scheme
and ``block_k``, the overflow-recompute branch, the prefill chunking
threshold, fused-FFN on/off, the paged-KV knobs, the decode-layer
granularity) lives in one frozen record that ``ops.*``, ``LayerCtx`` and
``Engine`` take as their single ``plan=`` operand. Plans choose *which*
implementation runs, never the math.

Backends:
  * ``"cuda"`` — the hand-written Hopper kernels under ``csrc/`` (the
    role ``"pallas"`` plays in the JAX package). On a CPU tensor each
    kernel wrapper runs its plain PyTorch version instead; on a CUDA
    tensor it launches the kernel or raises.
  * ``"torch"`` — plain PyTorch reference math (``kernels/ref.py``; the
    role of ``"xla"``).

:func:`tune` drives every decision flow of :mod:`repro_torch.core.dispatch`
(GEMM inflections from the analytical models or, ``measure="wallclock"``,
from CUDA-event timings of the port's kernels on the card) and stamps the
plan with its provenance: backend, hardware-spec hash, config hash and
the measure. Plans serialize to versioned JSON
(``plans_torch/<arch>-<hw>.json``, :func:`default_plan_path`), and a
strict :meth:`ExecutionPlan.load` refuses a plan tuned for other
hardware or another config.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional, Tuple, Union

from repro_torch import hardware
from repro_torch.config import ModelConfig
from repro_torch.core import dispatch

PLAN_VERSION = 1

BACKENDS = ("torch", "cuda")
SCHEMES = ("sync", "unified_max")
GATHER_MODES = ("dense", "fused")  # chunk-path page access discipline
GROUP_MODES = ("off", "grouped")   # decode-path shared-prefix discipline
KV_DTYPES = ("bf16", "int8", "fp8")  # paged KV page storage precision
WEIGHT_DTYPES = ("bf16", "int8", "fp8")  # GEMM weight storage precision
FUSION_MODES = ("split", "fused", "looped")  # decode-layer stage granularity


class PlanError(ValueError):
    """Malformed plan document (bad JSON shape, unknown knob value)."""


class StalePlanError(PlanError):
    """Plan provenance does not match the requested run (wrong plan
    version, hardware spec, or model config) — retune instead of serving
    decisions profiled for a different world."""


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
    ``swap_threshold`` (tiers, slice 6) is tuned by
    :func:`repro_torch.core.dispatch.find_swap_threshold`; nothing serves
    from it until the tiers land.
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


# ---------------------------------------------------------------------------
# Provenance
# ---------------------------------------------------------------------------


def _digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def hardware_hash(spec: hardware.HardwareSpec) -> str:
    return _digest(dataclasses.asdict(spec))


def config_hash(cfg: ModelConfig) -> str:
    return _digest(dataclasses.asdict(cfg))


@dataclasses.dataclass(frozen=True)
class PlanProvenance:
    """Where a tuned plan came from — checked on load."""

    backend: str
    hardware: str        # hardware_hash(spec)
    hardware_name: str
    config: str          # config_hash(cfg)
    config_name: str
    measure: str         # analytical | wallclock | custom
    version: int = PLAN_VERSION


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


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
    provenance: Optional[PlanProvenance] = None

    # -- bulk knob overrides -------------------------------------------------

    def with_overrides(
        self,
        *,
        backend: Optional[str] = None,
        scheme: Optional[str] = None,
        fallback: Optional[bool] = None,
        block_k: Optional[int] = None,
    ) -> "ExecutionPlan":
        """Return a copy with shared knobs overridden across every op that
        carries them (``None`` keeps the existing decision). A backend
        other than ``"cuda"`` unfuses the FFN-up (the fused kernel is the
        kernel backend's); tuned entries and thresholds survive."""
        def sub(p, **fields):
            fields = {k: v for k, v in fields.items() if v is not None}
            return dataclasses.replace(p, **fields) if fields else p

        fused = None
        if backend is not None and backend != "cuda":
            fused = False
        return dataclasses.replace(
            self,
            matmul=sub(self.matmul, backend=backend),
            attention_decode=sub(self.attention_decode, backend=backend,
                                 scheme=scheme, fallback=fallback,
                                 block_k=block_k),
            attention_prefill=sub(self.attention_prefill, backend=backend,
                                  scheme=scheme, fallback=fallback),
            fused_ffn=sub(self.fused_ffn, backend=backend, fused=fused),
            paged=sub(self.paged, backend=backend, scheme=scheme,
                      fallback=fallback),
            # granularity survives a backend override: on "torch" the
            # fused stages call their oracles
            decode_fusion=sub(self.decode_fusion, backend=backend),
        )

    def describe(self) -> str:
        d, p = self.attention_decode, self.attention_prefill
        return (f"matmul[{len(self.matmul.entries)} entries, "
                f"{self.matmul.backend}"
                + (f", w={self.matmul.weight_dtype}"
                   if self.matmul.weight_dtype != "bf16" else "")
                + "] "
                f"decode[{d.scheme}, block_k={d.block_k}, "
                f"fallback={d.fallback}] "
                f"prefill[{p.scheme}, chunk>={p.chunk_threshold}] "
                f"ffn[{'fused' if self.fused_ffn.fused else 'unfused'}] "
                f"paged[{self.paged.backend}/{self.paged.gather_chunk}"
                + (f">={self.paged.fused_threshold}"
                   if self.paged.gather_chunk == "fused" else "")
                + f", chunk={self.paged.chunk_block}"
                + (f", group>={self.paged.group_threshold}"
                   if self.paged.decode_group == "grouped" else "")
                + f", swap>={self.paged.swap_threshold}"
                + (f", kv={self.paged.kv_dtype}"
                   if self.paged.kv_dtype != "bf16" else "")
                + "] "
                f"fusion[{self.decode_fusion.granularity}]")

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        doc = {
            "version": PLAN_VERSION,
            "ops": {
                "matmul": {
                    "backend": self.matmul.backend,
                    "weight_dtype": self.matmul.weight_dtype,
                    "default": {"m1": self.matmul.default_m1,
                                "m2": self.matmul.default_m2},
                    "entries": {
                        f"{k},{n}": {"m1": e.m1, "m2": e.m2}
                        for (k, n), e in sorted(self.matmul.entries.items())
                    },
                },
                "attention_decode": dataclasses.asdict(self.attention_decode),
                "attention_prefill": dataclasses.asdict(
                    self.attention_prefill),
                "fused_ffn": dataclasses.asdict(self.fused_ffn),
                "paged": dataclasses.asdict(self.paged),
                "decode_fusion": dataclasses.asdict(self.decode_fusion),
            },
        }
        if self.provenance is not None:
            doc["provenance"] = dataclasses.asdict(self.provenance)
        return json.dumps(doc, indent=2)

    @staticmethod
    def from_json(s: str) -> "ExecutionPlan":
        try:
            doc = json.loads(s)
        except json.JSONDecodeError as e:
            raise PlanError(f"plan is not valid JSON: {e}") from e
        if not isinstance(doc, dict) or "ops" not in doc:
            raise PlanError("plan document has no 'ops' registry")
        version = doc.get("version")
        if version != PLAN_VERSION:
            raise StalePlanError(
                f"plan version {version!r} != supported {PLAN_VERSION}")
        ops = doc["ops"]
        try:
            mm = ops["matmul"]
            entries = {}
            for key, d in mm.get("entries", {}).items():
                k, n = (int(x) for x in key.split(","))
                entries[(k, n)] = dispatch.DispatchEntry(
                    k=k, n=n, m1=int(d["m1"]), m2=int(d["m2"]))
            matmul = MatmulPlan(
                backend=mm["backend"],
                weight_dtype=mm.get("weight_dtype", "bf16"),
                default_m1=int(mm["default"]["m1"]),
                default_m2=int(mm["default"]["m2"]),
                entries=entries,
            )
            plan = ExecutionPlan(
                matmul=matmul,
                attention_decode=AttentionDecodePlan(
                    **ops["attention_decode"]),
                attention_prefill=AttentionPrefillPlan(
                    **ops["attention_prefill"]),
                fused_ffn=FusedFFNPlan(**ops["fused_ffn"]),
                paged=PagedPlan(**ops["paged"]),
                decode_fusion=DecodeFusionPlan(
                    **ops.get("decode_fusion", {})),
            )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            if isinstance(e, PlanError):
                raise
            raise PlanError(f"malformed plan ops registry: {e!r}") from e
        prov = doc.get("provenance")
        if prov is not None:
            try:
                plan = dataclasses.replace(
                    plan, provenance=PlanProvenance(**prov))
            except TypeError as e:
                raise PlanError(
                    f"malformed plan provenance: {e!r}") from e
        return plan

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @staticmethod
    def load(
        path: str,
        *,
        cfg: Optional[ModelConfig] = None,
        spec: Optional[hardware.HardwareSpec] = hardware.DEFAULT,
        strict: bool = True,
    ) -> "ExecutionPlan":
        """Load a plan, rejecting stale artifacts.

        ``strict=True`` (the default) refuses plans without provenance and
        plans whose recorded hardware/config hash differs from the
        requested ``spec``/``cfg`` (pass ``cfg=None``/``spec=None`` to
        skip that axis). ``strict=False`` loads anything structurally
        valid — for inspection tooling, never for serving.
        """
        with open(path) as f:
            plan = ExecutionPlan.from_json(f.read())
        if not strict:
            return plan
        prov = plan.provenance
        if prov is None:
            raise StalePlanError(
                f"{path}: plan has no provenance; tune one with "
                "repro_torch.core.plan.tune (or load with strict=False)")
        if spec is not None and prov.hardware != hardware_hash(spec):
            raise StalePlanError(
                f"{path}: tuned for hardware {prov.hardware_name} "
                f"[{prov.hardware}], run targets {spec.name} "
                f"[{hardware_hash(spec)}] — retune")
        if cfg is not None and prov.config != config_hash(cfg):
            raise StalePlanError(
                f"{path}: tuned for config {prov.config_name} "
                f"[{prov.config}], run uses {cfg.name} "
                f"[{config_hash(cfg)}] — retune")
        return plan


DEFAULT_PLAN = ExecutionPlan()


def make_plan(
    backend: str = "cuda",
    *,
    scheme: str = "unified_max",
    fallback: bool = True,
    block_k: int = 512,
    chunk_threshold: int = 2048,
    fused_ffn: Optional[bool] = None,
    gather_chunk: str = "fused",
    fused_threshold: int = 64,
    chunk_block: int = 64,
    decode_group: str = "off",
    group_threshold: int = 2,
    swap_threshold: int = 1,
    kv_dtype: str = "bf16",
    weight_dtype: Optional[str] = "bf16",
    decode_fusion: str = "split",
) -> ExecutionPlan:
    """The untuned plan with uniform knobs on ``backend`` — the
    hand-rolled counterpart of :func:`tune`. ``fused_ffn=None`` fuses the
    FFN-up on the kernel backend (``"cuda"``) only, as the JAX package
    does for ``"pallas"``. ``weight_dtype=None`` (the cost model's pick)
    is refused here, as the JAX package's signature takes no ``None``:
    ``tune(cfg, weight_dtype=None)`` runs
    :func:`repro_torch.core.dispatch.find_weight_dtype`."""
    if weight_dtype is None:
        raise PlanError(
            "weight_dtype=None asks dispatch.find_weight_dtype's cost model "
            "to pick the precision, which needs a model config: use "
            "tune(cfg, weight_dtype=None), or pass one of "
            f"{WEIGHT_DTYPES}")
    if fused_ffn is None:
        fused_ffn = backend == "cuda"
    return ExecutionPlan(
        matmul=MatmulPlan(backend=backend, weight_dtype=weight_dtype),
        attention_decode=AttentionDecodePlan(
            backend=backend, scheme=scheme, fallback=fallback,
            block_k=block_k),
        attention_prefill=AttentionPrefillPlan(
            backend=backend, scheme=scheme, fallback=fallback,
            chunk_threshold=chunk_threshold),
        fused_ffn=FusedFFNPlan(backend=backend, fused=fused_ffn),
        paged=PagedPlan(backend=backend, scheme=scheme, fallback=fallback,
                        gather_chunk=gather_chunk,
                        fused_threshold=fused_threshold,
                        chunk_block=chunk_block,
                        decode_group=decode_group,
                        group_threshold=group_threshold,
                        swap_threshold=swap_threshold,
                        kv_dtype=kv_dtype),
        decode_fusion=DecodeFusionPlan(backend=backend,
                                       granularity=decode_fusion),
    )


# ---------------------------------------------------------------------------
# Offline tuning flow (generalizes find_inflections beyond GEMM)
# ---------------------------------------------------------------------------


MeasureLike = Union[str, dispatch.MeasureFn, None]


def _resolve_measure(measure: MeasureLike, nk=()):
    """-> (gemm measure fn | None, provenance label). ``nk``: the (K, N)
    shapes the wallclock timer runs on an (N, K) view (the tied head)."""
    if measure is None or measure == "analytical":
        return None, "analytical"
    if measure == "wallclock":
        return dispatch.wallclock_measure_factory(nk=nk), "wallclock"
    if callable(measure):
        return measure, "custom"
    raise PlanError(
        f"measure must be 'analytical', 'wallclock', or a callable; "
        f"got {measure!r}")


def tuned_gemm_shapes(cfg: ModelConfig) -> list[dispatch.GemmShape]:
    """Every [K, N] the tuner gives an entry: the JAX package's
    :func:`~repro_torch.core.dispatch.model_gemm_shapes` (kept for schema
    parity) and the shapes the port's layers pass to ``ops.matmul``
    (:func:`~repro_torch.core.dispatch.called_gemm_shapes`), first
    occurrence of each (K, N) kept."""
    seen, out = set(), []
    for gs in (dispatch.model_gemm_shapes(cfg)
               + dispatch.called_gemm_shapes(cfg)):
        if (gs.k, gs.n) not in seen:
            seen.add((gs.k, gs.n))
            out.append(gs)
    return out


def tune(
    cfg: ModelConfig,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    *,
    measure: MeasureLike = "analytical",
    backend: str = "cuda",
    decode_seq: int = 32768,
    page_size: int = 64,
    kv_dtype: str = "bf16",
    weight_dtype: Optional[str] = "bf16",
) -> ExecutionPlan:
    """Profile every op decision offline and emit a provenanced plan.

    GEMM inflections come from ``measure``: the analytical models on
    ``spec``, ``"wallclock"`` (CUDA-event timings of ``gemv``,
    ``flat_gemm`` and ``torch.matmul`` on the card; raises without
    CUDA), or a callable ``measure(impl, m, k, n) -> seconds``. Every
    other decision uses the analytical models. Entries cover
    :func:`tuned_gemm_shapes`; the default ladder for unseen shapes is
    tuned on a square [d_model, d_model] workload. ``decode_seq`` is the
    representative decode KV length of the ``block_k`` sweep;
    ``page_size`` anchors the paged chunked-prefill decisions;
    ``kv_dtype`` rescales every KV-byte term; ``weight_dtype=None`` lets
    :func:`~repro_torch.core.dispatch.find_weight_dtype` pick the GEMM
    weight precision.
    """
    _check(backend, BACKENDS, "backend")
    _check(kv_dtype, KV_DTYPES, "kv_dtype")
    if weight_dtype is None:
        weight_dtype = dispatch.find_weight_dtype(cfg, spec=spec)
    _check(weight_dtype, WEIGHT_DTYPES, "weight_dtype")
    gemm_measure, measure_name = _resolve_measure(
        measure, nk=[(gs.k, gs.n) for gs in dispatch.called_gemm_shapes(cfg)
                     if gs.name == "lm_head_tied"])

    entries: Dict[Tuple[int, int], dispatch.DispatchEntry] = {}
    for gs in tuned_gemm_shapes(cfg):
        entries[(gs.k, gs.n)] = dispatch.find_inflections(
            gs.k, gs.n, measure=gemm_measure, spec=spec)
    # the unseen-shape policy is itself tuned: a representative square
    # [d_model, d_model] workload stands in for shapes the sweep missed
    default = dispatch.find_inflections(
        cfg.d_model, cfg.d_model, measure=gemm_measure, spec=spec)

    scheme = "unified_max" if cfg.softmax_phi.active else "sync"
    rep_seq = min(decode_seq, cfg.max_seq_len)
    block_k = dispatch.find_block_k(rep_seq, cfg.kv_dim,
                                    kv_heads=max(cfg.num_kv_heads, 1),
                                    spec=spec)
    threshold = dispatch.find_chunk_threshold(cfg.num_heads, spec=spec)
    chunk_block = dispatch.find_chunk_block(
        rep_seq, cfg.kv_dim, page_size=page_size, spec=spec,
        kv_dtype=kv_dtype)
    fused_threshold = dispatch.find_fused_threshold(
        rep_seq, cfg.kv_dim, chunk=chunk_block, page_size=page_size,
        spec=spec, kv_dtype=kv_dtype)
    group_threshold = dispatch.find_group_threshold(
        cfg.kv_dim, page_size=page_size, spec=spec, kv_dtype=kv_dtype)
    swap_threshold = dispatch.find_swap_threshold(
        cfg, chunk=chunk_block, page_size=page_size, spec=spec,
        kv_dtype=kv_dtype, weight_dtype=weight_dtype)
    granularity = dispatch.find_decode_fusion(cfg, spec=spec,
                                              weight_dtype=weight_dtype)

    return ExecutionPlan(
        matmul=MatmulPlan(backend=backend, default_m1=default.m1,
                          default_m2=default.m2, entries=entries,
                          weight_dtype=weight_dtype),
        attention_decode=AttentionDecodePlan(
            backend=backend, scheme=scheme, block_k=block_k),
        attention_prefill=AttentionPrefillPlan(
            backend=backend, scheme=scheme, chunk_threshold=threshold),
        fused_ffn=FusedFFNPlan(
            backend=backend,
            fused=backend == "cuda"
            and cfg.activation in ("swiglu", "geglu")),
        paged=PagedPlan(backend=backend, scheme=scheme,
                        gather_chunk="fused",
                        fused_threshold=fused_threshold,
                        chunk_block=chunk_block,
                        decode_group="grouped",
                        group_threshold=group_threshold,
                        swap_threshold=swap_threshold,
                        kv_dtype=kv_dtype),
        decode_fusion=DecodeFusionPlan(backend=backend,
                                       granularity=granularity),
        provenance=PlanProvenance(
            backend=backend,
            hardware=hardware_hash(spec), hardware_name=spec.name,
            config=config_hash(cfg), config_name=cfg.name,
            measure=measure_name),
    )


def default_plan_path(
    cfg: ModelConfig,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    root: str = "plans_torch",
) -> str:
    """The versioned artifact location: ``plans_torch/<arch>-<hw>.json``
    (apart from the JAX package's ``plans/``, whose linter takes only
    the JAX package's backends and hardware)."""
    return os.path.join(root, f"{cfg.name}-{spec.name}.json")
