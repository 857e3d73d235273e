"""T3 — heuristic dataflow cost models and decision flows (paper §5).

A transformer has only a few GEMM ``[K, N]`` shapes and only ``M`` (the
number of token rows) varies at run time, so an offline profile per
[K, N] finds two inflection points

    M < M₁            → ImplA  (CUDA-core GEMV — FastGEMV)
    M₁ ≤ M < M₂       → ImplB  (flat GEMM, M padded to 8 — T2)
    M₂ ≤ M            → ImplC  (cuBLAS through ``torch.matmul``)

and the runtime consults a zero-overhead lookup. This module holds the
decision machinery: the per-impl cost models (:func:`predict_time` for
GEMM, :func:`predict_decode_time` for the decode-attention KV walk, and
the chunk, group, swap and fusion models), the sweep flows
(:func:`find_inflections`, :func:`find_block_k`, ...), and the card's
GEMM timer (:func:`wallclock_measure_factory`). The tuned decisions live
in :class:`repro_torch.core.plan.ExecutionPlan`, built by
:func:`repro_torch.core.plan.tune`.

Every model reads its rates, sizes and fixed costs from the
:class:`~repro_torch.hardware.HardwareSpec` it is given (one hashed
record per card); ``measure="wallclock"`` replaces the GEMM model with
CUDA-event timings of the port's own ``gemv`` and ``flat_gemm`` kernels
against ``torch.matmul`` on the card.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterable

from repro_torch import hardware
from repro_torch.config import ModelConfig


class Impl(enum.Enum):
    GEMV = "ImplA"        # CUDA-core GEMV (kernels/gemv.py)
    FLAT_GEMM = "ImplB"   # minimal-pad flat GEMM (kernels/flat_gemm.py)
    XLA_DOT = "ImplC"     # generic library GEMM (torch.matmul / cuBLAS)


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One [K, N] workload; ``count`` = occurrences per layer."""

    name: str
    k: int
    n: int
    count: int = 1


def model_gemm_shapes(cfg: ModelConfig) -> list[GemmShape]:
    """The paper's 'only four [K,N] shapes' — extracted per architecture.

    These are the JAX package's shapes, kept as they are because
    :func:`param_bytes` and the fusion / swap / precision models sum over
    them: QKV and the gated FFN-up count as one fused projection each.
    The layers call q, k, v, gate and up as separate GEMMs, so the
    shapes ``ops.matmul`` actually sees are :func:`called_gemm_shapes`.
    """
    d = cfg.d_model
    shapes = [
        GemmShape("qkv_proj", d, cfg.q_dim + 2 * cfg.kv_dim),
        GemmShape("o_proj", cfg.q_dim, d),
    ]
    gates = 2 if cfg.activation in ("swiglu", "geglu") else 1
    if cfg.family == "moe" and cfg.moe is not None:
        shapes += [
            GemmShape("router", d, cfg.moe.num_experts),
            GemmShape("expert_up", d, gates * cfg.d_ff, cfg.moe.num_experts),
            GemmShape("expert_down", cfg.d_ff, d, cfg.moe.num_experts),
        ]
    else:
        shapes += [
            GemmShape("ffn_up", d, gates * cfg.d_ff),
            GemmShape("ffn_down", cfg.d_ff, d),
        ]
    if cfg.family == "ssm":
        shapes += [GemmShape("rkvg_proj", d, 4 * d)]
    shapes += [GemmShape("lm_head", d, cfg.vocab_size)]
    return shapes


# families whose layers the port has (models/api.py refuses the others)
PORTED_FAMILIES = ("dense", "vlm", "moe")


def called_gemm_shapes(cfg: ModelConfig) -> list[GemmShape]:
    """The [K, N] shapes the port's layers pass to ``ops.matmul``:
    q, k / v, o_proj, gate / up (or up alone, ungated), down, and the
    head at the padded vocabulary the embedding is stored at (tied:
    ``embedding.T``, an (N, K) view). The MoE family's experts and router
    are batched products outside ``ops.matmul`` (as the JAX package's are
    einsums outside its GEMM kernels), so it calls q, k / v, o_proj and
    the head only. A family without port layers calls none yet. The
    tuner gives each of these an entry, so no call falls to the plan's
    default ladder."""
    if cfg.family not in PORTED_FAMILIES:
        return []
    # models.layers imports the ops, which import the plan and so this
    # module: import it here, not at the top
    from repro_torch.models.layers import vocab_padded
    d = cfg.d_model
    gated = cfg.activation in ("swiglu", "geglu")
    shapes = [
        GemmShape("q_proj", d, cfg.q_dim),
        GemmShape("kv_proj", d, cfg.kv_dim, 2),
        GemmShape("o_proj", cfg.q_dim, d),
    ]
    if cfg.family != "moe":
        shapes += [GemmShape("gate_up" if gated else "up", d, cfg.d_ff,
                             2 if gated else 1),
                   GemmShape("down", cfg.d_ff, d)]
    return shapes + [
        GemmShape("lm_head_tied" if cfg.tie_embeddings else "lm_head", d,
                  vocab_padded(cfg))]


# ---------------------------------------------------------------------------
# Analytical cost model. All times in seconds for one GEMM call.
# ---------------------------------------------------------------------------

# bytes per stored KV element by ``PagedPlan.kv_dtype`` — every KV-stream
# roofline term below scales by this, which is how quantized pages shift
# the fused/group/swap inflections (smaller pages, cheaper reads).
# Quantized pools also carry one f32 step per (page, kv head);
# :func:`kv_page_bytes` accounts those exactly, the stream terms fold
# them in as negligible (4 bytes vs page_size*head_dim codes).
KV_DTYPE_BYTES = {"bf16": 2.0, "int8": 1.0, "fp8": 1.0}

# bytes per stored GEMM weight element by ``MatmulPlan.weight_dtype`` —
# the weight-stream twin of :data:`KV_DTYPE_BYTES`. Decode-phase GEMMs
# are flat (M = batch) and memory-bound on the K×N weight read, so this
# factor scales the dominant term of every decode roofline; quantized
# weights also carry one f32 step per output channel, which
# :func:`param_bytes` and :func:`predict_flat_gemm_time` account exactly.
WEIGHT_DTYPE_BYTES = {"bf16": 2.0, "int8": 1.0, "fp8": 1.0}

# dtype-derived logits-closeness tolerance per weight_dtype — the
# plain-number mirror of ``kernels.quant.logits_guard_tol`` over
# ``quant.spec_for`` (this module stays free of the kernels; a test
# holds the two together). ``"bf16"`` is the bitwise path: zero budget.
WEIGHT_GUARD_TOL = {
    "bf16": 0.0,
    "int8": 64 * (0.5 / 127.0),
    "fp8": 64 * 2.0 ** -4,
}

# the flat GEMM pads M to one 8-row atom (T2: "pad to 8, not 64")
FLAT_M_ATOM = 8


def _mem_time(m_eff: int, k: int, n: int, dtype_bytes: int,
              spec: hardware.HardwareSpec) -> float:
    """Device-memory traffic with the *effective* (padded) M — a padded
    layout reads and writes the padding too, which is the paper's >50 %
    under-utilization argument restated as memory traffic."""
    bytes_moved = (m_eff * k + k * n + m_eff * n) * dtype_bytes
    return bytes_moved / spec.hbm_bw


def predict_time(
    impl: Impl, m: int, k: int, n: int, *,
    dtype_bytes: int = 2,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline-style time estimate for one (M,K,N) GEMM per implementation.

    The models encode the paper's Eq. 5 structure:
      * ImplA: CUDA-core math (``spec.peak_flops_f32``), no M padding at
        all — wins only while the workload is so flat that the weight
        read dominates even the slow cores.
      * ImplB: tensor cores with M padded to the 8-row atom; both compute
        and traffic use M_pad=⌈M/8⌉·8, plus one launch
        (``spec.launch_s``).
      * ImplC: the library GEMM tiles M to ``spec.library_m_tile``;
        compute *and traffic* pay the padded M — unbeatable once M fills
        the tile, mostly wasted at M=8 (the paper's cuBLAS 'pad to 64'
        criticism) — plus its fixed edge ``spec.library_edge_s``.
    """
    if impl is Impl.GEMV:
        mem = _mem_time(m, k, n, dtype_bytes, spec)
        compute = 2.0 * m * k * n / spec.peak_flops_f32
        return max(mem, compute)
    if impl is Impl.FLAT_GEMM:
        m_pad = max(FLAT_M_ATOM, -(-m // FLAT_M_ATOM) * FLAT_M_ATOM)
        mem = _mem_time(m_pad, k, n, dtype_bytes, spec)
        compute = 2.0 * m_pad * k * n / spec.peak_flops_bf16
        return max(mem, compute) + spec.launch_s
    if impl is Impl.XLA_DOT:
        tile = spec.library_m_tile
        m_pad = max(tile, -(-m // tile) * tile)
        mem = _mem_time(m_pad, k, n, dtype_bytes, spec)
        compute = 2.0 * m_pad * k * n / spec.peak_flops_bf16
        return max(mem, compute) + spec.library_edge_s
    raise ValueError(impl)


def predict_flat_gemm_time(
    m: int, k: int, n: int, *,
    weight_dtype: str = "bf16",
    dtype_bytes: int = 2,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """ImplB roofline with the weight stream priced at its stored width.

    Equal to ``predict_time(Impl.FLAT_GEMM, ...)`` at
    ``weight_dtype="bf16"``. Quantized dtypes shrink only the K×N weight
    term (:data:`WEIGHT_DTYPE_BYTES`) and add the (N,) f32
    per-output-channel step read — exactly the operands the quantized
    kernel streams; the activation read and output write keep
    ``dtype_bytes``. The compute term is unchanged: the step rides the
    f32 accumulator and the codes feed the tensor cores as bf16.
    """
    wb = WEIGHT_DTYPE_BYTES[weight_dtype]
    m_pad = max(FLAT_M_ATOM, -(-m // FLAT_M_ATOM) * FLAT_M_ATOM)
    scale_bytes = 0 if weight_dtype == "bf16" else n * 4
    bytes_moved = ((m_pad * k + m_pad * n) * dtype_bytes
                   + k * n * wb + scale_bytes)
    mem = bytes_moved / spec.hbm_bw
    compute = 2.0 * m_pad * k * n / spec.peak_flops_bf16
    return max(mem, compute) + spec.launch_s


MeasureFn = Callable[[Impl, int, int, int], float]


def wallclock_measure_factory(*, warmup: int = 3, iters: int = 25,
                              nk: Iterable[tuple[int, int]] = ()
                              ) -> MeasureFn:
    """The card's GEMM timer: ``measure(impl, m, k, n) -> seconds``.

    ImplA runs ``kernels.gemv.gemv``, ImplB ``kernels.flat_gemm.flat_gemm``
    and ImplC ``torch.matmul``, on bf16 operands drawn from two
    independent ``torch.Generator`` seeds (a shared stream would correlate
    x and w). After ``warmup`` calls, each of ``iters`` timed calls runs
    between CUDA events with the L2 cache flushed before it (the serving
    path finds its weights cold), all queued behind a device-side sleep
    so that the events time the card, not the host's launches (the
    ``chip_smoke.py`` timer's discipline); the median is returned. A (K, N) in
    ``nk`` is timed on the transposed view of a row-major (N, K) weight,
    the layout the tied head runs on. Raises without CUDA: no CPU timing
    stands in for the card's.
    """
    import statistics
    import time

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "wallclock_measure_factory times the card's kernels and needs "
            "CUDA; use measure='analytical' on a machine without it")
    from repro_torch.kernels.flat_gemm import flat_gemm
    from repro_torch.kernels.gemv import gemv

    nk = frozenset(nk)
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    weights: dict[tuple[int, int], torch.Tensor] = {}
    fns = {Impl.GEMV: gemv, Impl.FLAT_GEMM: flat_gemm,
           Impl.XLA_DOT: torch.matmul}

    def weight(k: int, n: int) -> torch.Tensor:
        if (k, n) not in weights:
            weights.clear()              # one weight resident at a time
            gen = torch.Generator(device=dev).manual_seed(1)
            shape = (n, k) if (k, n) in nk else (k, n)
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            weights[(k, n)] = w.T if (k, n) in nk else w
        return weights[(k, n)]

    def measure(impl: Impl, m: int, k: int, n: int) -> float:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((m, k), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        w, fn = weight(k, n), fns[impl]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(warmup):
            fn(x, w)
        host_s = (time.perf_counter() - t0) / warmup
        events = []
        # a device-side sleep queued first (cycles at ~2 GHz, twice the
        # host's enqueue time) lets the host queue every timed call before
        # the card reaches them: the events then bound device time only,
        # not the host's launch cost (the wrappers' ctypes calls cost more
        # host time than torch.matmul's)
        queue_s = max(0.05, 2 * iters * (host_s + 2e-5))
        torch.cuda._sleep(int(2e9 * queue_s))
        for _ in range(iters):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x, w)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return 1e-3 * statistics.median(s.elapsed_time(e)
                                        for s, e in events)

    return measure


# ---------------------------------------------------------------------------
# Offline decision flows (paper Fig. 9(b)) → plan entries
# ---------------------------------------------------------------------------

M_SWEEP = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 1024)


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


def find_inflections(
    k: int, n: int, *,
    measure: MeasureFn | None = None,
    m_sweep: Iterable[int] = M_SWEEP,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> DispatchEntry:
    """The paper's decision flow: sweep M, find M₁ (A→B) and M₂ (B→C).

    ImplC is compared only once ImplB has beaten ImplA: below M₁ the
    flow does not ask whether the library GEMM beats the GEMV."""
    measure = measure or (
        lambda impl, m, kk, nn: predict_time(impl, m, kk, nn, spec=spec)
    )
    ms = sorted(m_sweep)
    m1 = ms[-1] + 1
    m2 = ms[-1] + 1
    found1 = False
    for m in ms:
        ta = measure(Impl.GEMV, m, k, n)
        tb = measure(Impl.FLAT_GEMM, m, k, n)
        tc = measure(Impl.XLA_DOT, m, k, n)
        if not found1 and tb < ta:
            m1, found1 = m, True
        if found1 and tc < tb:
            m2 = m
            break
    return DispatchEntry(k=k, n=n, m1=m1, m2=max(m2, m1))


# ---------------------------------------------------------------------------
# Decode-attention block_k decision flow (find_inflections beyond GEMM)
# ---------------------------------------------------------------------------

BLOCK_K_CANDIDATES = (128, 256, 512, 1024, 2048)


def predict_decode_time(
    block_k: int, s: int, kv_dim: int, *,
    dtype_bytes: int = 2,
    kv_heads: int = 1,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time for one decode-attention call at KV length ``s``.

    The walk covers ``ceil(s / block_k)`` KV tiles; each tile streams K
    and V rows (padding included — a tile past ``s`` is still read), so
    a large ``block_k`` amortizes the per-step cost ``spec.kv_step_s``
    but pays padded traffic when ``s`` is short. A block's
    double-buffered K + V tile must fit the shared memory one block may
    claim; with ``kv_heads`` > 1 each kv head has blocks of its own (the
    card's split kernels), so the tile spans ``kv_dim / kv_heads``
    columns. On the card ``block_k`` shapes only the plain versions
    (split-KV walks fixed 64-key splits); it is tuned for schema parity.
    """
    steps = -(-s // block_k)
    rows = steps * block_k
    mem = 2 * rows * kv_dim * dtype_bytes / spec.hbm_bw      # K + V streams
    tile = 2 * 2 * block_k * (kv_dim // kv_heads) * dtype_bytes
    if tile > spec.smem_per_block:
        return float("inf")
    return mem + steps * spec.kv_step_s


def find_block_k(
    s: int, kv_dim: int, *,
    kv_heads: int = 1,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    candidates: Iterable[int] = BLOCK_K_CANDIDATES,
) -> int:
    """Pick the decode KV block for a representative KV length."""
    best, best_t = None, float("inf")
    for bk in sorted(candidates):
        t = predict_decode_time(bk, s, kv_dim, kv_heads=kv_heads, spec=spec)
        if t < best_t:
            best, best_t = bk, t
    if best is None:
        raise ValueError(f"no feasible block_k among {tuple(candidates)}")
    return best


# ---------------------------------------------------------------------------
# Prefill chunking-threshold decision flow
# ---------------------------------------------------------------------------

CHUNK_THRESHOLD_CANDIDATES = (1024, 2048, 4096, 8192, 16384, 32768)


def find_chunk_threshold(
    num_heads: int, *,
    dtype_bytes: int = 4,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    budget_frac: float = 0.25,
) -> int:
    """Largest sequence length whose materialized per-sequence (H, S, S)
    f32 score tensor still fits a ``budget_frac`` slice of device memory;
    beyond it the blockwise T1 scheme must take over (live memory ≈
    (H, Bq, S))."""
    budget = spec.hbm_bytes * budget_frac
    best = CHUNK_THRESHOLD_CANDIDATES[0]
    for s in CHUNK_THRESHOLD_CANDIDATES:
        if num_heads * s * s * dtype_bytes <= budget:
            best = s
    return best


# ---------------------------------------------------------------------------
# Paged chunked-prefill decision flows: dense-gather vs fused chunk kernel
# (find_inflections for the admission path)
# ---------------------------------------------------------------------------

CHUNK_BLOCK_CANDIDATES = (8, 16, 32, 64, 128, 256)


def predict_chunk_prefill_time(
    mode: str, prompt_len: int, table_positions: int, kv_dim: int, *,
    chunk: int = 64,
    page_size: int = 64,
    dtype_bytes: int = 2,
    kv_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time for the *KV side* of one whole chunked-prefill
    admission of a ``prompt_len`` prompt (the q-side GEMMs are identical
    across modes and cancel out of the decision).

    ``mode="dense"`` gathers the full ``(table_positions,)`` KV view per
    chunk step per K/V: each step reads the pool pages, writes the dense
    view, and reads it back for attention — 3x the table bytes, every
    step, regardless of how little of the table is resident. Under a
    quantized ``kv_dtype`` only the pool read shrinks; the materialized
    view is dequantized, so its write + readback stay full-precision —
    which is why quantization pushes the fused inflection *down*.

    ``mode="fused"`` reads only the pages covering ``resident + chunk``
    in place (block tables, no materialization, dequant in-kernel — all
    traffic at ``kv_dtype`` width), paying a per-page step cost
    (``spec.kv_step_s``) instead. Both pay ``spec.chunk_step_s`` per
    chunk step.
    """
    kvb = KV_DTYPE_BYTES[kv_dtype]
    steps = max(-(-prompt_len // chunk), 1)
    if mode == "dense":
        # K + V: pool read (stored width) + dense-view write + attention
        # read (dequantized width), per step
        bytes_per_step = (2 * table_positions * kv_dim
                          * (kvb + 2 * dtype_bytes))
        return steps * (bytes_per_step / spec.hbm_bw + spec.chunk_step_s)
    if mode == "fused":
        total = 0.0
        for i in range(steps):
            resident = min((i + 1) * chunk, prompt_len)
            pages = -(-resident // page_size)
            bytes_step = 2 * pages * page_size * kv_dim * kvb
            total += (bytes_step / spec.hbm_bw
                      + pages * spec.kv_step_s
                      + spec.chunk_step_s)
        return total
    raise ValueError(f"unknown chunk mode {mode!r}")


def find_fused_threshold(
    max_seq: int, kv_dim: int, *,
    chunk: int = 64,
    page_size: int = 64,
    kv_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> int:
    """Smallest prompt length at which the fused chunk path beats the
    dense gather (table provisioned at ``max_seq``); prompts below it keep
    the full-table gather. Returns ``max_seq + 1`` when the gather never
    loses (tiny tables). Quantized ``kv_dtype`` lowers the inflection:
    the fused path's traffic is all stored-width while the dense gather
    still pays full-precision view bytes."""
    p = chunk
    while p <= max_seq:
        t_dense = predict_chunk_prefill_time(
            "dense", p, max_seq, kv_dim, chunk=chunk, page_size=page_size,
            kv_dtype=kv_dtype, spec=spec)
        t_fused = predict_chunk_prefill_time(
            "fused", p, max_seq, kv_dim, chunk=chunk, page_size=page_size,
            kv_dtype=kv_dtype, spec=spec)
        if t_fused < t_dense:
            return p
        p *= 2
    return max_seq + 1


def find_chunk_block(
    max_seq: int, kv_dim: int, *,
    page_size: int = 64,
    kv_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    candidates: Iterable[int] = CHUNK_BLOCK_CANDIDATES,
) -> int:
    """Pick the prefill chunk size for the fused path at a representative
    (``max_seq``-long) admission: large chunks amortize the per-step
    cost, small chunks keep early pages from re-streaming. Only sizes
    that divide the page size are eligible — prefix sharing needs every
    chunk boundary on the page grid (``page_size % prefill_chunk == 0``,
    enforced by the engine)."""
    best, best_t = None, float("inf")
    for c in sorted(candidates):
        if page_size % c:
            continue
        t = predict_chunk_prefill_time(
            "fused", max_seq, max_seq, kv_dim, chunk=c,
            page_size=page_size, kv_dtype=kv_dtype, spec=spec)
        if t < best_t:
            best, best_t = c, t
    if best is None:
        raise ValueError(
            f"no chunk size among {tuple(candidates)} sits on the "
            f"page grid (page_size {page_size})")
    return best


# ---------------------------------------------------------------------------
# Grouped-decode decision flow: per-row prefix reads vs one read per group
# (find_inflections for the shared-prefix decode path)
# ---------------------------------------------------------------------------

def group_stage_overhead(
    spec: hardware.HardwareSpec = hardware.DEFAULT, *,
    batch: int = 8, q_heads: int = 16, head_dim: int = 128,
) -> float:
    """Fixed cost of the extra grouped-attention stage per decode step:
    one extra kernel launch (``spec.launch_s`` — stage 1 is a launch the
    ungrouped path does not pay) plus the device-memory round trip of
    the merge partials the split introduces (stage 1 writes, stage 2
    reads, one ``(batch, q_heads, head_dim + 2)`` f32 record per row —
    accumulator plus the unified-max merge's running (max, sum) pair).
    The defaults are the shape the group-threshold sweep targets (steady
    decode: a full slot batch, a qwen2-class head shape)."""
    partial_bytes = batch * q_heads * (head_dim + 2) * 4
    return spec.launch_s + 2 * partial_bytes / spec.hbm_bw


def predict_group_decode_time(
    mode: str, members: int, prefix_pages: int, tail_pages: int,
    kv_dim: int, *,
    page_size: int = 64,
    dtype_bytes: int = 2,
    kv_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time for the KV side of one decode step over one
    shared-prefix group (the q-side work is identical across modes and
    cancels out of the decision). ``kv_dtype`` scales the page bytes both
    modes stream (both read stored-width pages and dequantize in
    registers), so quantization shrinks the absolute gap but leaves the
    fixed stage cost — grouped needs more members/pages to win.

    ``mode="off"`` streams every member's full table: each of the
    ``members`` rows re-reads the ``prefix_pages`` it shares plus its own
    ``tail_pages``.

    ``mode="grouped"`` reads the shared prefix **once** (stage 1, one
    pass per group) and only the private tails per member (stage 2),
    paying the extra stage's fixed cost (:func:`group_stage_overhead` on
    ``spec``) — the unified-max merge is what makes the split free of a
    per-member rescale pass.
    """
    del dtype_bytes  # superseded by the kv_dtype stored-width scaling
    page_bytes = 2 * page_size * kv_dim * KV_DTYPE_BYTES[kv_dtype]  # K + V
    if mode == "off":
        pages = members * (prefix_pages + tail_pages)
        return (pages * page_bytes / spec.hbm_bw
                + pages * spec.kv_step_s)
    if mode == "grouped":
        pages = prefix_pages + members * tail_pages
        return (pages * page_bytes / spec.hbm_bw
                + pages * spec.kv_step_s
                + group_stage_overhead(spec))
    raise ValueError(f"unknown group mode {mode!r}")


def find_group_threshold(
    kv_dim: int, *,
    page_size: int = 64,
    max_members: int = 64,
    max_prefix_pages: int = 64,
    tail_pages: int = 1,
    kv_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> int:
    """Smallest ``members * prefix_pages`` product at which grouped
    decode beats per-row prefix re-reads — the dispatch floor the slot
    manager's group plan applies per group each tick. Sweeps the
    (members, prefix pages) grid at one private tail page (the
    steady-decode shape); returns a sentinel above the sweep when the
    grouped path never wins (the stage cost dominates tiny pools)."""
    best = None
    for members in range(2, max_members + 1):
        pages = 1
        while pages <= max_prefix_pages:
            t_off = predict_group_decode_time(
                "off", members, pages, tail_pages, kv_dim,
                page_size=page_size, kv_dtype=kv_dtype, spec=spec)
            t_grp = predict_group_decode_time(
                "grouped", members, pages, tail_pages, kv_dim,
                page_size=page_size, kv_dtype=kv_dtype, spec=spec)
            if t_grp < t_off:
                work = members * pages
                if best is None or work < best:
                    best = work
            pages *= 2
    return best if best is not None else max_members * max_prefix_pages + 1


# ---------------------------------------------------------------------------
# Tiered-KV swap decision flow: promote demoted pages vs re-prefill them
# (find_inflections for the session-cache re-admission path)
# ---------------------------------------------------------------------------


def kv_page_bytes(cfg: ModelConfig, *, page_size: int = 64,
                  dtype_bytes: int = 2, kv_dtype: str = "bf16") -> int:
    """Bytes one KV page moves across the host link: K + V for every
    layer (the page id is shared across layers, so a demotion/promotion
    always moves the whole per-layer stack). Quantized dtypes store
    codes at stored width plus one f32 step per (page, kv head, layer,
    K/V) — the exact slab a tier demotion carries."""
    del dtype_bytes  # superseded by the kv_dtype stored-width scaling
    kvb = KV_DTYPE_BYTES[kv_dtype]
    scale = 0 if kv_dtype == "bf16" else cfg.num_kv_heads * 4
    return int(2 * cfg.num_layers
               * (page_size * cfg.kv_dim * kvb + scale))


def param_bytes(cfg: ModelConfig, weight_dtype: str = "bf16", *,
                dtype_bytes: int = 2) -> int:
    """Resident bytes of the model's per-layer GEMM weight stream at a
    storage precision — the weight-side analog of :func:`kv_page_bytes`.

    Sums every per-layer [K, N] shape of :func:`model_gemm_shapes` across
    the layer stack: codes at stored width (:data:`WEIGHT_DTYPE_BYTES`)
    plus the (N,) f32 per-output-channel steps when quantized.
    ``lm_head`` (and the tied embedding) is excluded — it is not a
    per-layer stream and never quantizes.
    """
    wb = WEIGHT_DTYPE_BYTES[weight_dtype]
    total = 0.0
    for gs in model_gemm_shapes(cfg):
        if gs.name == "lm_head":
            continue
        if weight_dtype == "bf16":
            per = gs.k * gs.n * dtype_bytes
        else:
            per = gs.k * gs.n * wb + gs.n * 4
        total += per * gs.count
    return int(total * cfg.num_layers)


def predict_swap_time(
    pages: int, page_bytes: int, *,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time to promote ``pages`` demoted KV pages back to the
    device pool: one bulk host→device copy over the host link plus its
    fixed cost (``spec.host_copy_s``)."""
    return spec.host_copy_s + pages * page_bytes / spec.host_bw


def predict_reprefill_time(
    cfg: ModelConfig, positions: int, *,
    chunk: int = 64,
    page_size: int = 64,
    dtype_bytes: int = 2,
    kv_dtype: str = "bf16",
    weight_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time to *recompute* ``positions`` KV positions through
    the chunked-prefill path — the cost a re-admission pays for every
    span whose pages were not (or could not be) promoted.

    Sums the model's GEMM work per chunk step (best implementation per
    [K, N] shape, per layer; lm_head once per step) with the fused-path
    attention KV streaming per layer and the per-step cost — the same
    per-term constants every other flow in this module uses, so the swap
    decision is commensurable with the chunk/group decisions. Under a
    quantized ``weight_dtype`` the per-layer GEMMs stream the smaller
    stored-width weights (:func:`predict_flat_gemm_time`; the lm_head
    stays bf16), so recompute gets cheaper and swapping needs a longer
    span to win.
    """
    steps = max(-(-positions // chunk), 1)
    gemm_step = 0.0
    for gs in model_gemm_shapes(cfg):
        if weight_dtype != "bf16" and gs.name != "lm_head":
            t = predict_flat_gemm_time(
                chunk, gs.k, gs.n, weight_dtype=weight_dtype,
                dtype_bytes=dtype_bytes, spec=spec)
        else:
            t = min(predict_time(impl, chunk, gs.k, gs.n,
                                 dtype_bytes=dtype_bytes, spec=spec)
                    for impl in Impl)
        layers = 1 if gs.name == "lm_head" else cfg.num_layers
        gemm_step += t * gs.count * layers
    kv = 0.0
    for i in range(steps):
        resident = min((i + 1) * chunk, positions)
        pages = -(-resident // page_size)
        kv += (2 * pages * page_size * cfg.kv_dim
               * KV_DTYPE_BYTES[kv_dtype]
               / spec.hbm_bw + pages * spec.kv_step_s)
    return (steps * gemm_step + cfg.num_layers * kv
            + steps * spec.chunk_step_s)


def find_swap_threshold(
    cfg: ModelConfig, *,
    chunk: int = 64,
    page_size: int = 64,
    max_pages: int = 64,
    kv_dtype: str = "bf16",
    weight_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> int:
    """Smallest demoted-span page count at which promoting (bulk
    host→device copy) beats re-prefilling the same span — the
    per-admission decision the slot manager applies to a prefix match
    that extends into the tiered store (``PagedPlan.swap_threshold``).
    Returns ``max_pages + 1`` when the copy never wins inside the sweep.
    Quantized ``kv_dtype`` moves *both* sides (smaller slabs over the
    link, cheaper KV re-streaming) but the link side scales fully while
    re-prefill keeps its bf16 GEMM term, so swapping wins earlier; a
    quantized ``weight_dtype`` pushes the other way."""
    page_bytes = kv_page_bytes(cfg, page_size=page_size, kv_dtype=kv_dtype)
    for pages in range(1, max_pages + 1):
        t_swap = predict_swap_time(pages, page_bytes, spec=spec)
        t_pre = predict_reprefill_time(
            cfg, pages * page_size, chunk=chunk, page_size=page_size,
            kv_dtype=kv_dtype, weight_dtype=weight_dtype, spec=spec)
        if t_swap < t_pre:
            return pages
    return max_pages + 1


# ---------------------------------------------------------------------------
# Decode-fusion granularity (DecodeFusionPlan.granularity)
# ---------------------------------------------------------------------------

# per-layer stage launches in one decode tick. The split chain is the
# full op list (norm, 3 QKV GEMMs, bias, 2 ropes, 2 KV writes,
# attention, o_proj, residual, mlp norm, gate/up GEMMs, activation,
# down GEMM, residual); fusing the ingest seam (norm+QKV+rope), the
# attention epilogue (o_proj+residual), the mlp ingest
# (norm+gate/up+activation) and the down-projection epilogue
# (down+residual) collapses it to: ingest, 2 writes, attention,
# epilogue, ffn_norm, down-epilogue.
_DECODE_STAGES = {"split": 16, "fused": 7, "looped": 7}


def predict_fusion_time(
    cfg: ModelConfig, granularity: str, *,
    m: int = 1,
    dtype_bytes: int = 2,
    weight_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> float:
    """Roofline time for one decode tick at a fusion granularity.

    Decode at small batch is memory-bound: every tick streams each
    layer's weights once regardless of granularity (:func:`param_bytes`
    at the plan's ``weight_dtype``), and the granularities differ only in
    *boundary* cost — stage launches per layer (:data:`_DECODE_STAGES`,
    priced at ``spec.launch_s``), plus the host-side term: ``fused``
    pays ``spec.host_dispatch_s`` for each of its L × stages host
    launches, while ``split`` and ``looped`` pay one
    ``spec.loop_setup_s`` (the reference's single scan'd dispatch; the
    port's looped tick is one CUDA-graph replay, its split chain an
    eager Python loop that this model, like the reference's, prices as
    one dispatch).
    """
    if granularity not in _DECODE_STAGES:
        raise ValueError(f"unknown fusion granularity {granularity!r}")
    weight_bytes = param_bytes(
        cfg, weight_dtype, dtype_bytes=dtype_bytes) / cfg.num_layers
    stages = _DECODE_STAGES[granularity]
    t_layer = weight_bytes / spec.hbm_bw + stages * spec.launch_s
    if granularity == "fused":
        return cfg.num_layers * (t_layer + stages * spec.host_dispatch_s)
    return cfg.num_layers * t_layer + spec.loop_setup_s


def find_decode_fusion(
    cfg: ModelConfig, *,
    m: int = 1,
    weight_dtype: str = "bf16",
    spec: hardware.HardwareSpec = hardware.DEFAULT,
) -> str:
    """Cheapest decode-tick granularity for this model (ties break toward
    the earlier, simpler mode: split < fused < looped)."""
    modes = ("split", "fused", "looped")
    times = {g: predict_fusion_time(cfg, g, m=m, weight_dtype=weight_dtype,
                                    spec=spec) for g in modes}
    return min(modes, key=lambda g: times[g])


# ---------------------------------------------------------------------------
# Weight-precision decision flow (MatmulPlan.weight_dtype)
# ---------------------------------------------------------------------------

WEIGHT_DTYPE_CANDIDATES = ("bf16", "int8", "fp8")


def find_weight_dtype(
    cfg: ModelConfig, *,
    m: int = 1,
    tol_budget: float | None = None,
    spec: hardware.HardwareSpec = hardware.DEFAULT,
    candidates: Iterable[str] = WEIGHT_DTYPE_CANDIDATES,
) -> str:
    """Fastest GEMM weight storage precision under the accuracy guard.

    Candidates whose dtype-derived logits tolerance
    (:data:`WEIGHT_GUARD_TOL`) exceeds ``tol_budget`` are excluded
    (``None`` = any tolerance; ``0.0`` admits only the bitwise bf16
    path). Survivors are ranked by one decode tick's flat-GEMM roofline
    summed over the model's [K, N] shapes at decode M
    (:func:`predict_flat_gemm_time`; the lm_head prices at bf16 — it
    never quantizes). Decode is weight-bandwidth-bound, so the smaller
    stream wins whenever it is admissible; the strict ``<`` keeps int8
    ahead of fp8 on their byte-for-byte tie.
    """
    best, best_t = "bf16", None
    for wd in candidates:
        if wd not in WEIGHT_DTYPE_BYTES:
            raise ValueError(f"unknown weight_dtype {wd!r}")
        if tol_budget is not None and WEIGHT_GUARD_TOL[wd] > tol_budget:
            continue
        t = 0.0
        for gs in model_gemm_shapes(cfg):
            shape_wd = "bf16" if gs.name == "lm_head" else wd
            layers = 1 if gs.name == "lm_head" else cfg.num_layers
            t += (predict_flat_gemm_time(
                      m, gs.k, gs.n, weight_dtype=shape_wd, spec=spec)
                  * gs.count * layers)
        if best_t is None or t < best_t:
            best, best_t = wd, t
    return best
