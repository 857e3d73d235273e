"""T3's cost models and decision flows in the port
(repro_torch.core.dispatch) against the JAX package's (repro.core.dispatch).

Parity runs on a port ``HardwareSpec`` built here from the reference's
``TPU_V5E`` and its module-level time constants (the conversion lives in
this test, not in the package): every ``predict_*`` matches within rtol
1e-12 and every ``find_*`` gives the reference's decision for every
architecture of the registry, at every KV and weight precision. The
structural tests (the paper's Fig. 9 invariants) run on ``H100_SXM``.
"""
import dataclasses
import itertools

import pytest
import torch

from repro import configs as jconfigs
from repro import hardware as jhw
from repro.core import dispatch as jd
from repro_torch import configs as tconfigs
from repro_torch import hardware as thw
from repro_torch.core import dispatch as td
from repro_torch.models.layers import vocab_padded

RTOL = 1e-12
ARCHS = sorted(tconfigs.REGISTRY)
DTYPES = ("bf16", "int8", "fp8")


def tpu_like_spec() -> thw.HardwareSpec:
    """A port spec carrying the reference's TPU v5e numbers: the rates
    and sizes of ``repro.hardware.TPU_V5E``, the reference's time
    constants, its 128-row XLA tile and 1 µs edge. The reference caps the
    decode tile at half of VMEM; the port caps it at ``smem_per_block``."""
    t = jhw.TPU_V5E
    return dataclasses.replace(
        thw.H100_SXM, name="tpu-v5e-like",
        peak_flops_bf16=t.peak_flops_bf16, hbm_bw=t.hbm_bw,
        smem_per_block=t.vmem_bytes // 2,
        peak_flops_f32=t.peak_flops_vpu_f32, host_bw=t.host_bw,
        hbm_bytes=t.hbm_bytes,
        launch_s=jd._PIPELINE_FILL_S,
        kv_step_s=jd._GRID_STEP_OVERHEAD_S,
        chunk_step_s=jd._CHUNK_STEP_OVERHEAD_S,
        host_copy_s=jd._HOST_COPY_LATENCY_S,
        loop_setup_s=jd._LOOP_SETUP_S,
        host_dispatch_s=jd._HOST_DISPATCH_S,
        library_m_tile=128, library_edge_s=1e-6)


SPEC = tpu_like_spec()
IMPLS = [(ti, ji) for ti, ji in zip(td.Impl, jd.Impl)]


def close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0.0), (a, b)


def test_impls_and_constants_match_the_reference():
    assert [i.value for i in td.Impl] == [i.value for i in jd.Impl]
    assert td.M_SWEEP == jd.M_SWEEP
    assert td.BLOCK_K_CANDIDATES == jd.BLOCK_K_CANDIDATES
    assert td.CHUNK_THRESHOLD_CANDIDATES == jd.CHUNK_THRESHOLD_CANDIDATES
    assert td.CHUNK_BLOCK_CANDIDATES == jd.CHUNK_BLOCK_CANDIDATES
    assert td.WEIGHT_DTYPE_CANDIDATES == jd.WEIGHT_DTYPE_CANDIDATES
    assert td.KV_DTYPE_BYTES == jd.KV_DTYPE_BYTES
    assert td.WEIGHT_DTYPE_BYTES == jd.WEIGHT_DTYPE_BYTES
    assert td.WEIGHT_GUARD_TOL == jd.WEIGHT_GUARD_TOL
    assert td._DECODE_STAGES == jd._DECODE_STAGES


def test_weight_guard_tol_mirrors_the_port_quant_guard():
    from repro_torch.kernels import quant
    for name in ("int8", "fp8"):
        assert td.WEIGHT_GUARD_TOL[name] == pytest.approx(
            quant.logits_guard_tol(quant.spec_for(name)))


# ---------------------------------------------------------------------------
# predict_* parity
# ---------------------------------------------------------------------------

MS = (1, 3, 4, 8, 13, 64, 100, 128, 300, 1024)
KNS = ((896, 128), (896, 4864), (4864, 896), (4096, 11008), (896, 152064),
       (17, 23))


@pytest.mark.parametrize("kn", KNS, ids=str)
def test_predict_time_matches_reference(kn):
    k, n = kn
    for (ti, ji), m, db in itertools.product(IMPLS, MS, (2, 4)):
        close(td.predict_time(ti, m, k, n, dtype_bytes=db, spec=SPEC),
              jd.predict_time(ji, m, k, n, dtype_bytes=db))
    for m, wd in itertools.product(MS, DTYPES):
        close(td.predict_flat_gemm_time(m, k, n, weight_dtype=wd, spec=SPEC),
              jd.predict_flat_gemm_time(m, k, n, weight_dtype=wd))


def test_predict_decode_time_matches_reference():
    for bk, s, kv in itertools.product(td.BLOCK_K_CANDIDATES,
                                       (1, 64, 1000, 4096, 32768, 262144),
                                       (128, 1024, 4096, 8192)):
        close(td.predict_decode_time(bk, s, kv, spec=SPEC),
              jd.predict_decode_time(bk, s, kv))


def test_predict_chunk_prefill_time_matches_reference():
    for mode, p, kvd in itertools.product(("dense", "fused"),
                                          (1, 64, 200, 1024, 4096), DTYPES):
        for chunk, page in ((64, 64), (16, 64), (128, 32)):
            close(td.predict_chunk_prefill_time(
                      mode, p, 4096, 1024, chunk=chunk, page_size=page,
                      kv_dtype=kvd, spec=SPEC),
                  jd.predict_chunk_prefill_time(
                      mode, p, 4096, 1024, chunk=chunk, page_size=page,
                      kv_dtype=kvd))


def test_predict_group_decode_time_matches_reference():
    close(td.group_stage_overhead(SPEC), jd.group_stage_overhead(jhw.TPU_V5E))
    close(td.group_stage_overhead(SPEC, batch=2, q_heads=4, head_dim=64),
          jd.group_stage_overhead(jhw.TPU_V5E, batch=2, q_heads=4,
                                  head_dim=64))
    for mode, mem, pre, kvd in itertools.product(
            ("off", "grouped"), (2, 5, 16), (1, 4, 64), DTYPES):
        close(td.predict_group_decode_time(mode, mem, pre, 1, 128,
                                           kv_dtype=kvd, spec=SPEC),
              jd.predict_group_decode_time(mode, mem, pre, 1, 128,
                                           kv_dtype=kvd))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_shapes_and_byte_counts_match_reference(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    assert [dataclasses.astuple(s) for s in td.model_gemm_shapes(tcfg)] == \
        [dataclasses.astuple(s) for s in jd.model_gemm_shapes(jcfg)]
    for kvd, wd in itertools.product(DTYPES, DTYPES):
        assert td.kv_page_bytes(tcfg, kv_dtype=kvd) == \
            jd.kv_page_bytes(jcfg, kv_dtype=kvd)
        assert td.param_bytes(tcfg, wd) == jd.param_bytes(jcfg, wd)
    for pages in (1, 7, 64):
        pb = td.kv_page_bytes(tcfg)
        close(td.predict_swap_time(pages, pb, spec=SPEC),
              jd.predict_swap_time(pages, pb))
    for pos, kvd, wd in itertools.product((64, 640), DTYPES, DTYPES):
        close(td.predict_reprefill_time(tcfg, pos, kv_dtype=kvd,
                                        weight_dtype=wd, spec=SPEC),
              jd.predict_reprefill_time(jcfg, pos, kv_dtype=kvd,
                                        weight_dtype=wd))
    for g, wd in itertools.product(("split", "fused", "looped"), DTYPES):
        close(td.predict_fusion_time(tcfg, g, weight_dtype=wd, spec=SPEC),
              jd.predict_fusion_time(jcfg, g, weight_dtype=wd))


# ---------------------------------------------------------------------------
# find_* parity: every arch, every KV and weight precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_find_flows_match_reference(arch):
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    for gs in jd.model_gemm_shapes(jcfg) + [jd.GemmShape("sq", jcfg.d_model,
                                                         jcfg.d_model)]:
        t = td.find_inflections(gs.k, gs.n, spec=SPEC)
        j = jd.find_inflections(gs.k, gs.n)
        assert (t.k, t.n, t.m1, t.m2) == (j.k, j.n, j.m1, j.m2), gs
    rep = min(32768, jcfg.max_seq_len)
    for s in (64, 1024, rep):
        assert td.find_block_k(s, tcfg.kv_dim, spec=SPEC) == \
            jd.find_block_k(s, jcfg.kv_dim)
    # the tuner's per-kv-head tile changes nothing where the reference's
    # whole-width cap does not bind (every arch of the registry)
    assert td.find_block_k(rep, tcfg.kv_dim, kv_heads=tcfg.num_kv_heads,
                           spec=SPEC) == jd.find_block_k(rep, jcfg.kv_dim)
    assert td.find_chunk_threshold(tcfg.num_heads, spec=SPEC) == \
        jd.find_chunk_threshold(jcfg.num_heads)
    for kvd in DTYPES:
        cb = td.find_chunk_block(rep, tcfg.kv_dim, kv_dtype=kvd, spec=SPEC)
        assert cb == jd.find_chunk_block(rep, jcfg.kv_dim, kv_dtype=kvd)
        assert td.find_fused_threshold(
            rep, tcfg.kv_dim, chunk=cb, kv_dtype=kvd, spec=SPEC) == \
            jd.find_fused_threshold(rep, jcfg.kv_dim, chunk=cb, kv_dtype=kvd)
        assert td.find_group_threshold(tcfg.kv_dim, kv_dtype=kvd,
                                       spec=SPEC) == \
            jd.find_group_threshold(jcfg.kv_dim, kv_dtype=kvd)
        for wd in DTYPES:
            assert td.find_swap_threshold(
                tcfg, chunk=cb, kv_dtype=kvd, weight_dtype=wd,
                spec=SPEC) == jd.find_swap_threshold(
                jcfg, chunk=cb, kv_dtype=kvd, weight_dtype=wd)
    for wd in DTYPES:
        assert td.find_decode_fusion(tcfg, weight_dtype=wd, spec=SPEC) == \
            jd.find_decode_fusion(jcfg, weight_dtype=wd)
    for budget in (None, 0.0, jd.WEIGHT_GUARD_TOL["int8"], 10.0):
        assert td.find_weight_dtype(tcfg, tol_budget=budget, spec=SPEC) == \
            jd.find_weight_dtype(jcfg, tol_budget=budget)


# ---------------------------------------------------------------------------
# The shapes the port's layers call (the reference-fault repair)
# ---------------------------------------------------------------------------


def test_called_shapes_are_the_layers_separate_gemms():
    cfg = tconfigs.get("qwen2-0.5b")
    got = {(s.name, s.k, s.n, s.count) for s in td.called_gemm_shapes(cfg)}
    assert got == {("q_proj", 896, 896, 1), ("kv_proj", 896, 128, 2),
                   ("o_proj", 896, 896, 1), ("gate_up", 896, 4864, 2),
                   ("down", 4864, 896, 1),
                   ("lm_head_tied", 896, vocab_padded(cfg), 1)}
    # the reference's fused-QKV and fused-FFN-up shapes are not called
    called = {(s.k, s.n) for s in td.called_gemm_shapes(cfg)}
    assert (896, 1152) not in called and (896, 9728) not in called
    llama = tconfigs.get("llama2-7b")
    names = {s.name for s in td.called_gemm_shapes(llama)}
    assert "lm_head" in names and "lm_head_tied" not in names
    gelu = tconfigs.get("minitron-8b")
    assert ("up", 4096, 16384, 1) in {
        (s.name, s.k, s.n, s.count) for s in td.called_gemm_shapes(gelu)}
    # MoE: the experts and the router are batched products outside
    # ops.matmul; the untied head runs at the padded vocabulary
    dbrx = tconfigs.get("dbrx-132b")
    assert {(s.name, s.k, s.n, s.count)
            for s in td.called_gemm_shapes(dbrx)} == {
        ("q_proj", 6144, 6144, 1), ("kv_proj", 6144, 1024, 2),
        ("o_proj", 6144, 6144, 1), ("lm_head", 6144, 100352, 1)}
    assert td.called_gemm_shapes(tconfigs.get("rwkv6-1.6b")) == []


# ---------------------------------------------------------------------------
# Structural invariants on the H100 spec (paper §5, Fig. 9)
# ---------------------------------------------------------------------------

H100 = thw.H100_SXM


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 12288), (11008, 4096),
                                (896, 151936), (896, 128), (896, 4864)],
                         ids=str)
def test_inflection_points_ordered(kn):
    e = td.find_inflections(*kn, spec=H100)
    assert 1 <= e.m1 <= e.m2


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 11008), (896, 4864)],
                         ids=str)
def test_pick_is_piecewise_by_m(kn):
    e = td.find_inflections(*kn, spec=H100)
    for m in (1, 2, 5, 16, 33, 100, 511, 1024, 2048):
        impl = e.pick(m)
        if m < e.m1:
            assert impl is td.Impl.GEMV
        elif m < e.m2:
            assert impl is td.Impl.FLAT_GEMM
        else:
            assert impl is td.Impl.XLA_DOT


@pytest.mark.parametrize("spec", [H100, SPEC], ids=["h100", "tpu_like"])
def test_cost_model_limits(spec):
    """GEMV must win at M=1 (paper Fig. 9)."""
    k, n = 4096, 4096
    t_gemv = td.predict_time(td.Impl.GEMV, 1, k, n, spec=spec)
    t_flat = td.predict_time(td.Impl.FLAT_GEMM, 1, k, n, spec=spec)
    assert t_gemv <= t_flat


def test_library_gemm_limit_at_m_1024():
    """At M = 1024 both pads vanish and the two rooflines agree, so the
    fixed costs decide: the reference's 1 µs library edge under its 2 µs
    fill makes ImplC win there; the card's measured library edge (a tiny
    cuBLAS GEMM a call in a graph) exceeds its measured launch (the noop
    probe's), so on H100_SXM the analytical model never reaches ImplC
    and only the wallclock measure routes to cuBLAS."""
    k, n = 4096, 4096
    t_flat = td.predict_time(td.Impl.FLAT_GEMM, 1024, k, n, spec=SPEC)
    t_lib = td.predict_time(td.Impl.XLA_DOT, 1024, k, n, spec=SPEC)
    assert t_lib <= t_flat * 1.01
    t_flat = td.predict_time(td.Impl.FLAT_GEMM, 1024, k, n, spec=H100)
    t_lib = td.predict_time(td.Impl.XLA_DOT, 1024, k, n, spec=H100)
    assert t_lib - t_flat == pytest.approx(
        H100.library_edge_s - H100.launch_s, rel=1e-6)
    assert H100.library_edge_s > H100.launch_s
    assert td.find_inflections(k, n, spec=H100).m2 == td.M_SWEEP[-1] + 1


def test_block_k_monotone_in_sequence_length():
    for kv_dim, heads in ((128, 2), (4096, 32), (1024, 8)):
        prev = 0
        for s in (64, 128, 256, 512, 1024, 4096, 32768, 262144):
            bk = td.find_block_k(s, kv_dim, kv_heads=heads, spec=H100)
            assert bk in td.BLOCK_K_CANDIDATES
            assert bk >= prev, (kv_dim, s, bk, prev)
            prev = bk


def test_block_k_tile_fits_a_block_of_the_card():
    """The whole-width tile of llama2-7b's 32 kv heads fits no block;
    each kv head's own tile does (the card's split kernels)."""
    with pytest.raises(ValueError, match="no feasible block_k"):
        td.find_block_k(32768, 4096, spec=H100)
    bk = td.find_block_k(32768, 4096, kv_heads=32, spec=H100)
    assert 2 * 2 * bk * 128 * 2 <= H100.smem_per_block


def test_chunk_threshold_decision_flow():
    """More heads -> bigger materialized scores -> lower threshold."""
    t_few = td.find_chunk_threshold(4, spec=H100)
    t_many = td.find_chunk_threshold(64, spec=H100)
    assert t_many <= t_few
    assert t_few in td.CHUNK_THRESHOLD_CANDIDATES


def test_measured_backend_hook():
    """A custom measure drives the decision flow."""
    calls = []

    def fake_measure(impl, m, k, n):
        calls.append((impl, m))
        base = {td.Impl.GEMV: 1.0, td.Impl.FLAT_GEMM: 2.0,
                td.Impl.XLA_DOT: 4.0}[impl]
        if impl is td.Impl.FLAT_GEMM and m >= 8:
            base = 0.5
        if impl is td.Impl.XLA_DOT and m >= 128:
            base = 0.1
        return base

    e = td.find_inflections(1024, 1024, measure=fake_measure)
    assert e.m1 == 8 and e.m2 == 128
    assert calls and calls[-1] == (td.Impl.XLA_DOT, 128)


def test_library_gemm_is_asked_only_after_the_flat_gemm_won():
    """find_inflections compares ImplC only once ImplB has beaten ImplA:
    a library GEMM that beats the GEMV at M=1 does not move m2 below
    m1."""
    def measure(impl, m, k, n):
        return {td.Impl.GEMV: 1.0, td.Impl.FLAT_GEMM: 2.0 if m < 16 else 0.5,
                td.Impl.XLA_DOT: 0.1}[impl]

    e = td.find_inflections(64, 64, measure=measure)
    assert (e.m1, e.m2) == (16, 16)


def test_wallclock_measure_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the timer is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        td.wallclock_measure_factory()(td.Impl.GEMV, 1, 64, 64)
