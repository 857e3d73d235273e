"""The port's quantized GEMM weights on CPU tensors, against the JAX
package on the same numpy inputs, for int8 and fp8 e4m3:

  * ``models/wquant.py``: codes and steps bitwise the reference's (codes
    compared as uint8, steps as uint32), only ``WEIGHT_KEYS`` quantizing,
    and the same stored byte count; ``params_from_numpy`` carrying a
    quantized reference tree (fp8 included) bit for bit;
  * every quantized plain version (rows 1, 2, 8, 12, 13 and 14 of the
    kernel table) against the JAX package's Pallas kernel with its scale
    operands, run with ``interpret=True`` as its own tests run it, within
    ``TOL["bfloat16"]``, at K and N that are not multiples of the blocks;
  * the ``ops`` front doors routing a ``{"codes", "scale"}`` leaf to the
    quantized GEMV, flat GEMM and XLA-dot paths and on ``"torch"``;
  * ``MatmulPlan.weight_dtype``, ``make_plan(weight_dtype=)``, and
    ``Engine(weight_dtype=)``'s precedence, refusals and byte count;
  * greedy tokens of the quantized engine equal to the JAX quantized
    engine's (dense and paged with sharing, split / fused / looped; f32
    activations, so that no bf16 near-tie decides a token); bf16 tokens
    unchanged by the knob; the logits guard against bf16; the serve
    CLI's ``--weight-dtype``.

The CUDA kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import decode_fuse as jdf
from repro.kernels import quant as jq
from repro.kernels.flat_gemm import flat_gemm as jflat_gemm
from repro.kernels.fused_ffn import fused_ffn_up as jfused_ffn_up
from repro.kernels.gemv import gemv as jgemv
from repro.models import wquant as jw
from repro.models.api import get_model as jget_model
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.core.plan import (WEIGHT_DTYPES, MatmulPlan, PlanError,
                                   make_plan)
from repro_torch.kernels import decode_fuse as tdf
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tq
from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_plain
from repro_torch.kernels.fused_ffn import fused_ffn_up, fused_ffn_up_plain
from repro_torch.kernels.gemv import gemv, gemv_plain
from repro_torch.models import wquant as tw
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

ARCH = "qwen2-0.5b"
SPECS = [(jq.INT8, tq.INT8), (jq.FP8, tq.FP8)]
IDS = ["int8", "fp8"]
BF16 = TOL["bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs it in
    parallel workers beside other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _qpair(w: np.ndarray, specs):
    """A bf16 weight quantized by both packages: (JAX leaf, port leaf)."""
    js, ts = specs
    jwb, twb = _bf16_pair(w)
    return jw.quantize_weight(jwb, js), tw.quantize_weight(twb, ts)


def _leaves(tree, path=()) -> dict:
    """{path: leaf} of a nested dict of tensors or arrays."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, path + (key,)))
        else:
            out[path + (key,)] = v
    return out


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


# ---------------------------------------------------------------------------
# wquant and the convert repair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantize_weight_bitwise(specs):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 72, 40)) * 0.05
    w[:, :, 4] = 0.0                       # an all-zero output channel
    w[1, :, 9] *= 1e3                      # an outlier channel
    jl, tl = _qpair(w, specs)
    assert tl["codes"].shape == (3, 72, 40) and tl["scale"].shape == (3, 40)
    assert tl["codes"].dtype == specs[1].code_dtype
    np.testing.assert_array_equal(_bits(tl["codes"]), _jbits(jl["codes"]))
    np.testing.assert_array_equal(_bits(tl["scale"]), _jbits(jl["scale"]))
    assert not tl["codes"][:, :, 4].float().any()
    np.testing.assert_array_equal(
        _bits(tw.dequantize_weight(tl)),
        _jbits(jw.dequantize_weight(jl).astype(jnp.float32)))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantize_params_and_bytes_match_the_reference(specs):
    js, ts = specs
    cfg = jconfigs.smoke(jconfigs.get(ARCH))
    jp = jget_model(cfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    jq_p = jw.quantize_params(jp, js)
    tq_p = tw.quantize_params(tp, ts)
    got, want = _leaves(tq_p["layers"]), _leaves(jq_p["layers"])
    assert set(got) == set(want)
    # every GEMM weight is a {codes, scale} leaf, and nothing else is
    weights = {path[:-1] for path in got if path[-2] in tw.WEIGHT_KEYS}
    assert {path[-1] for path in weights} == set(tw.WEIGHT_KEYS)
    for path in weights:
        assert {p[-1] for p in got if p[:-1] == path} == {"codes", "scale"}
    assert not any(path[-1] in tw.WEIGHT_KEYS for path in got)
    for path, v in got.items():
        np.testing.assert_array_equal(_bits(v), _jbits(want[path]))
    # everything outside the GEMM weights passes through by identity
    for key in tp:
        if key != "layers":
            assert tq_p[key] is tp[key]
    assert tw.gemm_weight_bytes(tq_p) == jw.gemm_weight_bytes(jq_p)
    assert tw.gemm_weight_bytes(tp) == jw.gemm_weight_bytes(jp)
    assert tw.gemm_weight_bytes(tp) / tw.gemm_weight_bytes(tq_p) > 1.9
    # a quantized tree passes through a second pass unchanged
    again = tw.quantize_params(tq_p, ts)
    for key in ("codes", "scale"):
        assert (again["layers"]["attn"]["wq"][key]
                is tq_p["layers"]["attn"]["wq"][key])


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_params_from_numpy_carries_a_quantized_tree(specs):
    """The reference's quantized params convert leaf for leaf: int8 and
    fp8 codes bit for bit, equal to the port quantizing the converted
    bf16 tree itself."""
    js, ts = specs
    cfg = jconfigs.smoke(jconfigs.get(ARCH))
    jp = jget_model(cfg).init_params(jax.random.PRNGKey(1))
    carried = params_from_numpy(jax.device_get(jw.quantize_params(jp, js)),
                                device="cpu")
    own = tw.quantize_params(params_from_numpy(jax.device_get(jp),
                                               device="cpu"), ts)
    a, b = _leaves(carried), _leaves(own)
    assert set(a) == set(b)
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        assert torch.equal(a[path].view(torch.uint8),
                           b[path].view(torch.uint8)), path
    assert b[("layers", "attn", "wq", "codes")].dtype == ts.code_dtype


# ---------------------------------------------------------------------------
# Rows 1, 2, 8, 12-14: quantized plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# (M, K, N): decode shapes, and K / N off the blocks (the JAX kernels pad;
# the port's plain versions and kernels walk them masked)
GEMM_CASES = [(1, 256, 384), (4, 200, 144), (3, 128, 48)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,k,n", GEMM_CASES)
def test_gemv_and_flat_gemm_quant_match_pallas(m, k, n, specs):
    rng = np.random.default_rng(m * 1000 + k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    jl, tl = _qpair(rng.normal(size=(k, n)) * k ** -0.5, specs)
    want_gemv = jgemv(jx, jl["codes"], w_scale=jl["scale"], interpret=True)
    want_flat = jflat_gemm(jx, jl["codes"], w_scale=jl["scale"],
                           interpret=True)
    got = gemv_plain(tx, tl["codes"], w_scale=tl["scale"])
    _close(got, want_gemv)
    _close(flat_gemm_plain(tx, tl["codes"], w_scale=tl["scale"]), want_flat)
    # the wrappers on CPU tensors are the plain versions
    assert torch.equal(gemv(tx, tl["codes"], w_scale=tl["scale"]), got)
    assert torch.equal(flat_gemm(tx, tl["codes"], w_scale=tl["scale"]),
                       flat_gemm_plain(tx, tl["codes"], w_scale=tl["scale"]))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (2, 200, 144)])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_fused_ffn_up_quant_matches_pallas(m, k, n, act, specs):
    rng = np.random.default_rng(k + n)
    jx, tx = _bf16_pair(rng.normal(size=(m, k)))
    jg, tg = _qpair(rng.normal(size=(k, n)) * k ** -0.5, specs)
    ju, tu = _qpair(rng.normal(size=(k, n)) * k ** -0.5, specs)
    want = jfused_ffn_up(jx, jg["codes"], ju["codes"], activation=act,
                         wg_scale=jg["scale"], wu_scale=ju["scale"],
                         interpret=True)
    kw = dict(activation=act, wg_scale=tg["scale"], wu_scale=tu["scale"])
    got = fused_ffn_up_plain(tx, tg["codes"], tu["codes"], **kw)
    _close(got, want)
    assert torch.equal(fused_ffn_up(tx, tg["codes"], tu["codes"], **kw), got)
    with pytest.raises(ValueError, match="together"):
        fused_ffn_up(tx, tg["codes"], tu["codes"], wg_scale=tg["scale"])


# (M, heads, kv heads, head_dim, d_model, bias, rope); d_model 192 leaves a
# K tail behind the 128-deep K tiles
INGEST_CASES = [(1, 4, 2, 32, 128, False, True),
                (3, 8, 8, 64, 256, True, True),
                (2, 4, 1, 64, 192, True, False)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,hq,hk,dh,d,bias,use_rope", INGEST_CASES)
def test_decode_ingest_quant_matches_pallas(m, hq, hk, dh, d, bias,
                                            use_rope, specs):
    rng = np.random.default_rng(hq * 100 + d)
    jx, tx = _bf16_pair(rng.normal(size=(m, d)))
    js_, ts_ = _bf16_pair(1 + 0.1 * rng.normal(size=(d,)))
    ws = [_qpair(rng.normal(size=(d, n)) * d ** -0.5, specs)
          for n in (hq * dh, hk * dh, hk * dh)]
    bs = [_bf16_pair(rng.normal(size=(n,))) if bias else (None, None)
          for n in (hq * dh, hk * dh, hk * dh)]
    pos = np.array([4, 9, 1000][:m], np.int32)
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh, rope_theta=1e6,
              use_rope=use_rope)
    want = jdf.decode_ingest_fused(
        jx, js_, *(w[0]["codes"] for w in ws), jnp.asarray(pos),
        bq=bs[0][0], bk_bias=bs[1][0], bv=bs[2][0],
        wq_scale=ws[0][0]["scale"], wk_scale=ws[1][0]["scale"],
        wv_scale=ws[2][0]["scale"], interpret=True, **kw)
    tkw = dict(kw, bq=bs[0][1], bk=bs[1][1], bv=bs[2][1],
               wq_scale=ws[0][1]["scale"], wk_scale=ws[1][1]["scale"],
               wv_scale=ws[2][1]["scale"])
    tpos = torch.from_numpy(pos)
    got = tdf.decode_ingest_plain(tx, ts_, *(w[1]["codes"] for w in ws),
                                  tpos, **tkw)
    for a, b in zip(got, want):
        _close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(tdf.decode_ingest_fused(
        tx, ts_, *(w[1]["codes"] for w in ws), tpos, **tkw), got))
    # the front door takes the quantized leaves themselves
    front = ops.decode_ingest(tx[:, None], ts_, *(w[1] for w in ws), tpos,
                              plan=make_plan("cuda"), bq=bs[0][1],
                              bk=bs[1][1], bv=bs[2][1], **kw)
    for a, b in zip(front, got):
        assert torch.equal(a.reshape(b.shape), b)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,k,d", [(1, 256, 128), (3, 200, 144)])
def test_oproj_residual_quant_matches_pallas(m, k, d, specs):
    rng = np.random.default_rng(k * d)
    jo, to = _bf16_pair(rng.normal(size=(m, k)))
    jr, tr = _bf16_pair(rng.normal(size=(m, d)))
    jl, tl = _qpair(rng.normal(size=(k, d)) * k ** -0.5, specs)
    want = jdf.oproj_residual_fused(jo, jl["codes"], jr, w_scale=jl["scale"],
                                    interpret=True)
    got = tdf.oproj_residual_plain(to, tl["codes"], tr, w_scale=tl["scale"])
    _close(got, want)
    assert torch.equal(tdf.oproj_residual_fused(to, tl["codes"], tr,
                                                w_scale=tl["scale"]), got)
    assert torch.equal(ops.oproj_residual(to[:, None], tl, tr[:, None],
                                          plan=make_plan("cuda"))[:, 0], got)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,d,f", [(2, 128, 256), (3, 192, 144)])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_ffn_norm_quant_matches_pallas(m, d, f, act, specs):
    rng = np.random.default_rng(d + f)
    jx, tx = _bf16_pair(rng.normal(size=(m, d)))
    js_, ts_ = _bf16_pair(1 + 0.1 * rng.normal(size=(d,)))
    jg, tg = _qpair(rng.normal(size=(d, f)) * d ** -0.5, specs)
    ju, tu = _qpair(rng.normal(size=(d, f)) * d ** -0.5, specs)
    want = jdf.ffn_norm_fused(jx, js_, jg["codes"], ju["codes"],
                              activation=act, wg_scale=jg["scale"],
                              wu_scale=ju["scale"], interpret=True)
    kw = dict(activation=act, wg_scale=tg["scale"], wu_scale=tu["scale"])
    got = tdf.ffn_norm_plain(tx, ts_, tg["codes"], tu["codes"], **kw)
    _close(got, want)
    assert torch.equal(tdf.ffn_norm_fused(tx, ts_, tg["codes"], tu["codes"],
                                          **kw), got)
    front = ops.ffn_norm(tx[:, None], ts_, tg, tu, activation=act,
                         plan=make_plan("cuda"))
    assert torch.equal(front[:, 0], got)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_torch_backend_oracles_match_the_reference_oracles(specs):
    """On ``"torch"`` the front doors run the ``ref`` expressions with the
    scales, as the JAX package's XLA path runs its oracles."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(7)
    m, d, f, hq, hk, dh = 3, 128, 256, 4, 2, 32
    jx, tx = _bf16_pair(rng.normal(size=(m, 1, d)))
    js_, ts_ = _bf16_pair(1 + 0.1 * rng.normal(size=(d,)))
    plan = make_plan("torch", fused_ffn=True)
    gate = _qpair(rng.normal(size=(d, f)) * d ** -0.5, specs)
    up = _qpair(rng.normal(size=(d, f)) * d ** -0.5, specs)
    down = _qpair(rng.normal(size=(f, d)) * f ** -0.5, specs)
    want = jref.ffn_norm_ref(jx, js_, gate[0]["codes"], up[0]["codes"],
                             wg_scale=gate[0]["scale"],
                             wu_scale=up[0]["scale"])
    _close(ops.ffn_norm(tx, ts_, gate[1], up[1], plan=plan), want)
    h, th = _bf16_pair(rng.normal(size=(m, 1, f)))
    want = jref.oproj_residual_ref(h, down[0]["codes"], jx,
                                   w_scale=down[0]["scale"])
    _close(ops.oproj_residual(th, down[1], tx, plan=plan), want)
    want = jref.fused_ffn_up_ref(jx[:, 0], gate[0]["codes"], up[0]["codes"],
                                 wg_scale=gate[0]["scale"],
                                 wu_scale=up[0]["scale"])
    _close(ops.fused_ffn(tx[:, 0], gate[1], up[1], plan=plan), want)
    qkv = [_qpair(rng.normal(size=(d, n)) * d ** -0.5, specs)
           for n in (hq * dh, hk * dh, hk * dh)]
    pos = np.arange(m, dtype=np.int32) + 5
    kw = dict(num_heads=hq, num_kv_heads=hk, head_dim=dh)
    want = jref.decode_ingest_ref(
        jx, js_, *(w[0]["codes"] for w in qkv), jnp.asarray(pos),
        wq_scale=qkv[0][0]["scale"], wk_scale=qkv[1][0]["scale"],
        wv_scale=qkv[2][0]["scale"], **kw)
    got = ops.decode_ingest(tx, ts_, *(w[1] for w in qkv),
                            torch.from_numpy(pos), plan=plan, **kw)
    for a, b in zip(got, want):
        _close(a, b)


# ---------------------------------------------------------------------------
# ops routing of a quantized leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("m,route", [(1, "gemv"), (4, "flat_gemm"),
                                     (130, "xla_dot")])
def test_matmul_routes_a_quantized_leaf(monkeypatch, m, route, specs):
    """ops.matmul hands the codes and steps to the GEMV at M <= 2, to the
    flat GEMM below M = 128 and to the reference's XLA-dot expression
    from there (the default ladder), and on the "torch" backend always to
    the expression; the result is the quantized oracle's."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(m)
    _, tx = _bf16_pair(rng.normal(size=(m, 64)))
    _, leaf = _qpair(rng.normal(size=(64, 48)) * 0.1, specs)
    calls = []

    def spy(name, fn):
        def wrapped(x, w, **kw):
            calls.append((name, w.dtype, kw.get("w_scale") is not None))
            return fn(x, w, **kw)
        return wrapped

    monkeypatch.setattr(ops, "gemv", spy("gemv", ops.gemv))
    monkeypatch.setattr(ops, "flat_gemm", spy("flat_gemm", ops.flat_gemm))
    monkeypatch.setattr(ops.ref, "flat_gemm_ref",
                        spy("xla_dot", tref.flat_gemm_ref))
    want = tref.flat_gemm_ref(tx, leaf["codes"], w_scale=leaf["scale"])
    calls.clear()
    got = ops.matmul(tx[None], leaf, plan=make_plan("cuda"))[0]
    assert calls == [(route, specs[1].code_dtype, True)]
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    calls.clear()
    got = ops.matmul(tx, leaf, plan=make_plan("torch"))
    assert calls == [("xla_dot", specs[1].code_dtype, True)]
    assert torch.equal(got, want)


def test_quantized_kernels_refuse_what_they_cannot_take():
    """Gate and up (or q, k and v) steps that do not come together, codes
    of another dtype and steps of the wrong shape raise: the checks the
    plain versions and the kernel wrappers share (the wrappers' own
    layout checks run before a launch, on the card)."""
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    leaf = tw.quantize_weight(torch.randn(64, 32), tq.INT8)
    with pytest.raises(ValueError, match="together"):
        tdf.ffn_norm_plain(x, torch.ones(64, dtype=torch.bfloat16),
                           leaf["codes"], leaf["codes"],
                           wg_scale=leaf["scale"])
    with pytest.raises(ValueError, match="together"):
        tdf.decode_ingest_fused(
            x, torch.ones(64, dtype=torch.bfloat16), leaf["codes"],
            leaf["codes"], leaf["codes"], torch.zeros(2, dtype=torch.int32),
            num_heads=1, num_kv_heads=1, head_dim=32,
            wq_scale=leaf["scale"])
    from repro_torch.kernels.gemv import check_codes
    with pytest.raises(TypeError, match="int8 or"):
        check_codes("gemv", torch.zeros((4, 8), dtype=torch.bfloat16),
                    torch.zeros(8))
    with pytest.raises(ValueError, match="steps"):
        check_codes("gemv", leaf["codes"], torch.zeros(31))
    assert check_codes("gemv", leaf["codes"], leaf["scale"]) == 0
    fp8 = tw.quantize_weight(torch.randn(64, 32), tq.FP8)
    assert check_codes("gemv", fp8["codes"], fp8["scale"]) == 1


def test_tile_budgets_count_codes_at_one_byte():
    """The shared-memory budgets count x at 2 bytes and the weights at
    their element width, as the kernels' stage layouts do (the split
    body's rows padded by 16 bytes; the wgmma bodies' code tiles at 64
    bytes a row plus the two converted bf16 buffers); bf16 budgets keep
    their values, and every launch at w_bytes 1 fits a block."""
    from repro_torch import hardware
    from repro_torch.kernels import flat_gemm as tfg
    from repro_torch.kernels.fused_ffn import wgmma_smem_bytes
    budget = hardware.DEFAULT.smem_per_block
    for bk in (32, 64, 128):
        assert tfg.split_smem(bk, w_kn=True) == \
            4 * (64 * (bk + 8) + bk * (64 + 8)) * 2
        assert tfg.split_smem(bk, w_kn=True, w_bytes=1) == \
            4 * (64 * (bk + 8) * 2 + bk * (64 + 16))
    for per in (1, 3, 5, 14):
        stages = min(4, max(2, per))
        assert tfg.wgmma_smem(per) == stages * 16384 + 64 + 1024
        assert tfg.wgmma_smem(per, 1) == stages * 12288 + 16384 + 64 + 1024
        assert tdf.wgmma_norm_smem(per) == \
            stages * 16384 + per * 8192 + 64 + 1024
        assert tdf.wgmma_norm_smem(per, 1) == \
            stages * 8192 + per * 8192 + 32768 + 64 + 1024
    assert wgmma_smem_bytes(1) == 4 * (8192 + 32768) + 32768 + 64 + 1024
    assert wgmma_smem_bytes(1) <= budget
    for k, n in ((896, 4864), (4864, 896), (4096, 11008)):
        body, bk, splits = tfg.gemm_tiles(k, n, w_bytes=1)
        per = tfg.split_tiles(k, splits)
        assert (tfg.split_smem(bk, w_bytes=1) if body == "split"
                else tfg.wgmma_smem(per, 1)) <= budget
        per = tfg.split_tiles(k, tdf.ffn_norm_splits(k, n, 1))
        assert tdf.wgmma_norm_smem(per, 1) <= budget


# ---------------------------------------------------------------------------
# Plan knob and engine
# ---------------------------------------------------------------------------


def test_weight_dtype_knob_validates():
    assert WEIGHT_DTYPES == ("bf16", "int8", "fp8")
    assert MatmulPlan().weight_dtype == "bf16"
    with pytest.raises(PlanError, match="weight_dtype"):
        MatmulPlan(weight_dtype="int3")
    with pytest.raises(PlanError, match="weight_dtype"):
        make_plan(weight_dtype="int3")
    for wd in WEIGHT_DTYPES:
        assert make_plan(weight_dtype=wd).matmul.weight_dtype == wd
    # the cost model's pick needs a config: make_plan points to tune
    with pytest.raises(PlanError, match=r"tune\(cfg, weight_dtype=None\)"):
        make_plan(weight_dtype=None)


def _model(dtype: str):
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **over)
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **over)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                             device="cpu")


@pytest.fixture(scope="module")
def bf16_model():
    return _model("bfloat16")


@pytest.fixture(scope="module")
def f32_model():
    return _model("float32")


def test_engine_weight_dtype_precedence_and_bytes(bf16_model):
    jcfg, tcfg, jp, tp = bf16_model
    kw = dict(max_seq=64, device="cpu")
    eng = Engine(tcfg, tp, **kw)
    assert eng.weight_dtype == "bf16" and eng.params is tp
    # the plan's knob rides along; the explicit argument wins and lands in
    # the plan
    eng = Engine(tcfg, tp, plan=make_plan("cuda", weight_dtype="fp8"), **kw)
    assert eng.weight_dtype == "fp8"
    wq = eng.params["layers"]["attn"]["wq"]
    assert tw.is_quantized_leaf(wq)
    assert wq["codes"].dtype == torch.float8_e4m3fn
    eng = Engine(tcfg, tp, plan=make_plan("cuda", weight_dtype="fp8"),
                 weight_dtype="int8", **kw)
    assert eng.weight_dtype == eng.plan.matmul.weight_dtype == "int8"
    assert eng.params["layers"]["attn"]["wq"]["codes"].dtype == torch.int8
    assert eng.ctx.plan is eng.plan
    with pytest.raises(ValueError, match="weight_dtype"):
        Engine(tcfg, tp, weight_dtype="int4", **kw)
    for wd in WEIGHT_DTYPES:
        want = JEngine(jcfg, jp, max_seq=64, weight_dtype=wd)
        got = Engine(tcfg, tp, weight_dtype=wd, **kw)
        assert got._weight_bytes_per_tick == want._weight_bytes_per_tick
    # the count per decode tick
    eng = Engine(tcfg, tp, weight_dtype="int8", num_slots=2, **kw)
    eng.run([(np.arange(1, 9, dtype=np.int32), SamplingParams(
        max_new_tokens=3))])
    assert eng.stats.weight_bytes_decode_read == \
        eng.ticks * eng._weight_bytes_per_tick > 0


def _header_prompts(seed, header_len, tails, vocab=500):
    rng = np.random.default_rng(seed)
    header = rng.integers(1, vocab, size=header_len).astype(np.int32)
    return [np.concatenate([header, rng.integers(1, vocab, size=n).astype(
        np.int32)]) for n in tails]


@pytest.mark.parametrize("wd", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["dense", "paged sharing"])
def test_quantized_engine_matches_jax_engine(f32_model, layout, wd):
    """Greedy serving with quantized weights under split, fused and looped:
    the port's engine on the "cuda" plan (plain versions on the CPU)
    against the JAX engine with the same weight_dtype and granularity,
    token for token."""
    jcfg, tcfg, jp, tp = f32_model
    budgets = [5, 3, 6, 4]
    if layout == "dense":
        prompts = [np.random.default_rng(5).integers(1, 500, n).astype(
            np.int32) for n in (9, 30, 17, 23)]
        kw = dict(num_slots=2, max_seq=96, prefill_chunk=16)
    else:
        prompts = _header_prompts(13, 32, (9, 23, 5, 30))
        kw = dict(num_slots=3, max_seq=128, prefill_chunk=16,
                  cache_kind="paged", page_size=16, prefix_sharing=True)
    granularities = ("split", "fused", "looped") if wd == "int8" else \
        ("split", "looped")
    for g in granularities:
        want = JEngine(jcfg, jp, plan=jmake_plan(fused_ffn=True),
                       weight_dtype=wd, decode_fusion=g, **kw).run(
            [(p, JSamplingParams(max_new_tokens=n))
             for p, n in zip(prompts, budgets)])
        eng = Engine(tcfg, tp, plan=make_plan("cuda", fused_ffn=True),
                     weight_dtype=wd, decode_fusion=g, device="cpu", **kw)
        got = eng.run([(p, SamplingParams(max_new_tokens=n))
                       for p, n in zip(prompts, budgets)])
        assert got == want, (g, wd)


@pytest.mark.parametrize("fusion", ["split", "fused", "looped"])
def test_bf16_knob_keeps_tokens(bf16_model, fusion):
    """weight_dtype="bf16" is the untouched path: the same params object
    and the same greedy tokens as an engine built without the knob."""
    _, tcfg, _, tp = bf16_model
    prompts = [np.random.default_rng(2).integers(1, 500, n).astype(np.int32)
               for n in (7, 19, 12)]
    reqs = [(p, SamplingParams(max_new_tokens=5)) for p in prompts]
    kw = dict(num_slots=2, max_seq=64, decode_fusion=fusion, device="cpu")
    implicit = Engine(tcfg, tp, **kw)
    explicit = Engine(tcfg, tp, weight_dtype="bf16", **kw)
    assert explicit.params is tp
    assert implicit.run(reqs) == explicit.run(reqs)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantized_logits_within_the_guard(bf16_model, specs):
    """The JAX contract on the "torch" plan: teacher-forced decode logits
    of quantized weights within logits_guard_tol(spec) x max(|logits|, 1)
    of the bf16 logits; the "cuda" plan's plain versions within bf16
    tolerance of the "torch" plan on the same quantized params."""
    _, tcfg, _, tp = bf16_model
    api = tget_model(tcfg)
    qp = tw.quantize_params(tp, specs[1])
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, 500, (2, 16)).astype(np.int32))
    lens = torch.full((2,), 16, dtype=torch.int32)
    out = {}
    for name, params, plan in (("bf16", tp, make_plan("torch")),
                               ("torch", qp, make_plan("torch")),
                               ("cuda", qp, make_plan("cuda"))):
        ctx = LayerCtx(tcfg, plan)
        cache = api.init_cache(DenseLayout(2, 64), device="cpu")
        _, cache = api.prefill_chunk(ctx, params, toks, lens, cache,
                                     torch.zeros(2, dtype=torch.int32))
        logits, _ = api.decode_step(ctx, params, toks[:, 0], cache, lens)
        out[name] = logits[:, :tcfg.vocab_size].float()
    scale = max(out["bf16"].abs().max().item(), 1.0)
    tol = tq.logits_guard_tol(specs[1]) * scale
    assert (out["torch"] - out["bf16"]).abs().max().item() <= tol
    assert (out["cuda"] - out["torch"]).abs().max().item() <= 0.25


def test_serve_cli_weight_dtype(capsys):
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-seq", "96", "--max-new", "4", "--prompt-len", "20"]
    outs = {}
    for wd in (None, "bf16", "int8", "fp8"):
        argv = base + ([] if wd is None else ["--weight-dtype", wd])
        assert serve.main(argv) == 0
        outs[wd] = capsys.readouterr().out
    reqs = {w: [ln for ln in o.splitlines() if ln.startswith("  req ")]
            for w, o in outs.items()}
    assert reqs[None] == reqs["bf16"] and len(reqs["bf16"]) == 3
    assert len(reqs["int8"]) == len(reqs["fp8"]) == 3
    assert "weights=bf16 (589824 B/tick" in outs[None]
    assert "weights=int8 (303104 B/tick" in outs["int8"]
    assert "weights=fp8 (303104 B/tick" in outs["fp8"]
