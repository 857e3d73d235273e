"""The port's quantization primitives (``repro_torch.kernels.quant``) against
the JAX package's ``kernels/quant.py`` on the same numpy inputs, for int8
and fp8 e4m3: steps, codes, dequantized values, rescaled codes and the
round-trip bound bitwise equal (codes compared as uint8, f32 values as
uint32), including an all-zero group and an outlier group; the spec
helpers and the logits guard equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as jq
from repro_torch.kernels import quant as tq

SPECS = [(jq.INT8, tq.INT8), (jq.FP8, tq.FP8)]
IDS = ["int8", "fp8"]


def _groups(seed: int, shape=(6, 40)) -> np.ndarray:
    """f32 rows (one group each) with an all-zero row, an outlier row and a
    row of tiny values (fp8 subnormals after scaling)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[1] = 0.0
    x[2] *= 1e4
    x[3] *= 1e-30
    x[4, 7] = 300.0        # one loud element in an otherwise quiet row
    return x


def _codes_bits(c) -> np.ndarray:
    if isinstance(c, torch.Tensor):
        return c.view(torch.uint8).numpy()
    return np.asarray(c).view(np.uint8)


def _f32_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.numpy().view(np.uint32)
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_codes_decode_bitwise(specs, dtype):
    js, ts = specs
    x = _groups(0)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jstep = jq.compute_step(jx, js, axes=-1)
    tstep = tq.compute_step(tx, ts, axes=-1)
    np.testing.assert_array_equal(_f32_bits(tstep), _f32_bits(jstep))
    assert float(tstep[1]) == 0.0              # the all-zero group
    jc, tc = jq.encode(jx, jstep, js), tq.encode(tx, tstep, ts)
    assert tc.dtype == ts.code_dtype
    np.testing.assert_array_equal(_codes_bits(tc), _codes_bits(jc))
    assert not tc[1].float().any()
    np.testing.assert_array_equal(_f32_bits(tq.decode(tc, tstep)),
                                  _f32_bits(jq.decode(jc, jstep)))
    np.testing.assert_array_equal(
        _f32_bits(tq.roundtrip_bound(tx, tstep, ts)),
        _f32_bits(jq.roundtrip_bound(jx, jstep, js)))
    err = (tq.decode(tc, tstep) - tx.float()).abs()
    assert bool((err <= tq.roundtrip_bound(tx, tstep, ts)).all())


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_step_over_several_axes_bitwise(specs):
    js, ts = specs
    x = _groups(1, shape=(6, 8, 16, 8))
    jstep = jq.compute_step(jnp.asarray(x), js, axes=(1, 3))
    tstep = tq.compute_step(torch.from_numpy(x), ts, axes=(1, 3))
    np.testing.assert_array_equal(_f32_bits(tstep), _f32_bits(jstep))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_rescale_codes_bitwise(specs):
    js, ts = specs
    x = _groups(2)
    rng = np.random.default_rng(3)
    old = jq.compute_step(jnp.asarray(x), js, axes=-1)
    codes = jq.encode(jnp.asarray(x), old, js)
    # a raised step, an equal one (ratio 1 must be exact), a fresh group
    new = np.asarray(old) * rng.choice([1.0, 1.5, 3.0], size=old.shape)
    new = new.astype(np.float32)
    old_np = np.asarray(old).copy()
    old_np[0] = 0.0
    want = jq.rescale_codes(codes, jnp.asarray(old_np), jnp.asarray(new), js)
    tcodes = torch.from_numpy(_codes_bits(codes).copy()).view(ts.code_dtype)
    got = tq.rescale_codes(tcodes, torch.from_numpy(old_np),
                           torch.from_numpy(new), ts)
    np.testing.assert_array_equal(_codes_bits(got), _codes_bits(want))
    assert not got[0].float().any()
    same = np.flatnonzero(new == np.asarray(old))
    same = same[same != 0]
    assert torch.equal(got[same].view(torch.uint8),
                       tcodes[same].view(torch.uint8))


def test_spec_helpers_match_the_reference():
    assert tq.KV_DTYPES == jq.KV_DTYPES
    assert tq.fp8_supported()
    for name in ("int8", "fp8"):
        js, ts = jq.spec_for(name), tq.spec_for(name)
        assert (ts.name, ts.qmax, ts.is_int) == (js.name, js.qmax, js.is_int)
        assert tq.logits_guard_tol(ts) == jq.logits_guard_tol(js)
    assert tq.spec_for("bf16") is None
    assert tq.INT8.code_dtype == torch.int8
    assert tq.FP8.code_dtype == torch.float8_e4m3fn
    assert tq.spec_for_dtype(torch.int8) is tq.INT8
    assert tq.spec_for_dtype(torch.float8_e4m3fn) is tq.FP8
    assert tq.spec_for_dtype(torch.bfloat16) is None
    with pytest.raises(ValueError, match="int4"):
        tq.spec_for("int4")
