"""T1's calibration and partial-softmax math in the port
(repro_torch.core.phi, repro_torch.core.softmax) against the JAX
package's, on the same numpy inputs drawn from a seed: LogitStats within
rtol 1e-5, calibrate exactly equal on equal stats, the partials and
combines within 1e-6 on rows with a valid key (relative to the largest
magnitude for the unnormalized partial sums, f32 being ~6e-8 a rounding,
absolute for the normalized outputs). A row with no valid key
combines to 0 in the port; the JAX package's async combine gives NaN
there (0 / 0), a reference caveat the port does not carry."""
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import phi as jphi
from repro.core import softmax as jsmx
from repro_torch.core import phi as tphi
from repro_torch.core import softmax as tsmx

ROOT = Path(__file__).resolve().parents[1]


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# φ calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logit_stats_match_reference(seed):
    rng = _rng(seed)
    batches = [rng.normal(loc=rng.uniform(-2, 2), scale=rng.uniform(0.5, 3),
                          size=int(n)).astype(np.float32)
               for n in rng.integers(10, 500, size=4)]
    t, j = tphi.LogitStats(), jphi.LogitStats()
    for b in batches:
        t = t.update(torch.from_numpy(b))
        j = j.update(jnp.asarray(b))
    assert t.count == j.count
    for f in ("minimum", "maximum", "mean", "m2"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(t.std, j.std, rtol=1e-5)
    assert tphi.LogitStats.from_json(t.to_json()) == t
    assert t.update(torch.empty(0)) is t


@pytest.mark.parametrize("stats", [
    dict(count=0),
    dict(count=4096, minimum=-2.0, maximum=7.5, mean=3.0, m2=4096 * 2.25),
    dict(count=100, minimum=-0.5, maximum=0.5, mean=0.01, m2=1.0),
    dict(count=3, minimum=-300.0, maximum=250.0, mean=-16.7, m2=1.2e5),
])
def test_calibrate_is_exact_on_equal_stats(stats):
    for sigma, safe in ((6.0, tphi.F32_EXP_SAFE), (3.0, 20.0)):
        t = tphi.calibrate(tphi.LogitStats(**stats), sigma=sigma, safe=safe)
        j = jphi.calibrate(jphi.LogitStats(**stats), sigma=sigma, safe=safe)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.active == j.active


def test_wide_range_disables_t1_like_opt():
    cal = tphi.calibrate(tphi.LogitStats().update(
        torch.tensor([-300.0, 0.0, 250.0])))
    assert not cal.active


@pytest.mark.parametrize("hq,hk", [(4, 4), (8, 2), (14, 2)])
def test_collect_attention_logit_stats_matches_reference(hq, hk):
    rng = _rng(hq * 10 + hk)
    q = rng.normal(size=(2, 16, hq, 32)).astype(np.float32)
    k = rng.normal(size=(2, 16, hk, 32)).astype(np.float32)
    t = tphi.collect_attention_logit_stats(torch.from_numpy(q),
                                           torch.from_numpy(k))
    j = jphi.collect_attention_logit_stats(jnp.asarray(q), jnp.asarray(k))
    assert t.count == j.count == 2 * hq * 16 * 16
    for f in ("minimum", "maximum", "mean", "m2"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-5,
                                   atol=1e-5)
    t2 = tphi.collect_attention_logit_stats(
        torch.from_numpy(q), torch.from_numpy(k), scale=0.5, stats=t)
    j2 = jphi.collect_attention_logit_stats(
        jnp.asarray(q), jnp.asarray(k), scale=0.5, stats=j)
    np.testing.assert_allclose(t2.m2, j2.m2, rtol=1e-5)


def test_phi_registry_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in
            tphi.PHI_REGISTRY.items()} == {
        k: dataclasses.asdict(v) for k, v in jphi.PHI_REGISTRY.items()}
    for arch in ("llama2-7b", "opt-6.7b", "qwen2-0.5b"):
        assert dataclasses.asdict(tphi.phi_for(arch)) == \
            dataclasses.asdict(jphi.phi_for(arch))
    assert tphi.F32_EXP_SAFE == jphi.F32_EXP_SAFE


# ---------------------------------------------------------------------------
# Partials and combines
# ---------------------------------------------------------------------------


def _inputs(seed, rows=3, kv=24, d=8):
    rng = _rng(seed)
    s = (rng.normal(size=(rows, kv)) * 3).astype(np.float32)
    v = rng.normal(size=(rows, kv, d)).astype(np.float32)
    valid = rng.uniform(size=(rows, kv)) < 0.7
    valid[:, 0] = True                   # every row keeps a valid key
    return s, v, valid


def _close(t, j):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j[np.isfinite(j)]).max(initial=0.0)))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_partials_match_reference(seed):
    s, v, valid = _inputs(seed)
    ts, tv, tm = map(torch.from_numpy, (s, v, valid))
    js, jv, jm = map(jnp.asarray, (s, v, valid))
    for mask in (None, True):
        a_t = tsmx.async_partial(ts, tv, 0.5, tm if mask else None)
        a_j = jsmx.async_partial(js, jv, 0.5, jm if mask else None)
        for x, y in zip(a_t, a_j):
            _close(x, y)
        s_t = tsmx.sync_partial(ts, tv, tm if mask else None)
        s_j = jsmx.sync_partial(js, jv, jm if mask else None)
        for x, y in zip(s_t, s_j):
            _close(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_combines_match_reference(seed):
    s, v, valid = _inputs(seed, kv=32)
    splits = [slice(0, 5), slice(5, 19), slice(19, 32)]
    t_a = [tsmx.async_partial(torch.from_numpy(s[:, sl]),
                              torch.from_numpy(v[:, sl]), 0.0,
                              torch.from_numpy(valid[:, sl]))
           for sl in splits]
    j_a = [jsmx.async_partial(jnp.asarray(s[:, sl]), jnp.asarray(v[:, sl]),
                              0.0, jnp.asarray(valid[:, sl]))
           for sl in splits]
    out_t, mc_t = tsmx.combine_async(t_a)
    out_j, mc_j = jsmx.combine_async(j_a)
    _close(out_t, out_j)
    _close(mc_t, mc_j)
    t_s = [tsmx.sync_partial(torch.from_numpy(s[:, sl]),
                             torch.from_numpy(v[:, sl]),
                             torch.from_numpy(valid[:, sl]))
           for sl in splits]
    j_s = [jsmx.sync_partial(jnp.asarray(s[:, sl]), jnp.asarray(v[:, sl]),
                             jnp.asarray(valid[:, sl])) for sl in splits]
    _close(tsmx.combine_sync(t_s), jsmx.combine_sync(j_s))
    # the two schemes agree (Eq. 3: softmax does not depend on φ)
    np.testing.assert_allclose(out_t.numpy(), tsmx.combine_sync(t_s).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_all_masked_row_combines_to_zero_not_nan():
    s, v, valid = _inputs(7)
    valid[1] = False                     # row 1 has no valid key at all
    parts = [tsmx.async_partial(torch.from_numpy(s[:, sl]),
                                torch.from_numpy(v[:, sl]), 0.0,
                                torch.from_numpy(valid[:, sl]))
             for sl in (slice(0, 10), slice(10, 24))]
    out, _ = tsmx.combine_async(parts)
    assert torch.isfinite(out).all() and (out[1] == 0).all()
    sparts = [tsmx.sync_partial(torch.from_numpy(s[:, sl]),
                                torch.from_numpy(v[:, sl]),
                                torch.from_numpy(valid[:, sl]))
              for sl in (slice(0, 10), slice(10, 24))]
    sout = tsmx.combine_sync(sparts)
    assert torch.isfinite(sout).all() and (sout[1] == 0).all()
    # the reference caveat: its async combine divides 0 by 0 there
    jparts = [jsmx.async_partial(jnp.asarray(s[:, sl]), jnp.asarray(v[:, sl]),
                                 0.0, jnp.asarray(valid[:, sl]))
              for sl in (slice(0, 10), slice(10, 24))]
    jout, _ = jsmx.combine_async(jparts)
    assert np.isnan(np.asarray(jout)[1]).all()
    _close(out[[0, 2]], np.asarray(jout)[[0, 2]])


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------


def test_calibrate_phi_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "calibrate_phi_torch", ROOT / "examples" / "calibrate_phi_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stats, cal, opt_cal = mod.main(["--device", "cpu", "--batches", "2"])
    assert stats.count == 2 * 2 * 4 * 128 * 128     # smoke: 4 query heads
    assert cal.active and not opt_cal.active
    out = capsys.readouterr().out
    assert "calibrated: phi=" in out and "OPT case" in out
