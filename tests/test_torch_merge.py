"""The port's softmax-merge steps (repro_torch.kernels.merge) against the
JAX package's (repro.kernels.merge), on the same numpy inputs, in f32
(TOL["float32"]: both sides run the same f32 op sequence, so only
summation order separates them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.kernels import merge as jmerge
from repro_torch.kernels import merge as tmerge

R, K, D = 4, 16, 8


def _pieces(seed, n_pieces, mask_first_row=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pieces):
        s = rng.normal(size=(R, K)).astype(np.float32) * 3
        v = rng.normal(size=(K, D)).astype(np.float32)
        valid = rng.random((R, K)) < 0.7
        valid[:, 0] |= i == 0          # every row sees a key in piece 0
        if mask_first_row:
            valid[0] = False
        out.append((s, v, valid))
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("n_pieces", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_unified_accumulate_matches_reference(seed, n_pieces):
    phi = 0.5
    ja, jd, jm = (jnp.zeros((R, D)), jnp.zeros((R, 1)),
                  jnp.float32(-jnp.inf))
    ta, td, tm = (torch.zeros(R, D), torch.zeros(R, 1),
                  torch.tensor(float("-inf")))
    for s, v, valid in _pieces(seed, n_pieces):
        ja, jd, jm = jmerge.unified_accumulate(ja, jd, jm, s - phi, v, valid)
        ta, td, tm = tmerge.unified_accumulate(
            ta, td, tm, torch.from_numpy(s - phi), torch.from_numpy(v),
            torch.from_numpy(valid))
    _close(ta, ja)
    _close(td, jd)
    _close(tm, jm)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_sync_accumulate_matches_reference(seed, with_valid):
    ja, jd, jm = jnp.zeros((R, D)), jnp.zeros((R, 1)), jnp.full((R, 1),
                                                                -jnp.inf)
    ta, td, tm = torch.zeros(R, D), torch.zeros(R, 1), torch.full(
        (R, 1), float("-inf"))
    for s, v, valid in _pieces(seed, 3):
        s = np.where(valid, s, -np.inf).astype(np.float32)
        kw_j = {"valid": valid} if with_valid else {}
        kw_t = {"valid": torch.from_numpy(valid)} if with_valid else {}
        ja, jd, jm = jmerge.sync_accumulate(ja, jd, jm, s, v, **kw_j)
        ta, td, tm = tmerge.sync_accumulate(
            ta, td, tm, torch.from_numpy(s), torch.from_numpy(v), **kw_t)
    _close(ta, ja)
    _close(td, jd)
    _close(tm, jm)


@pytest.mark.parametrize("guard_zero", [False, True])
def test_finalize_matches_reference(guard_zero):
    rng = np.random.default_rng(3)
    acc = rng.normal(size=(R, D)).astype(np.float32)
    den = rng.random((R, 1)).astype(np.float32) + 0.5
    _close(tmerge.finalize(torch.from_numpy(acc), torch.from_numpy(den),
                           guard_zero=guard_zero),
           jmerge.finalize(acc, den, guard_zero=guard_zero))


def test_sync_fully_masked_row_is_finite():
    """A row masked in every piece: the port keeps acc = den = 0 and
    finalizes to zeros — a documented divergence from the reference,
    whose ``exp(-inf - -inf)`` makes that row NaN (the other rows agree)."""
    ta, td, tm = torch.zeros(R, D), torch.zeros(R, 1), torch.full(
        (R, 1), float("-inf"))
    ja, jd, jm = jnp.zeros((R, D)), jnp.zeros((R, 1)), jnp.full((R, 1),
                                                                -jnp.inf)
    for s, v, valid in _pieces(5, 3, mask_first_row=True):
        s = np.where(valid, s, -np.inf).astype(np.float32)
        ta, td, tm = tmerge.sync_accumulate(ta, td, tm, torch.from_numpy(s),
                                            torch.from_numpy(v))
        ja, jd, jm = jmerge.sync_accumulate(ja, jd, jm, s, v)
    out = tmerge.finalize(ta, td, guard_zero=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros(D))
    assert np.isnan(np.asarray(ja)[0]).all()          # the reference's NaN
    _close(out[1:], jmerge.finalize(ja, jd)[1:])
