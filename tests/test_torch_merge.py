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


def _partial(scheme, s, v, valid, accumulate):
    """One piece folded from the empty partial with ``accumulate`` (the
    JAX or the port module's step), as a split's partial starts."""
    if scheme == "unified":
        return accumulate.unified_accumulate(
            np.zeros((R, D), np.float32), np.zeros((R, 1), np.float32),
            np.float32(-np.inf), s - 0.5, v, valid)
    return accumulate.sync_accumulate(
        np.zeros((R, D), np.float32), np.zeros((R, 1), np.float32),
        np.full((R, 1), -np.inf, np.float32),
        np.where(valid, s, -np.inf).astype(np.float32), v, valid=valid)


def _port_partial(scheme, s, v, valid):
    t = [torch.from_numpy(np.asarray(x)) for x in (s, v, valid)]
    if scheme == "unified":
        return tmerge.unified_accumulate(
            torch.zeros(R, D), torch.zeros(R, 1), torch.tensor(float("-inf")),
            t[0] - 0.5, t[1], t[2])
    return tmerge.sync_accumulate(
        torch.zeros(R, D), torch.zeros(R, 1), torch.full((R, 1),
                                                         float("-inf")),
        torch.where(t[2], t[0], torch.tensor(float("-inf"))), t[1],
        valid=t[2])


_MERGES = {"unified": "merge_unified", "lse": "merge_lse"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme", ["unified", "lse"])
def test_symmetric_merges_match_reference(scheme, seed):
    """merge_unified / merge_lse on two finite partials (every row sees a
    key in both pieces) agree with the JAX package's."""
    acc_scheme = "unified" if scheme == "unified" else "sync"
    pieces = _pieces(seed, 2)
    for p in pieces:
        p[2][:, 0] = True
    jparts = [_partial(acc_scheme, *p, jmerge) for p in pieces]
    tparts = [_port_partial(acc_scheme, *p) for p in pieces]
    want = getattr(jmerge, _MERGES[scheme])(*jparts)
    got = getattr(tmerge, _MERGES[scheme])(*tparts)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tmerge.finalize(got[0], got[1]), jmerge.finalize(want[0], want[1]))


@pytest.mark.parametrize("empty_first", [True, False],
                         ids=["empty_first", "empty_second"])
@pytest.mark.parametrize("scheme", ["unified", "lse"])
def test_merge_with_fully_masked_partial(scheme, empty_first):
    """A partial whose row 0 saw no valid key adds nothing to that row:
    the port's merge returns the other partial's row 0 unchanged and
    finite. Under the online-max scheme the JAX package's own steps make
    that row NaN instead (its sync_accumulate gives the empty partial
    NaN, and merge_lse carries it on: the seed failure
    tests/test_merge_properties.py::test_sync_split_equivalence)."""
    acc_scheme = "unified" if scheme == "unified" else "sync"
    full, masked = _pieces(7, 2)
    masked[2][0] = False
    order = (masked, full) if empty_first else (full, masked)
    tparts = [_port_partial(acc_scheme, *p) for p in order]
    got = getattr(tmerge, _MERGES[scheme])(*tparts)
    other = tparts[1] if empty_first else tparts[0]
    for g, o in zip(got, other):
        g0, o0 = (g[0], o[0]) if g.dim() else (g, o)
        assert torch.isfinite(g0).all()
        if scheme == "lse" or g.dim():
            assert torch.equal(g0, o0)
    jparts = [_partial(acc_scheme, *p, jmerge) for p in order]
    want = getattr(jmerge, _MERGES[scheme])(*jparts)
    if scheme == "lse":
        assert np.isnan(np.asarray(want[0])[0]).all()
    else:
        _close(got[0][0], want[0][0])
    _close(got[0][1:], want[0][1:])
