"""The softmax-merge algebra shared by every attention kernel's plain
version.

Two schemes:

  * **unified-max** (the paper's §3 asynchronized softmax): a partial is
    ``(num, den, msc)`` with ``num = Σ exp(s − φ)·v``, ``den = Σ exp(s − φ)``
    and ``msc = max(s − φ)`` over valid positions. φ is a static constant,
    so folding pieces together is pure addition — no rescale.
  * **online-max** (FlashAttention-style, the recompute fallback): a
    partial is ``(acc, den, m)`` stabilized by its own running max;
    folding rescales by ``exp(m_prev − m_new)``.

The CUDA kernels under ``csrc/`` run the same fold per warp or per tile.
Shapes here carry leading batch dims: ``acc (..., R, D)``, ``den (..., R,
1)``, ``centered``/``s (..., R, K)``, ``v (..., K, D)``.

Two symmetric merges fold whole partials, as the split-KV chunk kernel's
combine does: :func:`merge_unified` (pure addition under T1) and
:func:`merge_lse` (rescale both to the larger max).

One divergence from the JAX package, in both online-max steps: a
partial that saw no valid key (``m == -inf``) contributes nothing. There,
:func:`sync_accumulate` makes NaN on a fully masked row (``exp(-inf -
-inf)``) and ``merge_lse`` carries an empty partial's NaN on (the seed
failure ``tests/test_merge_properties.py::test_sync_split_equivalence``);
here the row stays at ``acc = den = 0`` and the other partial passes
through unchanged.
"""
from __future__ import annotations

import torch


def _weighted_sum(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., R, K) f32 weights x (..., K, D) values -> (..., R, D) f32."""
    return torch.matmul(e, v.float())


def unified_accumulate(acc, den, msc, centered, v, valid):
    """Fold one KV piece into a unified-max partial.

    acc: (..., R, D) f32; den: (..., R, 1) f32; msc: (...) f32 running max
    centered score; centered: (..., R, K) f32 logits already shifted by φ;
    v: (..., K, D); valid: (..., R, K) bool. Returns ``(acc, den, msc)``.
    """
    neg = torch.full_like(centered, float("-inf"))
    piece_max = torch.where(valid, centered, neg).amax(dim=(-2, -1))
    msc = torch.maximum(msc, piece_max)
    e = torch.where(valid, torch.exp(centered), torch.zeros_like(centered))
    acc = acc + _weighted_sum(e, v)
    den = den + e.sum(dim=-1, keepdim=True)
    return acc, den, msc


def sync_accumulate(acc, den, m_prev, s, v, *, valid=None):
    """Fold one KV piece into an online-max partial.

    s: (..., R, K) f32 logits with invalid positions at ``-inf`` (or a
    large negative); m_prev: (..., R, 1). ``valid`` additionally zeroes
    the exp weights. Returns ``(acc, den, m_new)``; a row with no valid
    position so far keeps ``acc = den = 0`` and ``m = -inf``.
    """
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    # guard: an all-masked row has m_new == -inf; shift by 0 instead so
    # exp() sees -inf - 0 = -inf (weight 0) rather than -inf - -inf = NaN
    finite = torch.isfinite(m_new)
    shift = torch.where(finite, m_new, torch.zeros_like(m_new))
    rescale = torch.where(finite, torch.exp(m_prev - shift),
                          torch.ones_like(m_new))
    e = torch.exp(s - shift)
    if valid is not None:
        e = torch.where(valid, e, torch.zeros_like(e))
    acc = acc * rescale + _weighted_sum(e, v)
    den = den * rescale + e.sum(dim=-1, keepdim=True)
    return acc, den, m_new


def merge_unified(p1, p2):
    """Symmetric merge of two unified-max partials ``(num, den, msc)``."""
    n1, d1, m1 = p1
    n2, d2, m2 = p2
    return n1 + n2, d1 + d2, torch.maximum(m1, m2)


def merge_lse(p1, p2):
    """Symmetric merge of two max-stabilized partials ``(acc, den, m)``
    (``m`` broadcastable against ``den``). A partial with ``m == -inf``
    saw no valid key and adds nothing; two such give the empty partial."""
    a1, d1, m1 = p1
    a2, d2, m2 = p2
    m = torch.maximum(m1, m2)
    shift = torch.where(m == float("-inf"), torch.zeros_like(m), m)

    def weight(mi):
        return torch.where(mi == float("-inf"), torch.zeros_like(mi),
                           torch.exp(mi - shift))

    r1, r2 = weight(m1), weight(m2)
    return a1 * r1 + a2 * r2, d1 * r1 + d2 * r2, m


def finalize(acc, den, *, guard_zero: bool = False):
    """num/den -> output rows. ``guard_zero`` substitutes 1 for an all-
    masked row's zero denominator, so that row comes out as zeros."""
    if guard_zero:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return acc / den
