"""T1 math — unified-max partial softmax and the two combine schemes.

Each partial holds one KV slice's contribution; the combine is

  * async (T1): add the ``(num, den)`` partials — a unified φ makes them
    directly addable (Eq. 4), in any order and any split;
  * sync (baseline): take the global max first, rescale each partial by
    ``exp(m_local − m_global)``, then add — the synchronized update of
    Eq. 2.

The single-process combines take a list of partials; the collective
ones (:func:`combine_async_collective`, :func:`combine_sync_collective`)
take this rank's partial and join it with the other ranks' of a
``torch.distributed`` process group (the mesh's ``model`` axis in
``core/attention.py``): T1's async combine is one SUM all-reduce of
``(num, den)`` packed in one f32 buffer, the synchronized baseline a MAX
all-reduce of ``m``, the rescale, then that SUM.

A row with no valid key has ``den == 0``: both combines return 0 for it
(the sync combine as the JAX package's does; the JAX package's async
combine divides 0 by 0 there and returns NaN).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class AsyncPartial(NamedTuple):
    """Order-independent softmax partial (Eq. 4 inner accumulations)."""

    num: torch.Tensor    # Σ e^{s−φ} · v   — (..., d)
    den: torch.Tensor    # Σ e^{s−φ}       — (...,)
    max_centered: torch.Tensor  # max(s−φ)  — (...,) overflow statistic


class SyncPartial(NamedTuple):
    """Max-carrying partial (Eq. 2) — needs synchronized combination."""

    num: torch.Tensor
    den: torch.Tensor
    m: torch.Tensor      # local max


def async_partial(
    s: torch.Tensor,          # (..., kv) pre-softmax logits
    v: torch.Tensor,          # (..., kv, d)
    phi: float,
    valid: Optional[torch.Tensor] = None,
) -> AsyncPartial:
    centered = s - phi
    if valid is not None:
        e = torch.where(valid, torch.exp(centered), 0.0)
        mc = torch.where(valid, centered, -torch.inf).amax(dim=-1)
    else:
        e = torch.exp(centered)
        mc = centered.amax(dim=-1)
    num = torch.einsum("...k,...kd->...d", e, v)
    den = e.sum(dim=-1)
    return AsyncPartial(num, den, mc)


def sync_partial(
    s: torch.Tensor,
    v: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> SyncPartial:
    if valid is not None:
        s = torch.where(valid, s, -torch.inf)
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - safe_m[..., None])
    e = torch.where(torch.isfinite(s), e, 0.0)
    num = torch.einsum("...k,...kd->...d", e, v)
    den = e.sum(dim=-1)
    return SyncPartial(num, den, m)


def combine_async(
        partials: list[AsyncPartial]) -> tuple[torch.Tensor, torch.Tensor]:
    """Additive combine: returns (out, max_centered); a row whose
    partials saw no valid key (den 0) gives 0."""
    num = sum(p.num for p in partials)
    den = sum(p.den for p in partials)
    mc = torch.stack([p.max_centered for p in partials]).amax(dim=0)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None], mc


def combine_sync(partials: list[SyncPartial]) -> torch.Tensor:
    """Synchronized combine: global max, rescale every partial, then add."""
    m = torch.stack([p.m for p in partials]).amax(dim=0)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)

    def weight(p: SyncPartial) -> torch.Tensor:
        return torch.exp(torch.where(torch.isfinite(p.m), p.m, -torch.inf)
                         - safe_m)

    num = sum(p.num * weight(p)[..., None] for p in partials)
    den = sum(p.den * weight(p) for p in partials)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None]


def _packed_sum(num: torch.Tensor, den: torch.Tensor, group):
    """``(Σ num, Σ den)`` over ``group`` in one SUM all-reduce of one f32
    buffer (num's last dim, then den)."""
    buf = torch.cat([num.float(), den.float()[..., None]], dim=-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[..., :-1], buf[..., -1]


def combine_async_collective(p: AsyncPartial, group, *, stat: bool = False
                             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """T1 cross-rank combine: the partials add, so one SUM all-reduce of
    the packed ``(num, den)``. Returns ``(out, max_centered)``: the
    overflow statistic is joined (a MAX all-reduce) only with ``stat``,
    else None. A row with no valid key on any rank gives 0."""
    num, den = _packed_sum(p.num, p.den, group)
    mc = None
    if stat:
        mc = p.max_centered.float().clone()
        dist.all_reduce(mc, op=dist.ReduceOp.MAX, group=group)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None], mc


def combine_sync_collective(p: SyncPartial, group) -> torch.Tensor:
    """Baseline cross-rank combine (Eq. 2): a MAX all-reduce of ``m``,
    each rank's partial rescaled by ``exp(m_local − m_global)`` (a rank
    with no valid key, ``m = -inf``, adds nothing), then one SUM
    all-reduce of the packed ``(num, den)``."""
    m = p.m.float().clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    safe_m = torch.where(torch.isfinite(m), m, 0.0)
    scale = torch.exp(torch.where(torch.isfinite(p.m), p.m.float(),
                                  -torch.inf) - safe_m)
    num, den = _packed_sum(p.num * scale[..., None], p.den * scale, group)
    den = torch.where(den == 0.0, 1.0, den)
    return num / den[..., None]
