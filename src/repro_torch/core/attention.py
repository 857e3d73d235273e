"""Distributed decode attention — T1's multi-card payoff, explicitly.

``decode_attention_sharded`` runs split-KV decode attention over the
mesh's ``model`` axis: each rank holds a contiguous S/W slice of the
dense KV cache, computes its partial ``(num, den)`` over it, and the
cross-rank combine is

  * **async (T1)** — one SUM all-reduce of the packed ``(num, den)``: the
    unified max value φ makes the partials add. No max exchange, no
    rescale — Eq. 4's outer accumulation as a collective.
  * **sync (baseline)** — a MAX all-reduce of ``m``, the rescale, then
    the SUM all-reduce: the synchronized update of Eq. 2 as collectives,
    one more all-reduce and a rescale on every rank, every token, every
    layer.

The per-rank partial is rows 3 / 4 as shard partials
(``kernels/decode_attention.py``'s ``decode_attention_partial_*``: the
split-KV kernels on a CUDA tensor, their plain versions on a CPU tensor)
under a ``"cuda"`` backend, and their plain version under ``"torch"``,
as the JAX package runs the Pallas kernel on a TPU and the jnp oracle on
the CPU. As in the JAX package, the async path does not join the
overflow statistic: the sharded path has no overflow recompute.

Each rank passes its own batch rows (a ``data`` coordinate's) and its
own cache slice; ``lengths`` are global positions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core import softmax as smx
from repro_torch.kernels import decode_attention as da


def decode_attention_sharded(
    mesh,
    q: torch.Tensor,          # (B, HQ, D)
    k_loc: torch.Tensor,      # (B, S / W, HK, D): this rank's slice
    v_loc: torch.Tensor,
    lengths: torch.Tensor,    # (B,) global
    *,
    phi_cfg: SoftmaxPhiConfig = SoftmaxPhiConfig(),
    scheme: str = "unified_max",
    scale: Optional[float] = None,
    model_axis: str = "model",
    backend: str = "cuda",
) -> torch.Tensor:
    """Split-KV decode attention over the ``model`` axis of ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`); rank ``i`` of the axis holds
    key positions ``i * S_loc .. (i + 1) * S_loc - 1``.

    ``scheme`` mirrors the plan's ``attention_decode.scheme`` knob: the
    async T1 combine needs both an active φ config and a
    ``"unified_max"`` request; either veto runs the sync baseline.
    ``backend`` is the plan's ``attention_decode.backend``."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    start = mesh.coord(model_axis) * k_loc.shape[1]
    group = mesh.group(model_axis)
    kt, vt = k_loc.transpose(1, 2), v_loc.transpose(1, 2)   # views
    if phi_cfg.active and scheme == "unified_max":
        if backend == "cuda":
            part = da.decode_attention_partial_unified_max(
                q, kt, vt, lengths, start, phi=phi_cfg.phi, scale=scale)
        else:
            part = da.decode_attention_partial_plain(
                q, kt, vt, lengths, start, unified_max=True,
                phi=phi_cfg.phi, scale=scale)
        out, _ = smx.combine_async_collective(smx.AsyncPartial(*part), group)
    else:
        if backend == "cuda":
            part = da.decode_attention_partial_sync(q, kt, vt, lengths, start,
                                                    scale=scale)
        else:
            part = da.decode_attention_partial_plain(
                q, kt, vt, lengths, start, unified_max=False, scale=scale)
        out = smx.combine_sync_collective(smx.SyncPartial(*part), group)
    return out.to(q.dtype)


@dataclasses.dataclass(frozen=True)
class ShardedDecodeAttention:
    """A ``LayerCtx.decode_attention_fn``: ``(q, k_loc, v_loc, lengths)
    -> o`` over this rank's cache slice, plus :meth:`kv_start`, where the
    model places the new token's KV."""

    mesh: object
    phi_cfg: SoftmaxPhiConfig
    scheme: str = "unified_max"
    model_axis: str = "model"
    backend: str = "cuda"

    def __call__(self, q, k_loc, v_loc, lengths):
        return decode_attention_sharded(
            self.mesh, q, k_loc, v_loc, lengths, phi_cfg=self.phi_cfg,
            scheme=self.scheme, model_axis=self.model_axis,
            backend=self.backend)

    def kv_start(self, s_loc: int) -> int:
        """The first global position of this rank's ``s_loc``-wide
        slice."""
        return self.mesh.coord(self.model_axis) * s_loc


def make_decode_attention_fn(mesh, rules, phi_cfg,
                             scheme: str = "unified_max",
                             backend: str = "cuda"
                             ) -> ShardedDecodeAttention:
    """Adapter producing a ``LayerCtx.decode_attention_fn``; pass the
    plan's ``attention_decode.scheme`` and ``.backend`` so the override
    honors them."""
    return ShardedDecodeAttention(mesh, phi_cfg, scheme, rules.model_axis,
                                  backend)
