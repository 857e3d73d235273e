"""Serving on a mesh: one rank's decode tick and prefill under the JAX
package's serving layout (its dry run's ``lower_cell``).

  * **Params** tensor-parallel over ``model`` (``Rules.param_spec``) and,
    with ``fsdp_params``, FSDP over the batch axes too; the FSDP dims are
    gathered before use (:func:`repro_torch.distributed.sharding.
    gather_fsdp`: the whole tree at once, as the train step gathers it,
    so the peak holds every layer's TP shard, not one layer's).
  * **Caches** cut by ``Rules.cache_spec``: rows over the batch axes, a
    KV sequence (and the ring's slots) over ``model``, a recurrent state
    over the heads the rank scans.
  * **Inputs** (tokens, lengths, the frames or the vision prefix) cut by
    ``Rules.batch_spec``; ``lengths`` count global positions.

The context (:func:`serve_context`) carries the mesh, its rules, the
activation check and the sequence-split ``decode_attention_fn``
(:func:`repro_torch.core.attention.make_decode_attention_fn`: rows 3-4's
shard partials on the ``"cuda"`` backend), and ``moe_groups``, the
product of the batch axes (the JAX dry run's). The layers then run the
decode tick's q / k / v whole, attention over the rank's cache slice,
``wo`` and the MLP tensor-parallel and the logits gathered whole
(``models/layers.py``). Every rank calls :func:`decode_step` /
:func:`prefill` together: they are collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.config import MeshConfig
from repro_torch.core.attention import make_decode_attention_fn
from repro_torch.distributed.sharding import (Rules, gather_fsdp,
                                              local_shape, make_rules,
                                              make_shard_fn)
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_map


def serve_rules(mesh, *, fsdp_params: bool = False,
                seq_shard_kv: bool = True) -> Rules:
    """The serving rules on ``mesh`` (a ``launch.mesh.Mesh`` or a
    ``MeshConfig``): FSDP and activations over every batch axis, the KV
    sequence over ``model`` with ``seq_shard_kv``, params FSDP-cut only
    with ``fsdp_params``."""
    mesh_cfg = MeshConfig(tuple(mesh.shape), tuple(mesh.axis_names))
    return make_rules(mesh_cfg, seq_shard_kv=seq_shard_kv,
                      fsdp_params=fsdp_params)


def serve_context(cfg, plan, mesh, rules: Rules) -> LayerCtx:
    """This rank's serving ``LayerCtx``: the mesh and its rules, the
    activation check, ``moe_groups`` the batch axes' product, and the
    sequence-split decode attention on the plan's scheme and backend
    where the rules split the KV sequence."""
    groups = 1
    for a in rules.batch_axes:
        groups *= rules.axis_sizes[a]
    fn = None
    if rules.seq_shard_kv:
        dp = plan.attention_decode
        fn = make_decode_attention_fn(mesh, rules, cfg.softmax_phi,
                                      scheme=dp.scheme, backend=dp.backend)
    return LayerCtx(cfg=cfg, plan=plan, moe_groups=groups,
                    decode_attention_fn=fn, shard=make_shard_fn(mesh, rules),
                    mesh=mesh, rules=rules)


def cache_specs(cache: Any, rules: Rules) -> Any:
    """``Rules.cache_spec`` of every leaf of a global cache (tensors or
    anything with a ``shape``)."""
    return tree_map(lambda t: rules.cache_spec(tuple(t.shape)), cache)


def local_zeros(global_tree: Any, specs: Any, mesh, device=None) -> Any:
    """Zeros of this rank's shapes of a global tree (its shapes and
    dtypes only are read: meta tensors will do) under ``specs``."""
    return tree_map(lambda t, s: torch.zeros(
        local_shape(tuple(t.shape), s, mesh), dtype=t.dtype,
        device=t.device if device is None else device), global_tree, specs)


@dataclasses.dataclass(frozen=True)
class ShardedServe:
    """One rank's serving steps: ``api``'s decode tick and prefill on the
    context ``ctx`` (:func:`serve_context`), this rank's ``params`` cut
    by ``param_specs`` (FSDP dims gathered on every call when the rules
    cut them)."""

    api: Any
    ctx: LayerCtx
    param_specs: Any

    def params(self, params):
        """The params the layers compute on: ``params`` with the FSDP dims
        gathered (one all-gather a dtype), or ``params`` itself."""
        if not self.ctx.rules.fsdp_params:
            return params
        return gather_fsdp(params, self.param_specs, self.ctx.mesh,
                           self.ctx.rules)

    def decode_step(self, params, tokens, cache, lengths, **kw):
        return self.api.decode_step(self.ctx, self.params(params), tokens,
                                    cache, lengths, **kw)

    def prefill(self, params, tokens, lengths, cache, **kw):
        return self.api.prefill(self.ctx, self.params(params), tokens,
                                lengths, cache, **kw)


def sharded_serve(api, plan, mesh, rules: Optional[Rules] = None
                  ) -> ShardedServe:
    """:class:`ShardedServe` of ``api`` on ``mesh`` under ``rules``
    (default :func:`serve_rules`, TP params only)."""
    rules = rules or serve_rules(mesh)
    return ShardedServe(api, serve_context(api.cfg, plan, mesh, rules),
                        rules.param_spec_tree(api.init_params(
                            device="meta")))
