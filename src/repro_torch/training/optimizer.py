"""AdamW + global-norm clip + warmup-cosine schedule.

Moments are f32 whatever the params' dtype; the update is computed in
f32 and cast back (bf16 params with f32 optimizer state, the standard
mixed setup). The update runs under ``torch.no_grad()`` and returns new
trees, as the JAX package's pure function does. Under a mesh each rank
updates its own shards; only the global norm needs the others
(``specs`` / ``mesh``: one all-reduce over every rank).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed import collectives as C
from repro_torch.models.stack import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in f32 on step's
    device."""
    step = torch.as_tensor(step).float()
    if cfg.warmup_steps <= 0:
        warm = 1.0
    else:
        warm = torch.clamp(step / cfg.warmup_steps, max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def adamw_init(params: Any) -> tuple[Any, Any]:
    """(m, v) f32 moment trees shaped like params, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """The L2 norm over every element of ``tree``. Under a mesh, ``tree``
    holds this rank's shards under ``specs`` (a tree of ``P``): each
    element is counted once, a leaf held alike by R ranks (replicated
    over the axes its spec does not name) at 1 / R on each of them, in
    one SUM all-reduce over the whole mesh."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    world = mesh.axes_size(mesh.axis_names)
    weights = [mesh.axes_size(_named_axes(spec)) / world
               for spec in tree_leaves(tree_map(lambda _, s: s, tree,
                                                specs))]
    total = torch.sum(torch.stack([s * w for s, w in zip(leaves, weights)]))
    if world > 1:
        C.all_reduce_(total, mesh, mesh.axis_names)
    return torch.sqrt(total)


def _named_axes(spec) -> tuple[str, ...]:
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def clip_by_global_norm(grads: Any, max_norm: float, specs: Any = None,
                        mesh=None):
    """(grads scaled so that their global norm is at most ``max_norm``,
    each leaf in its own dtype; the norm before clipping)."""
    gn = global_norm(grads, specs, mesh)
    scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, m: Any, v: Any,
                 step: torch.Tensor, *, specs: Any = None, mesh=None):
    """One AdamW step at ``step`` (the count of steps taken). Returns
    (params, m, v, metrics), new trees; decoupled weight decay applies to
    matrices (ndim >= 2) only. Under a mesh the trees are this rank's
    shards under ``specs``."""
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, specs,
                                           mesh)
    else:
        gnorm = global_norm(grads, specs, mesh)
    lr = lr_schedule(cfg, step)
    t = step.float() + 1.0
    bc1 = 1.0 - cfg.beta1 ** t
    bc2 = 1.0 - cfg.beta2 ** t

    def upd(p, g, m_, v_):
        gf = g.float()
        m_new = cfg.beta1 * m_ + (1 - cfg.beta1) * gf
        v_new = cfg.beta2 * v_ + (1 - cfg.beta2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * pf
        return (pf - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, m, v)     # (p, m, v) leaves
    new_params, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                                for i in range(3))
    return new_params, new_m, new_v, {"grad_norm": gnorm, "lr": lr}
