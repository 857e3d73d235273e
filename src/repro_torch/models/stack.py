"""Layer-stack plumbing. Layer params (and the KV cache) are stacked on a
leading L axis, as in the JAX package; where it runs ``lax.scan`` the
port runs a Python loop over per-layer views (``a[i]`` slices — no
copies, and in-place cache writes land in the stacked tensor)."""
from __future__ import annotations

from typing import Callable


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def num_layers_of(layers_params) -> int:
    return tree_leaves(layers_params)[0].shape[0]


def unstack(tree) -> list:
    """Stacked-L tree -> list of L per-layer trees of views."""
    return [tree_map(lambda a: a[i], tree)
            for i in range(num_layers_of(tree))]


def run_stack_cached(layers_params, x, cache, block_fn: Callable):
    """``block_fn(p_i, x, cache_i) -> x`` over the depth; ``cache_i`` is
    the layer's view of every cache leaf, updated in place. Returns
    ``(x, cache)``."""
    for p_i, c_i in zip(unstack(layers_params), unstack(cache)):
        x = block_fn(p_i, x, c_i)
    return x, cache
