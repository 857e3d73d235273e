"""Layer-stack plumbing. Layer params (and the KV cache) are stacked on a
leading L axis, as in the JAX package; where it runs ``lax.scan`` the
port runs a Python loop over per-layer views (``a[i]`` slices — no
copies, and in-place cache writes land in the stacked tensor). Where the
JAX package's ``"looped"`` decode granularity runs the whole depth as one
``lax.scan`` dispatch, the port replays one CUDA graph of the whole
decode step (:class:`LoopedDecode`). The train blocks return ``(x, aux)``
(:func:`run_stack_aux`), as the JAX package's do."""
from __future__ import annotations

import dataclasses
from typing import Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees ``rest``, which share its structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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


def unbind(tree) -> list:
    """Stacked-L tree -> list of L per-layer trees of views, as
    :func:`unstack` gives, through ``torch.unbind``: its backward stacks
    the L layer gradients once, where each of L ``a[i]`` views scatters
    its gradient into a zeroed tensor of the whole stack (L² work and
    memory in a train step)."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda p: p[i], parts)
            for i in range(num_layers_of(tree))]


def run_stack(layers_params, x, block_fn: Callable):
    """``block_fn(p_i, x) -> x`` over the depth (an encoder's stack: no
    cache). Returns x."""
    for p_i in unbind(layers_params):
        x = block_fn(p_i, x)
    return x


def run_stack_aux(layers_params, x, block_fn: Callable):
    """``block_fn(p_i, x) -> (x, aux)`` over the depth (the train blocks:
    ``aux`` is MoE's load-balance loss, 0 for the other families).
    Returns ``(x, the sum of aux)``."""
    aux = 0.0
    for p_i in unbind(layers_params):
        x, a = block_fn(p_i, x)
        aux = aux + a
    return x, aux


def run_stack_cached(layers_params, x, cache, block_fn: Callable):
    """``block_fn(p_i, x, cache_i) -> x`` over the depth; ``cache_i`` is
    the layer's view of every cache leaf, updated in place. Returns
    ``(x, cache)``."""
    for p_i, c_i in zip(unstack(layers_params), unstack(cache)):
        x = block_fn(p_i, x, c_i)
    return x, cache


def run_decode(graphs, step: Callable, params, cache, inputs: dict):
    """``step(**inputs)``, a decode step that reads ``params`` and writes
    ``cache`` in place: through ``graphs`` (the context's
    :class:`LoopedDecode`, under ``"looped"``) when the tokens are on the
    card, keyed on the address of every param and cache leaf; eagerly
    otherwise, so on CPU tensors looped serves as split does."""
    if graphs is not None and inputs["tokens"].is_cuda:
        anchors = tuple(t.data_ptr() for t in tree_leaves(params)
                        + tree_leaves(cache))
        return graphs.run(step, inputs, anchors)
    return step(**inputs)


def _signature(inputs: dict) -> tuple:
    """Static shape signature of a step's inputs: each tensor's shape and
    dtype, a tuple of tensors (a ``DecodeGroups``) entry by entry."""
    def sig(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(sig(t) for t in v)
        return (tuple(v.shape), v.dtype)
    return tuple((name, sig(v)) for name, v in sorted(inputs.items()))


def _clone(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return type(v)(*(t.clone() for t in v))
    return v.clone()


def _copy_into(dst, src) -> None:
    if dst is None:
        return
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


@dataclasses.dataclass
class _Graph:
    graph: object           # torch.cuda.CUDAGraph (or a test's stand-in)
    static: dict            # the captured step's input buffers
    out: object             # its static output (the logits)
    launches: list          # each counter's launches per replay


class LoopedDecode:
    """The ``"looped"`` decode granularity on the card: a whole decode
    step (embed, every layer with its KV writes and attention, the final
    norm, the lm_head) captured into one ``torch.cuda.CUDAGraph`` per
    static shape key and replayed each tick — the port's counterpart of
    the JAX package's single ``lax.scan`` dispatch over the stacked depth.

    The key is the inputs' shapes and dtypes (tokens, lengths, positions,
    block tables, each ``DecodeGroups`` operand) plus ``anchors``, the
    addresses of the params and cache the step reads and writes in place.
    The first tick of a key runs eagerly: the same kernels, so the same
    bits, and every kernel library is loaded before any capture. The next
    tick copies its inputs into static buffers, captures and replays;
    every later tick copies and replays. All graphs share one memory
    pool. The logits come back in the graph's static output, which the
    next replay of that graph overwrites. A capture error is raised, never
    answered with an eager tick.

    A replay runs no Python wrapper, so the kernels' ``.launches``
    counters would stop at capture: the capture keeps the counters'
    increase as the graph's launch vector (and takes it back, since a
    capture launches nothing), and every replay adds it.
    """

    def __init__(self, counters=None):
        if counters is None:
            from repro_torch.kernels.ops import LAUNCH_COUNTERS
            counters = LAUNCH_COUNTERS
        self.counters = tuple(counters)
        self._pool = None           # the graphs' shared memory pool
        self._graphs: dict = {}
        self._eager: set = set()
        self.eager_ticks = 0        # one per key: its first tick
        self.captures = 0
        self.replays = 0

    def run(self, step: Callable, inputs: dict, anchors: tuple):
        """``step(**inputs)``, eagerly on a key's first tick and by graph
        replay after."""
        key = (_signature(inputs), anchors)
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._eager:
                self._eager.add(key)
                self.eager_ticks += 1
                return step(**inputs)
            entry = self._capture(step, inputs)
            self._graphs[key] = entry
        else:
            for name, buf in entry.static.items():
                _copy_into(buf, inputs[name])
        entry.graph.replay()
        self.replays += 1
        for fn, n in zip(self.counters, entry.launches):
            fn.launches += n
        return entry.out

    def _capture(self, step: Callable, inputs: dict) -> _Graph:
        static = {name: _clone(v) for name, v in inputs.items()}
        before = [fn.launches for fn in self.counters]
        graph, out = self._record(step, static)
        launches = [fn.launches - n for fn, n in zip(self.counters, before)]
        for fn, n in zip(self.counters, before):
            fn.launches = n
        self.captures += 1
        return _Graph(graph, static, out, launches)

    def _record(self, step: Callable, static: dict):
        """Capture ``step(**static)`` into a CUDA graph in the shared
        pool; returns (graph, static output)."""
        import torch
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = step(**static)
        return graph, out
