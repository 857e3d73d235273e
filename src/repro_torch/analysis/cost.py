"""Operation, byte, memory and collective counts of a PyTorch program,
taken at the dispatcher.

The port's counterpart of the JAX package's ``repro.analysis.hlo`` and of
the ``cost_analysis()`` / ``memory_analysis()`` that XLA gives its dry
run. There a compiled module is parsed; here every aten and c10d op the
program dispatches passes through :class:`CostCounter`, a
``TorchDispatchMode``, which records:

* FLOPs: matmul-class ops by the formulas of ``torch.utils.flop_counter``
  (2mnk a product); elementwise arithmetic one FLOP an output element and
  a reduction one an input element, as XLA's HloCostAnalysis counts them.
* Bytes accessed: each op's input and output tensor bytes. A view moves
  nothing and counts nothing; an in-place op's returned input, or an
  ``out=`` tensor, is not counted again as an output.
* Peak live bytes of the tensors the program creates: each new output's
  storage is counted until it is collected (weakly referenced, so
  autograd's saved tensors and views keep it alive as they keep the
  memory), and the peak of their sum is kept. Tensors that existed
  before the counter (params, cache, batch) are the program's arguments
  and are not counted.
* Collective bytes and counts by kind: the ``c10d`` ops that
  ``torch.distributed`` dispatches, each counted at its result's bytes
  (as ``hlo.py`` counts an HLO collective at its result shape), under
  the :meth:`CostCounter.scope` the program is in.

It counts what is dispatched, so a program run on the meta device (shapes
and dtypes only, nothing computed or allocated) is counted as it would be
on a card. It counts the ops it sees, not the work a fused kernel does:
a plain program's bytes are those of its unfused ops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# c10d op name -> the HLO collective kind it is counted as
_C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
    "broadcast_": "collective-broadcast",
}


# tagged pointwise but a copy, not arithmetic (XLA counts a copy no FLOP)
_COPIES = frozenset({torch.ops.aten.clone})


@dataclasses.dataclass
class CollectiveStats:
    """Bytes per collective kind, per scope (``hlo.py``'s computation)."""

    by_comp: Dict[str, Dict[str, int]]
    counts: Dict[str, int]

    def total_bytes(self, multipliers: Dict[str, int] | None = None) -> int:
        """Total collective bytes; ``multipliers`` maps a substring of a
        scope name to the number of times that scope stands for."""
        multipliers = multipliers or {}
        total = 0
        for comp, kinds in self.by_comp.items():
            mult = 1
            for key, m in multipliers.items():
                if key in comp:
                    mult = m
                    break
            total += mult * sum(kinds.values())
        return total

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for kinds in self.by_comp.values():
            for kind, b in kinds.items():
                out[kind] += b
        return dict(out)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in _tensors(tree))


def _fresh_outputs(func, out) -> list:
    """The outputs of ``func`` that are new tensors: not a view of, nor
    the written-to, input (the schema's alias annotations say which)."""
    outs = out if isinstance(out, tuple) else (out,)
    fresh = []
    for ret, o in zip(func._schema.returns, outs):
        if ret.alias_info is None:
            fresh.extend(_tensors(o))
    return fresh


class CostCounter(TorchDispatchMode):
    """Count a program's FLOPs, bytes accessed, peak created bytes and
    collectives while it runs under ``with CostCounter() as c:``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._scope = "entry"
        self._coll: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        self._coll_counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str):
        """Count the collectives dispatched inside under ``name``."""
        prev, self._scope = self._scope, name
        try:
            yield
        finally:
            self._scope = prev

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(
            by_comp={k: dict(v) for k, v in self._coll.items()},
            counts=dict(self._coll_counts))

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        # the storage's Python object lives as long as its memory does
        weakref.finalize(storage, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(func._schema.name.split("::")[-1])
            if kind is not None:
                # recv_ returns only its Work: its bytes are the buffer
                # it receives into
                moved = out[0] if isinstance(out, (tuple, list)) else args[0]
                self._coll[self._scope][kind] += _nbytes(moved)
                self._coll_counts[kind] += 1
            return out
        if func.is_view:
            return out
        fresh = _fresh_outputs(func, out)
        self.bytes_accessed += (_nbytes(args) + _nbytes(kwargs)
                                + sum(t.nbytes for t in fresh))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        elif torch.Tag.pointwise in func.tags and packet not in _COPIES:
            self.flops += next(_tensors(out)).numel()
        elif torch.Tag.reduction in func.tags:
            self.flops += next(_tensors(args)).numel()
        for t in fresh:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out
