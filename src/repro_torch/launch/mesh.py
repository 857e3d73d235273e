"""Production mesh construction over ``torch.distributed``.

The port's :class:`Mesh` is a small record, not a JAX mesh: the shape and
axis names, this rank's coordinate on each axis, and one process group
per axis (the ranks that share every other coordinate with this one).
Ranks are laid out row-major over the shape, the last axis fastest, as
``jax.make_mesh`` lays out its device list.

Defined as FUNCTIONS (never module-level state), as in the JAX package:
importing this module touches no process group. Each function needs an
initialised default group (``torch.distributed.init_process_group``, to
which the caller gives its address, world size and rank) and must be
called by every rank of it, since ``new_group`` is collective. The groups'
backend follows the device: NCCL for ``"cuda"`` (the default), gloo for
``"cpu"``; a caller may name it instead (gloo on CUDA tensors, for ranks
that share one card, which NCCL refuses). Nothing switches backends by
itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshConfig

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a device mesh."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]            # this rank's coordinate per axis
    groups: tuple[Any, ...] = dataclasses.field(compare=False, repr=False)
    backend: str = "nccl"

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of the ranks that differ from this one on
        ``axis`` only."""
        return self.groups[self.axis_names.index(axis)]


def backend_for(device="cuda", backend: Optional[str] = None) -> str:
    """The process-group backend: ``backend`` if given, else the device's
    (NCCL for CUDA, gloo for the CPU)."""
    if backend is not None:
        return backend
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    return _BACKENDS[kind]


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device,
               backend: Optional[str]) -> Optional[Mesh]:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}")
    be = backend_for(device, backend)
    coords = _unravel(rank, shape) if rank < n else None
    groups = []
    for i in range(len(shape)):
        mine = None
        others = [range(s) for j, s in enumerate(shape) if j != i]
        # every rank creates every group of the axis, in one order
        for fixed in itertools.product(*others):
            ranks = []
            for c in range(shape[i]):
                full = list(fixed)
                full.insert(i, c)
                ranks.append(_ravel(full, shape))
            g = dist.new_group(ranks, backend=be)
            if rank in ranks:
                mine = g
        groups.append(mine)
    if coords is None:
        return None                      # a rank past the mesh's first n
    return Mesh(tuple(shape), tuple(axes), coords, tuple(groups), be)


def _unravel(rank: int, shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords, shape) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None) -> Optional[Mesh]:
    """(data=16, model=16), or (pod=2, data=16, model=16) with
    ``multi_pod``; raises ``RuntimeError`` on a smaller world. Ranks past
    the mesh's size take part in making the groups and get None."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device, backend)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh_from_config(cfg: MeshConfig, *, device="cuda",
                          backend: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of ``cfg``'s shape and axis names over the first
    ``cfg.num_devices`` ranks; raises ``RuntimeError`` on a smaller
    world."""
    return _make_mesh(tuple(cfg.shape), tuple(cfg.axis_names), device,
                      backend)
