"""Production mesh construction over ``torch.distributed``.

The port's :class:`Mesh` is a small record, not a JAX mesh: the shape and
axis names, this rank's coordinate on each axis, and one process group
for every set of axes (the ranks that share every other coordinate with
this one): one axis for T1's sequence split and the tensor-parallel
collectives, ``("pod", "data")`` for FSDP and the batch means, all of
them for the optimizer's global norm.
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
import signal
import subprocess
import threading
import time
from typing import Any, Optional, Sequence

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
    # axes (a tuple in mesh order) -> the group of the ranks that differ
    # from this one on those axes only
    groups: dict = dataclasses.field(compare=False, repr=False)
    backend: str = "nccl"

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def _axes(self, axes) -> tuple[str, ...]:
        """A spec entry (an axis name, or a tuple of names) as a tuple in
        mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of the ranks that differ from this one on
        ``axes`` (an axis name or a tuple of names) only. Its group ranks
        follow :meth:`axes_coord`."""
        return self.groups[self._axes(axes)]

    def axes_size(self, axes) -> int:
        """The number of ranks in :meth:`group` of ``axes``."""
        n = 1
        for a in self._axes(axes):
            n *= self.size(a)
        return n

    def axes_coord(self, axes) -> int:
        """This rank's combined coordinate over ``axes``, the first axis
        major (``local_shard``'s block index, and the rank in
        :meth:`group`)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.size(a) + self.coord(a)
        return idx


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
    groups = {}
    dims = range(len(shape))
    # every rank creates every group of every axis set, in one order; a
    # group's ranks ascend, so its group ranks run over the set's
    # coordinates with the first axis major
    for k in range(1, len(shape) + 1):
        for sub in itertools.combinations(dims, k):
            others = [range(shape[j]) if j not in sub else (None,)
                      for j in dims]
            for fixed in itertools.product(*others):
                ranks = []
                for cs in itertools.product(*(range(shape[j])
                                              for j in sub)):
                    full = list(fixed)
                    for j, c in zip(sub, cs):
                        full[j] = c
                    ranks.append(_ravel(full, shape))
                g = dist.new_group(ranks, backend=be)
                if rank in ranks:
                    groups[tuple(axes[j] for j in sub)] = g
    if coords is None:
        return None                      # a rank past the mesh's first n
    return Mesh(tuple(shape), tuple(axes), coords, groups, be)


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


def run_ranks(cmds: Sequence[Sequence[str]], *, env=None, cwd=None,
              timeout: Optional[float] = None,
              outputs: Optional[Sequence[Any]] = None) -> list[int]:
    """Start ``cmds[r]`` for every rank r, a process each, and wait for
    them all. SIGTERM / SIGINT that this process receives meanwhile go
    on to every rank (when called from the main thread); a rank that
    exits nonzero, or ``timeout`` seconds passing, kills the ranks still
    running. ``outputs[r]``, where given, is an open file for rank r's
    stdout and stderr. Returns the exit codes in rank order (a killed
    rank's is negative)."""
    procs: list = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = {}
    if threading.current_thread() is threading.main_thread():
        prev = {sig: signal.signal(sig, forward)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        for r, cmd in enumerate(cmds):
            out = None if outputs is None else outputs[r]
            procs.append(subprocess.Popen(
                list(cmd), env=env, cwd=cwd, stdout=out,
                stderr=None if out is None else subprocess.STDOUT))
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or (deadline is not None
                        and time.monotonic() > deadline)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for sig, h in prev.items():
            signal.signal(sig, h)
    return [p.returncode for p in procs]
