"""Async checkpoints with a manifest, in the JAX package's layout.

One directory per step:

    <dir>/step_000400/
        manifest.json       {step, leaf paths, shapes, dtypes}
        shard_h000.npz      the leaf arrays (flattened names); one card,
                            so one host's shard
        COMMIT              written last: a checkpoint without it is torn
                            and ignored by `latest_step` (crash-safe).

Leaves are named by their ``/``-joined paths as the JAX package names
them (a ``TrainState`` field as ``.params``, a dict key as itself, e.g.
``.params/layers/attn/wq``), and bf16 / fp8 leaves are stored as their
uint bits, so a step written by either package restores in the other.

A save snapshots the state to host memory at once and writes it on a
background thread (the loop keeps stepping while the previous checkpoint
drains to disk); ``load_state`` puts each leaf on a target device.

Under a mesh (``mesh=`` and the state's ``specs``, a ``TrainState`` of
``P``) every rank takes part in a save: the state is gathered to its
global leaves (so the files are the one-device layout, ``ef_err`` with
its leading pod axis), rank 0 writes them, and every rank waits for the
commit (a barrier in :meth:`CheckpointManager.wait`). A restore reads
the global leaves and keeps this rank's shards under the specs it is
given, so a checkpoint written at one mesh restores at another (the JAX
package's elastic reshard).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import local_shard
from repro_torch.training.train_state import gather_state

_SEP = "/"
SHARD = "shard_h000.npz"   # the JAX layout's host-0 shard

# torch dtypes numpy cannot hold, stored as their bits: (the bit view in
# torch, the same view in numpy, the stored uint type)
_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8)}


def _items(tree: Any, prefix: tuple = ()):
    """(path components, leaf) pairs in the JAX package's leaf order: a
    dataclass's fields in order (each as ``.name``, a ``None`` field
    holds no leaf), a dict's keys sorted."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _items(getattr(tree, f.name), prefix + (f".{f.name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif tree is not None:
        yield prefix, tree


def tree_paths(tree: Any) -> list[str]:
    return sorted(_SEP.join(p) for p, _ in _items(tree))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the live tensor) as numpy."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _BITS:
        view, _, stored = _BITS[t.dtype]
        return t.view(view).numpy().view(stored)
    return t.numpy()


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_SEP.join(p): _to_numpy(leaf) for p, leaf in _items(tree)}


def _from_numpy(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on ``device``."""
    if like.dtype in _BITS:
        _, view, _ = _BITS[like.dtype]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(view))
        return t.view(like.dtype).to(device)
    t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=like.dtype)


def _rebuild(tree: Any, leaves: dict, prefix: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if tree is None:
        return None
    return leaves[_SEP.join(prefix)]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, mesh=None,
                 specs: Any = None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self.specs = specs
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot to host memory now; write to disk on a worker thread."""
        self.wait()  # one in-flight save at a time
        if self.mesh is not None:
            state = gather_state(state, self.specs, self.mesh)
            if not self._writer:
                if blocking:
                    self.wait()
                return
        flat = _flatten(state)  # device -> host copy

        def write():
            try:
                self._write(step, flat)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, flat: dict) -> None:
        path = self._step_dir(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, SHARD), **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        self._gc()

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.axes_coord(
            self.mesh.axis_names) == 0

    def wait(self) -> None:
        """Until the save in flight is committed; under a mesh every rank
        waits for rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and self.mesh.axes_size(
                self.mesh.axis_names) > 1:
            torch.distributed.barrier(
                group=self.mesh.group(self.mesh.axis_names))
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def load_state(self, step: int, like: Any, device=None) -> Any:
        """Restore into the structure and dtypes of ``like``, each leaf
        on ``device`` (``None``: the device of ``like``'s leaf); under a
        mesh, this rank's shard of each leaf."""
        path = self._step_dir(step)
        with np.load(os.path.join(path, SHARD),
                     allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        specs = {} if self.mesh is None else {
            _SEP.join(p): spec for p, spec in _items(self.specs)}
        leaves = {}
        for parts, leaf in _items(like):
            key = _SEP.join(parts)
            t = _from_numpy(flat[key], leaf, device if device is not None
                            else leaf.device)
            if key in specs:
                t = local_shard(t, specs[key], self.mesh).contiguous()
            leaves[key] = t
        return _rebuild(like, leaves)

    # -- internals -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
