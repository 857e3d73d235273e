"""Fault-tolerant training loop, on one device or one rank of a mesh.

  * **checkpoint/restart**: async checkpoints every ``checkpoint_every``
    steps; on start the loop resumes from the latest committed
    checkpoint (a torn write is invisible: COMMIT is last). Data is a
    pure function of (seed, step), so a restart replays the identical
    stream, and a deterministic step makes recovery bit for bit.
  * **preemption**: SIGTERM / SIGINT flips a flag; the loop finishes the
    in-flight step, writes a blocking checkpoint, and returns (the CLI
    then exits 0 and the scheduler restarts the job).
  * **stragglers**: input comes from a prefetch thread (never on the
    step's critical path); a step-time watchdog counts slow steps (over
    ``watchdog_factor`` x the median of the last 64).
  * **a mesh** (``mesh`` / ``rules`` / ``specs``): every rank draws the
    global batch and keeps its rows (``train_state.local_batch``), the
    checkpoints gather and shard (``CheckpointManager``), and the ranks
    agree on the preemption flag (a MAX all-reduce a step), so that no
    rank leaves the others waiting in a collective. Rank 0 logs.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.distributed import collectives as C
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import Prefetcher, SyntheticTokens, device_batch
from repro_torch.training.train_state import local_batch


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    step_times: list
    preempted: bool = False
    restored_from: Optional[int] = None
    slow_steps: int = 0


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful save-and-exit flag."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # not the main thread
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


def train_loop(
    *,
    model_cfg: ModelConfig,
    shape: ShapeConfig,
    run: RunConfig,
    train_step: Callable,
    init_state: Callable[[], Any],
    device="cuda",
    mesh=None,
    rules=None,
    specs: Any = None,
    max_steps: Optional[int] = None,
    log_every: int = 10,
    watchdog_factor: float = 3.0,
    install_signals: bool = True,
    preempt_after: Optional[int] = None,   # test hook: simulate preemption
) -> LoopResult:
    """Run (or resume) training until ``max_steps`` or preemption; the
    state and batches live on ``device``. Under a mesh, ``init_state``
    gives this rank's shards, ``specs`` their ``TrainState`` of specs."""
    dev = resolve(device)
    total = max_steps if max_steps is not None else run.total_steps
    ckpt = CheckpointManager(run.checkpoint_dir, keep=run.keep_checkpoints,
                             mesh=mesh, specs=specs)
    guard = PreemptionGuard(install=install_signals)
    main = mesh is None or mesh.axes_coord(mesh.axis_names) == 0

    def stop_requested() -> bool:
        if mesh is None:
            return guard.requested
        flag = torch.tensor([int(guard.requested)], device=dev)
        C.all_reduce_(flag, mesh, mesh.axis_names, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    # ---- restore or init ----
    restored_from = None
    state = init_state()
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.load_state(latest, state, dev)
        restored_from = latest
    start_step = int(state.step)

    source = SyntheticTokens(model_cfg, shape, seed=run.seed)
    prefetch = Prefetcher(source, start_step=start_step)

    losses, times = [], []
    slow = 0
    step = start_step
    try:
        stop = stop_requested()
        while step < total and not stop:
            step_idx, host_batch = prefetch.next()
            if step_idx != step:
                raise RuntimeError(f"prefetched step {step_idx}, at {step}")
            batch = device_batch(host_batch, dev)
            if mesh is not None:
                batch = local_batch(batch, rules, mesh)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            times.append(dt)
            # watchdog: flag stragglers once there's a baseline
            if len(times) >= 8 and dt > watchdog_factor * statistics.median(
                    times[-64:]):
                slow += 1
            step += 1
            if step % run.checkpoint_every == 0:
                ckpt.save(step, state)          # async
            if main and log_every and step % log_every == 0:
                print(f"step {step:>6}  loss {loss:.4f}  {dt*1e3:.1f} ms",
                      flush=True)
            if preempt_after is not None and step - start_step >= preempt_after:
                guard.requested = True
            stop = stop_requested()
        preempted = stop and step < total
        if preempted or step % run.checkpoint_every != 0:
            ckpt.save(step, state, blocking=True)   # final/preemption save
        ckpt.wait()
    finally:
        prefetch.close()
        if install_signals:
            guard.restore()

    return LoopResult(
        final_step=step, losses=losses, step_times=times,
        preempted=preempted, restored_from=restored_from, slow_steps=slow,
    )
