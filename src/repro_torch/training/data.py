"""Deterministic sharded synthetic-token pipeline with background prefetch.

Determinism contract (the fault-tolerance linchpin): batch contents are a
pure function of ``(seed, step)``. Restarting from a checkpoint at step
k replays exactly the stream a never-interrupted run would have seen, on
any host count (each host materializes only its shard of the global
batch). The batches are pure numpy on ``SeedSequence([seed, step,
host])``, the JAX package's generator, so both packages train on the same
bits.

Tokens follow a Zipf-ish distribution over the vocab; the label stream is
the standard next-token shift.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve


class SyntheticTokens:
    """Deterministic (seed, step) -> batch generator."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        if shape.global_batch % host_count:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = shape.global_batch // host_count

    def batch_at(self, step: int) -> dict:
        """Materialize this host's shard of the global batch for ``step``
        (numpy arrays)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        b, s = self.local_batch, self.shape.seq_len
        v = self.cfg.vocab_size
        # Zipf-ish: rank ~ floor(exp(u * ln(v))) gives a heavy head
        u = rng.random((b, s + 1))
        toks = np.minimum(
            (np.exp(u * np.log(v)) - 1.0).astype(np.int64), v - 1
        ).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "vision":
            from repro_torch.models.api import n_image_tokens
            npfx = n_image_tokens(s)
            batch["tokens"] = batch["tokens"][:, : s - npfx]
            batch["labels"] = batch["labels"][:, : s - npfx]
            batch["prefix_embeds"] = (
                rng.standard_normal((b, npfx, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
        if self.cfg.family == "encdec":
            batch["frames"] = (
                rng.standard_normal((b, s, self.cfg.d_model)) * 0.02
            ).astype(np.float32)
        return batch


class Prefetcher:
    """Background producer over a SyntheticTokens stream: one thread
    keeps ``depth`` batches ready so that input generation stays off the
    step's critical path."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 60.0):
        """(step, batch), waiting at most ``timeout`` seconds."""
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def device_batch(batch: dict, device="cuda") -> dict:
    """Host numpy batch -> tensors on ``device``."""
    dev = resolve(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
