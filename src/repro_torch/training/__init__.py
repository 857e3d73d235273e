"""Training on one card: optimizer, state, data pipeline, checkpointing,
loop.

Plain functions over tensor trees (nested dicts of tensors, as the
models' params are), an explicit device and an explicit generator. The
step runs the ``"torch"`` plan: its GEMMs are library products and its
attention the reference math, since no hand-written kernel has a backward
(``train_state.make_train_step`` refuses a ``"cuda"`` plan). Checkpoints
keep the JAX package's on-disk layout, so a step written by either
package restores in the other.
"""
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    lr_schedule,
)
from repro_torch.training.train_state import TrainState  # noqa: F401
