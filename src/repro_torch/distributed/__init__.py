"""Distribution layer: named-axis sharding rules over the port's mesh
(:mod:`repro_torch.launch.mesh`).

The mesh contract (the JAX package's):
  * single pod:  (data=16, model=16)
  * multi-pod:   (pod=2, data=16, model=16)

``pod`` + ``data`` together form the batch/FSDP axes; ``model`` is the
tensor-parallel axis (and the sequence-split axis for T1 decode attention,
:mod:`repro_torch.core.attention`). This slice ports the rules and the
sequence split; the rules' application to TP / FSDP layers
(``make_shard_fn``), the compressed collectives and the pipeline schedule
are slice 8b (ROADMAP.md).
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    P,
    Rules,
    local_shard,
    make_rules,
)
