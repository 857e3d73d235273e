"""Distribution layer: named-axis sharding rules over the port's mesh
(:mod:`repro_torch.launch.mesh`), and the collectives of the sharded
trainer (:mod:`repro_torch.distributed.collectives`).

The mesh contract (the JAX package's):
  * single pod:  (data=16, model=16)
  * multi-pod:   (pod=2, data=16, model=16)

``pod`` + ``data`` together form the batch/FSDP axes; ``model`` is the
tensor-parallel axis (and the sequence-split axis for T1 decode attention,
:mod:`repro_torch.core.attention`). The rules, the sequence split, the
TP / FSDP train layers (``make_shard_fn``, ``shard_tree``,
``gather_tree``), the int8-EF pod hop and the GPipe schedule over
``pod`` (:mod:`repro_torch.distributed.pipeline`) are ported.
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    P,
    Rules,
    gather_tree,
    local_shard,
    make_rules,
    make_shard_fn,
    shard_tree,
)
