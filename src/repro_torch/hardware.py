"""Hardware descriptions used by the kernels' tile pickers and the bounds
``chip_smoke.py`` reports.

The target is one NVIDIA H100 SXM. Every value below is a datasheet
figure (NVIDIA's H100 data sheet and the Hopper architecture white
paper), not a measurement; measured numbers live in ``PERF.md`` beside
the card name and power limit they were taken at.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card hardware description.

    Attributes:
      peak_flops_bf16: dense bf16 tensor-core FLOP/s.
      hbm_bw: device-memory bandwidth, bytes/s.
      num_sms: streaming multiprocessors.
      smem_per_block: shared memory one block may claim (opt-in above
        48 KB as dynamic shared memory).
      l2_bytes: L2 cache capacity.
    """

    name: str
    peak_flops_bf16: float
    hbm_bw: float
    num_sms: int
    smem_per_block: int
    l2_bytes: int


# datasheet values, SXM part, dense rates (no sparsity), 700 W limit
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # datasheet
    hbm_bw=3.35e12,             # datasheet
    num_sms=132,                # datasheet
    smem_per_block=232_448,     # datasheet: 227 KB of the SM's 256 KB
    l2_bytes=50 * 2**20,        # datasheet
)

DEFAULT = H100_SXM
