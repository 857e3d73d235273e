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
      smem_per_sm: shared memory of one SM, shared by its resident
        blocks (each also holds smem_reserved_per_block of it).
      regs_per_sm: 32-bit registers of one SM.
      gpcs: graphics processing clusters; a thread-block cluster's blocks
        run on the SMs of one GPC.
    """

    name: str
    peak_flops_bf16: float
    hbm_bw: float
    num_sms: int
    smem_per_block: int
    l2_bytes: int
    smem_per_sm: int = 233_472
    smem_reserved_per_block: int = 1_024
    regs_per_sm: int = 65_536
    gpcs: int = 8


# datasheet values, SXM part, dense rates (no sparsity), 700 W limit
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # datasheet
    hbm_bw=3.35e12,             # datasheet
    num_sms=132,                # datasheet
    smem_per_block=232_448,     # datasheet: 227 KB of the SM's 256 KB
    l2_bytes=50 * 2**20,        # datasheet
    smem_per_sm=233_472,        # datasheet: 228 KB
    smem_reserved_per_block=1_024,  # CUDA programming guide, cc 9.0
    regs_per_sm=65_536,         # datasheet
    gpcs=8,                     # Hopper white paper: GH100's 8 GPCs
)


def cluster_slots(spec: HardwareSpec, size: int, per_sm: int) -> int:
    """Clusters of ``size`` blocks the card runs at once when an SM holds
    ``per_sm`` of the kernel's blocks. A cluster's blocks share one GPC,
    and the SMs are not spread evenly over the GPCs, so each GPC counts
    floor(num_sms / gpcs) SMs: a lower bound that keeps a grid chosen as
    one wave from spilling into a second."""
    return spec.gpcs * (spec.num_sms // spec.gpcs * per_sm // size)


DEFAULT = H100_SXM
