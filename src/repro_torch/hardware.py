"""Hardware descriptions used by the kernels' tile pickers, the bounds
``chip_smoke.py`` reports and T3's cost models (``core/dispatch.py``).

The target is one NVIDIA H100 SXM. Every rate and size below is a
datasheet figure (NVIDIA's H100 data sheet and the Hopper architecture
white paper). The fixed costs the cost models add (a launch, a KV split
step, a chunk step, a host copy, a graph replay, a host dispatch, the
library GEMM's edge) are medians that ``chip_smoke.py``'s cost phase
measures on the card, written in with the card's name and power limit;
``PERF.md`` says how each was taken. The plan files' ``hardware`` hash
covers every field, so changing one strands every tuned plan.
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
      peak_flops_f32: f32 FLOP/s of the CUDA cores (outside the tensor
        cores): the GEMV (ImplA) cost model's compute rate.
      host_bw: host-to-device link bandwidth, bytes/s per direction (what
        a KV page pays to come back from the host tier).
      hbm_bytes: device-memory capacity.
      launch_s: the fixed device cost of one more kernel launch, back to
        back with the last (the flat GEMM's and every extra stage's
        launch term).
      kv_step_s: the device cost of one more 64-key split of a decode
        attention call, beyond its bytes.
      chunk_step_s: one chunked-prefill step's cost beyond its device
        work (the eager step's host time the card waits through).
      host_copy_s: one pinned host-to-device copy's fixed cost.
      loop_setup_s: a looped decode tick's cost beyond its device work
        (the CUDA graph replay's bubble).
      host_dispatch_s: the host time of one eager kernel launch.
      library_m_tile: the M tile the library GEMM (ImplC, cuBLAS) pads
        to.
      library_edge_s: the library GEMM's fixed cost a call.
    """

    name: str
    peak_flops_bf16: float
    hbm_bw: float
    num_sms: int
    smem_per_block: int
    l2_bytes: int
    peak_flops_f32: float
    host_bw: float
    hbm_bytes: int
    launch_s: float
    kv_step_s: float
    chunk_step_s: float
    host_copy_s: float
    loop_setup_s: float
    host_dispatch_s: float
    library_m_tile: int
    library_edge_s: float
    smem_per_sm: int = 233_472
    smem_reserved_per_block: int = 1_024
    regs_per_sm: int = 65_536
    gpcs: int = 8


# datasheet values, SXM part, dense rates (no sparsity), 700 W limit;
# the fixed costs are chip_smoke.py cost-phase medians (PERF.md)
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # datasheet
    hbm_bw=3.35e12,             # datasheet
    num_sms=132,                # datasheet
    smem_per_block=232_448,     # datasheet: 227 KB of the SM's 256 KB
    l2_bytes=50 * 2**20,        # datasheet
    peak_flops_f32=67e12,       # datasheet: f32 outside the tensor cores
    host_bw=64e9,               # datasheet: PCIe Gen5 x16, 128 GB/s both ways
    hbm_bytes=80 * 10**9,       # datasheet: 80 GB
    # chip_smoke.py cost phase, NVIDIA H100 80GB HBM3 at a 700.00 W limit
    launch_s=8.041e-07,         # noop probe, 1,000 launches in a graph
    kv_step_s=6.434e-08,        # row 3: 8,192 keys vs 1,024, less bytes
    chunk_step_s=2.411e-02,     # run E: chunk-step wall less device busy
    host_copy_s=1.173e-05,      # one 4 KB pinned copy and a synchronize
    loop_setup_s=2.526e-04,     # run J: looped tick wall less busy
    host_dispatch_s=7.239e-06,  # noop probe, 1,000 eager launches
    library_m_tile=64,          # cuBLAS pads M to 64 (the paper's criticism)
    library_edge_s=2.069e-06,   # 64 x 64 x 64 matmul, 1,000 in a graph
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


def matmul_flops(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def bytes_of(shape: tuple[int, ...], dtype_bytes: int = 2) -> int:
    n = dtype_bytes
    for s in shape:
        n *= s
    return n
