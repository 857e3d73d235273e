"""Hand-written Hopper kernels for the FlashDecoding++ hot spots, each with
its plain PyTorch version and a launch counter.

Modules:
  * gemv             — ImplA CUDA-core GEMV (csrc/gemv.cu)
  * flat_gemm        — T2 flat GEMM, M padded to 8 (csrc/flat_gemm.cu)
  * decode_attention — T1 decode attention, unified-max and sync
                       (csrc/decode_attention.cu)
  * flash_prefill    — causal / windowed prefill attention, both schemes
                       (csrc/flash_prefill.cu)
  * merge            — the softmax-merge algebra of the plain versions
  * ops              — plan-dispatched front doors
  * ref              — plain PyTorch reference math (the "torch" backend)
  * _build           — nvcc build + ctypes loading of csrc/*.cu
"""
