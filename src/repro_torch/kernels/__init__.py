"""Hand-written Hopper kernels for the FlashDecoding++ hot spots, each with
its plain PyTorch version and a launch counter.

Modules:
  * gemv             — ImplA CUDA-core GEMV (csrc/gemv.cu)
  * flat_gemm        — T2 flat GEMM at small M (csrc/flat_gemm.cu: the
                       wgmma body in csrc/gemm_wgmma.cuh, the narrow-N
                       split body in csrc/flat_stream.cuh)
  * fused_ffn        — fused FFN-up act(x@Wg) * (x@Wu), two weight streams
                       and an activation epilogue (csrc/fused_ffn.cu, the
                       wgmma body in csrc/ffn_wgmma.cuh)
  * decode_fuse      — the fused decode stages: rmsnorm → QKV → bias → rope,
                       resid + o@Wo (o_proj and down), rmsnorm → gate/up →
                       act (csrc/decode_fuse.cu; o_proj runs flat_gemm's
                       bodies with a residual epilogue)
  * decode_attention — T1 decode attention over the dense cache or the
                       paged pool, unified-max and sync
                       (csrc/decode_attention.cu)
  * group_attention  — grouped prefix-shared decode attention, two stages
                       (csrc/group_attention.cu)
  * chunk_attention  — fused paged chunk-prefill attention, both schemes
                       (csrc/chunk_attention.cu)
  * flash_prefill    — causal / windowed prefill attention, both schemes
                       (csrc/flash_prefill.cu)
  * merge            — the softmax-merge algebra of the plain versions
  * ops              — plan-dispatched front doors, and LAUNCH_COUNTERS
                       (every wrapper that counts its launches)
  * ref              — plain PyTorch reference math (the "torch" backend)
  * _build           — nvcc build + ctypes loading of csrc/*.cu
"""
