// T2 — flat GEMM: (M, K) x (K, N) at small M (paper §4).
//
// Replaces: src/repro/kernels/flat_gemm.py::flat_gemm (_flat_gemm_kernel,
// and _flat_gemm_quant_kernel for int8 / fp8 weights), the TPU MXU kernel
// with a double-buffered K grid.
//
// Bound on H100: device-memory bytes for the decode shapes. With M < 128
// token rows the work is 2*M*K*N FLOPs over ~K*N*2 weight bytes, under
// the ~295 FLOP/byte ridge of the bf16 tensor cores: the weight stream
// sets the time, so the kernel must read W once, keep loads in flight,
// and waste no tensor-core work on padding.
//
// Two bodies, chosen by kernels/flat_gemm.py::gemm_tiles from K, N and
// the card (never M):
//   * gemm_wgmma.cuh (every N wide enough that 32-column blocks alone
//     fill the card: gate / up, the tied head): wgmma.m64n64k16 with the
//     operands swapped (64 output columns x a fixed 64-row token operand),
//     W and x by TMA into a 4-stage mbarrier ring (128-byte swizzle; W
//     MN-major through the transpose bit, or K-major for the tied head's
//     (N, K) view), one producer warp and one consumer warpgroup, K split
//     over a thread-block cluster where 64-column tiles leave SMs idle;
//     its header has the design.
//   * flat_stream.cuh's gemm_split_kernel (narrow N: the 896- and
//     128-wide decode GEMMs): mma.sync.m16n8k16 with the operands
//     swapped, `splits` fixed K ranges of whole BK tiles, one
//     thread-block cluster per output tile summing the ranges' f32
//     partials in split order through distributed shared memory, each
//     block streaming its range through a 4-stage cp.async ring.
// No atomics and no scratch in either: a launch's bits are the same
// every time and under a CUDA graph, and a row's bits do not depend on M.
// Quantized weights halve the bytes: the codes stream at 1 byte and the
// per-output-channel step multiplies the f32 sum in the epilogue.
// decode_fuse.cu's oproj_residual runs the same bodies with a residual
// epilogue.
#include "gemm_wgmma.cuh"

using namespace repro;

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = x (M, K; row stride ldx) @ W; split = 1
// runs the narrow-N split body at BK = bk, 0 the wgmma body (bk = 64);
// K in `splits` ranges either way.
// w_kn = 1: W[k, n] at w[k*ldw + n]; w_kn = 0: W[k, n] at w[n*ldw + k].
// Needs K % 8 == 0 with 16-byte aligned rows of x, and of W for the wgmma
// body and for w_kn = 0 (ldw % 8 == 0); a w_kn = 1 weight of any N and
// ldw runs on the split body, its unaligned rows through the tail loads
// (flat_stream.cuh's load_w).
REPRO_EXPORT int flat_gemm_bf16(const void* x, const void* w, void* out,
                                int M, int K, int N, long long ldx,
                                long long ldw, int w_kn, int split, int bk,
                                int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_kn)
    return gw::dispatch<true, __nv_bfloat16>(split, bk, splits, x, w,
                                             nullptr, nullptr, out, M, K, N,
                                             ldx, ldw, 0, st);
  return gw::dispatch<false, __nv_bfloat16>(split, bk, splits, x, w, nullptr,
                                            nullptr, out, M, K, N, ldx, ldw,
                                            0, st);
}

// Quantized weights (replaces _flat_gemm_quant_kernel): out (M, N) bf16 =
// bf16((x @ codes) * scale), codes (K, N) row-major int8 (fp8 = 0) or e4m3
// (fp8 = 1), leading dimension ldw, scale (N,) f32. The codes stream at 1
// byte and become bf16 exactly before the products.
// Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned rows.
REPRO_EXPORT int flat_gemm_q8(const void* x, const void* w,
                              const void* scale, void* out, int M, int K,
                              int N, long long ldx, long long ldw, int split,
                              int bk, int splits, int fp8, void* stream) {
  return gw::dispatch_q8(fp8, split, bk, splits, x, w, scale, nullptr, out,
                         M, K, N, ldx, ldw, 0,
                         static_cast<cudaStream_t>(stream));
}
