// T2 — flat GEMM: (M, K) x (K, N) with M padded only to 8 (paper §4).
//
// Replaces: src/repro/kernels/flat_gemm.py::flat_gemm (_flat_gemm_kernel,
// and _flat_gemm_quant_kernel for int8 / fp8 weights), the TPU MXU kernel
// with a double-buffered K grid.
//
// Bound on H100: device-memory bytes for the decode shapes. With M <= 64
// token rows the work is 2*M*K*N FLOPs over ~K*N*2 weight bytes, i.e.
// <= 64 FLOP/byte against the ~295 FLOP/byte ridge of the bf16 tensor
// cores: the weight stream sets the time, so the kernel must read W
// once, keep loads in flight, and waste no tensor-core work on padding.
//
// Design:
//   * Operands swapped: each warp computes a 16 (N) x 8 (M) tile of
//     C^T = W^T x^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate), so
//     the wide N dimension fills the MMA's 16-row slot and up to 8 tokens
//     fill n8 — M is padded to 8, not to 64. One block covers BN columns
//     (BN/16 warps) and up to 64 token rows (8 n8 tiles per warp).
//   * K is streamed in BK tiles through shared memory, double-buffered
//     with cp.async (2 stages): tile k+1 lands while tile k is consumed.
//     Rows past M and columns past N are zero-filled by the copy itself
//     (src-size 0), so no host-side padding is needed.
//   * Split K where the columns alone leave SMs idle (the 896- and
//     128-wide decode GEMMs: 28 and 4 blocks on 132 SMs, each walking all
//     of K with two stages in flight, ~0.11 TB/s measured): `splits` fixed
//     K ranges of whole BK tiles form one thread-block cluster per output
//     tile, each block streams its range through a 4-stage ring, copying
//     only its live x rows, and the cluster sums the ranges' f32 partials
//     in split order through distributed shared memory before the one
//     epilogue (flat_stream.cuh's gemm_split_kernel). No atomics and no
//     scratch: a launch's bits are the same every time and under a CUDA
//     graph, and a row's bits do not depend on M (splits come from K, N
//     and the card). splits = 1 (the tied head fills the card) launches
//     the unsplit kernel.
//   * W is taken in two layouts, as in the GEMV: "KN" (row-major (K, N))
//     and "NK" (the transposed view of a row-major (N, K) tensor, e.g.
//     the tied LM head), read in place.
//   * BN and BK come from pick_bn/pick_bk (kernels/flat_gemm.py): the
//     paper's Eq. 5 trade of parallel blocks against x-tile reuse,
//     budgeted on the SM count and shared memory.
// Quantized weights halve the bytes: the codes stream at 1 byte and the
// per-output-channel step multiplies the f32 accumulator in the epilogue.
// The kernel itself is flat_stream.cuh's gemm_kernel (one weight stream,
// no residual); its mainloop is the one every streamed-weight kernel of
// the port shares, and decode_fuse.cu's oproj_residual is the same
// kernel with a residual epilogue.
#include "flat_stream.cuh"

using namespace repro;

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = x (M, K; row stride ldx) @ W, tiles (bn,
// bk), K in `splits` ranges (1 = unsplit; more needs bn = 32).
// w_kn = 1: W[k, n] at w[k*ldw + n]; w_kn = 0: W[k, n] at w[n*ldw + k].
// Needs K % 8 == 0 (and N % 8 == 0 for "KN") with 16-byte aligned rows.
REPRO_EXPORT int flat_gemm_bf16(const void* x, const void* w, void* out,
                                int M, int K, int N, long long ldx,
                                long long ldw, int w_kn, int bn, int bk,
                                int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_kn)
    return flat::dispatch_gemm<true, __nv_bfloat16>(
        bn, bk, splits, x, w, nullptr, nullptr, out, M, K, N, ldx, ldw, 0,
        st);
  return flat::dispatch_gemm<false, __nv_bfloat16>(
      bn, bk, splits, x, w, nullptr, nullptr, out, M, K, N, ldx, ldw, 0, st);
}

// Quantized weights (replaces _flat_gemm_quant_kernel): out (M, N) bf16 =
// bf16((x @ codes) * scale), codes (K, N) row-major int8 (fp8 = 0) or e4m3
// (fp8 = 1), leading dimension ldw, scale (N,) f32. The codes stream at 1
// byte (16 per cp.async) and become bf16 exactly in the fragment loads.
// Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned rows.
REPRO_EXPORT int flat_gemm_q8(const void* x, const void* w,
                              const void* scale, void* out, int M, int K,
                              int N, long long ldx, long long ldw, int bn,
                              int bk, int splits, int fp8, void* stream) {
  return flat::dispatch_gemm_q8<>(fp8, bn, bk, splits, x, w, scale, nullptr,
                                  out, M, K, N, ldx, ldw, 0,
                                  static_cast<cudaStream_t>(stream));
}
