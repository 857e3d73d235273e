// T2 extension — fused FFN-up: h = act(x @ Wg) * (x @ Wu) in one kernel.
//
// Replaces: src/repro/kernels/fused_ffn.py::fused_ffn_up
// (_fused_ffn_kernel, both its bf16 and its quantized branch), the TPU
// kernel whose two K-stream pipelines share one x tile and whose epilogue
// applies the activation to the f32 accumulators before the only write.
//
// Bound on H100: device-memory bytes at decode and chunk shapes. The two
// weight streams (2 * K * N * 2 bytes, half that as codes) dominate; for
// M <= 256 token rows the work is 4 * M * K * N FLOPs, at most ~256 FLOP
// per bf16 weight byte, under the ~295 FLOP/byte ridge of the bf16 tensor
// cores. Fusing saves the second read of x, the (M, N) gate and up round
// trips through device memory and two of three launches.
//
// One body for both weight types: ffn_wgmma.cuh's wgmma + TMA kernel (its
// header has the design). Codes (int8 / e4m3) stream at 1 byte, become
// their exact bf16 values in shared memory before the products, and
// their per-output-channel steps multiply the f32 sums before the
// activation.
#include "ffn_wgmma.cuh"

using namespace repro;

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = act(x @ Wg) * (x @ Wu); x (M, K; row
// stride ldx), Wg/Wu contiguous row-major (K, N); act = silu (gelu = 0)
// or the tanh gelu (gelu = 1). Needs K % 8 == 0 and N % 8 == 0 with
// 16-byte aligned bases and ldx % 8 == 0.
REPRO_EXPORT int fused_ffn_up_bf16(const void* x, const void* wg,
                                   const void* wu, void* out, int M, int K,
                                   int N, long long ldx, int gelu,
                                   void* stream) {
  return tc::launch_ffn_up_wgmma<__nv_bfloat16>(
      x, wg, wu, nullptr, nullptr, out, M, K, N, ldx, gelu,
      static_cast<cudaStream_t>(stream));
}

// Quantized weights (the quantized branch of _fused_ffn_kernel): Wg / Wu
// are (K, N) row-major codes, int8 (fp8 = 0) or e4m3 (fp8 = 1), with (N,)
// f32 steps sg / su applied to the sums before the activation.
// Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned rows.
REPRO_EXPORT int fused_ffn_up_q8(const void* x, const void* wg,
                                 const void* wu, const void* sg,
                                 const void* su, void* out, int M, int K,
                                 int N, long long ldx, int gelu, int fp8,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return tc::launch_ffn_up_wgmma<__nv_fp8_e4m3>(x, wg, wu, sg, su, out, M,
                                                  K, N, ldx, gelu, st);
  return tc::launch_ffn_up_wgmma<int8_t>(x, wg, wu, sg, su, out, M, K, N,
                                         ldx, gelu, st);
}
