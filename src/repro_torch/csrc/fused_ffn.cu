// T2 extension — fused FFN-up: h = act(x @ Wg) * (x @ Wu) in one kernel.
//
// Replaces: src/repro/kernels/fused_ffn.py::fused_ffn_up
// (_fused_ffn_kernel, both its bf16 and its quantized branch), the TPU
// kernel whose two K-stream pipelines share one x tile and whose epilogue
// applies the activation to the f32 accumulators before the only write.
//
// Two bodies: bf16 weights run ffn_wgmma.cuh's wgmma + TMA kernel (its
// header has the design); quantized weights run the mma.sync kernel
// described below, which turns each code into its exact bf16 value in
// its fragment loads.
//
// Bound on H100: device-memory bytes at decode and chunk shapes. The two
// weight streams (2 * K * N * 2 bytes) dominate; for M <= 256 token rows
// the work is 4 * M * K * N FLOPs, at most ~256 FLOP per weight byte,
// under the ~295 FLOP/byte ridge of the bf16 tensor cores. Fusing saves
// the second read of x, the (M, N) gate and up round trips through
// device memory and two of three launches.
//
// The quantized body: flat_gemm.cu's kernel with a second weight stream;
// the kernel itself lives in flat_stream.cuh (ffn_up_kernel, NORM =
// false), shared with decode_fuse.cu's ffn_norm, which adds an rmsnorm
// prologue.
//   * Operands swapped: each warp computes 16 (N) x 8 (M) tiles of
//     G^T = Wg^T x^T and U^T = Wu^T x^T with mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate), so N fills the MMA's 16-row slot and M is padded
//     to 8 in-kernel (masked, zero-filled copies), never on the host.
//   * A block covers BN columns (BN/16 warps) and 64 token rows; the grid
//     tiles M in 64-row blocks, so a one-shot prefill's B*S rows spread
//     over blockIdx.y instead of living in one block.
//   * K is streamed in BK tiles: one x tile and the two weight tiles per
//     stage, double-buffered with cp.async (2 stages).
//   * Epilogue: act(g) * u on the f32 accumulators (silu, or the tanh
//     gelu), rounded once to bf16; only h is written.
//   * Weights are row-major (K, N), as the model stores w_gate / w_up:
//     bf16, or 1-byte codes (int8 / e4m3) streamed at their width, with
//     the per-output-channel steps applied before the activation.
#include "ffn_wgmma.cuh"
#include "flat_stream.cuh"

using namespace repro;

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = act(x @ Wg) * (x @ Wu); x (M, K; row
// stride ldx), Wg/Wu contiguous row-major (K, N); act = silu (gelu = 0)
// or the tanh gelu (gelu = 1). The wgmma body: needs K % 8 == 0 and
// N % 8 == 0 with 16-byte aligned bases and ldx % 8 == 0.
REPRO_EXPORT int fused_ffn_up_bf16(const void* x, const void* wg,
                                   const void* wu, void* out, int M, int K,
                                   int N, long long ldx, int gelu,
                                   void* stream) {
  return tc::launch_ffn_up_wgmma(x, wg, wu, out, M, K, N, ldx, gelu,
                                 static_cast<cudaStream_t>(stream));
}

// Quantized weights (the quantized branch of _fused_ffn_kernel): Wg / Wu
// are (K, N) row-major codes, int8 (fp8 = 0) or e4m3 (fp8 = 1), with (N,)
// f32 steps sg / su applied to the accumulators before the activation.
// Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned rows.
REPRO_EXPORT int fused_ffn_up_q8(const void* x, const void* wg,
                                 const void* wu, const void* sg,
                                 const void* su, void* out, int M, int K,
                                 int N, long long ldx, int gelu, int bn,
                                 int bk, int fp8, void* stream) {
  return flat::dispatch_ffn_up_q8<false>(
      fp8, bn, bk, x, nullptr, wg, wu, sg, su, out, M, K, N, ldx, flat::kMT,
      gelu != 0, 0.f, static_cast<cudaStream_t>(stream));
}
