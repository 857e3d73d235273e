// Fused decode-layer stages: the three seams of DecodeFusionPlan.
//
// Replaces: src/repro/kernels/decode_fuse.py
//   * decode_ingest_fused (_ingest_kernel): rmsnorm -> x @ [Wq Wk Wv] ->
//     bias -> rope, the normed x resident in VMEM across the K grid;
//   * oproj_residual_fused (_oproj_kernel): resid + o @ Wo, serving both
//     the o_proj and the FFN down projection;
//   * ffn_norm_fused (_ffn_norm_kernel): rmsnorm -> x @ Wg, x @ Wu ->
//     act(g) * u on the f32 accumulators.
//
// Bound on H100: device-memory bytes. At decode M (the slot count) every
// seam is a flat GEMM: 2 * M * K * N FLOPs per K * N * 2 weight bytes,
// at most 64 FLOP per byte against the ~295 FLOP/byte ridge of the bf16
// tensor cores, so the weight stream sets the time. Fusing moves no
// fewer weight bytes; it removes the normed x, the pre-rope q/k, the
// attention output's residual add and the gate/up activations as round
// trips through device memory, and most of the launches: four per layer
// in place of seven GEMM launches and about twenty elementwise ops.
//
// Design: the TPU kernels walk one sequential grid with a normed-x
// scratch in VMEM; here every block is independent, so every block that
// needs the normed rows computes them itself (flat_stream.cuh's
// norm_rows: same reduction order in every block, so the same bits).
//   * decode_ingest: a block owns one head, a head_dim-column tile of one
//     of the q, k or v streams (grid HQ + 2 * HK blocks, three weight
//     pointers, no concatenated copy). Epilogue, at the split chain's
//     rounding points: the f32 accumulator rounds to bf16, adds the bf16
//     bias (rounded again), and the rows are staged in shared memory so
//     that rope can pair column i with i + head_dim / 2, which another
//     warp computed; rope runs in f32 with the angle pos * theta^(-i/half)
//     and rounds once. v gets no rope; absent biases read as zero.
//   * oproj_residual: flat_gemm.cu's kernel itself (flat_stream.cuh's
//     gemm_kernel: x streamed, 2-stage cp.async) with its residual
//     epilogue: the accumulator rounds to bf16 and the kernel writes
//     resid + acc, rounded once, as `resid + matmul(o, wo)` does.
//   * ffn_norm: fused_ffn.cu's kernel (flat_stream.cuh's ffn_up_kernel)
//     with the rmsnorm prologue and x resident.
// The resident kernels hold `mt` token rows per block (the host picks mt
// so that the rows and two weight stages fit shared memory) and tile M
// over blockIdx.y. None uses atomics: a replayed step gives the same bits.
//
// Quantized weights (the quantized branches of the three TPU kernels): each
// kernel is templated on the weight element type, and the *_q8 entries take
// (K, N) int8 or e4m3 codes, streamed at 1 byte, with one f32 step per
// output channel. The steps multiply the f32 accumulators at the JAX
// kernels' points: before the bf16 rounding, the bias and rope (ingest),
// before the rounding and the residual add (oproj_residual), before the
// activation (ffn_norm).
#include "flat_stream.cuh"

#include <algorithm>

using namespace repro;
using flat::Streams;
using flat::Tile;

namespace {

template <int BN, int BK, typename WT>
__global__ void __launch_bounds__(BN / 16 * 32)
ingest_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ scale,
              const WT* __restrict__ wq, const WT* __restrict__ wk,
              const WT* __restrict__ wv, const float* __restrict__ sq,
              const float* __restrict__ sk, const float* __restrict__ sv,
              const __nv_bfloat16* __restrict__ bq,
              const __nv_bfloat16* __restrict__ bk,
              const __nv_bfloat16* __restrict__ bv,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ oq,
              __nv_bfloat16* __restrict__ ok, __nv_bfloat16* __restrict__ ov,
              int M, int K, int NQ, int NK, long long ldx, int mt, int rope,
              float theta, float eps) {
  using T = Tile<BN, BK, 1, true, true, WT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem + T::kStagesBytes);
  const int xn_pitch = flat::resident_pitch(K, BK);

  // which stream and which head of it this block owns
  const int q_blocks = NQ / BN, k_blocks = NK / BN;
  const int bx = blockIdx.x;
  int stream = 0, n0 = bx * BN;
  if (bx >= q_blocks + k_blocks) {
    stream = 2;
    n0 = (bx - q_blocks - k_blocks) * BN;
  } else if (bx >= q_blocks) {
    stream = 1;
    n0 = (bx - q_blocks) * BN;
  }
  const WT* w = stream == 0 ? wq : stream == 1 ? wk : wv;
  const float* step = stream == 0 ? sq : stream == 1 ? sk : sv;
  const __nv_bfloat16* bias = stream == 0 ? bq : stream == 1 ? bk : bv;
  __nv_bfloat16* out = stream == 0 ? oq : stream == 1 ? ok : ov;
  const int N = stream == 0 ? NQ : NK;

  const int m0 = blockIdx.y * mt;
  const int nt = min(mt / 8, (M - m0 + 7) / 8);  // live n8 token tiles
  flat::norm_rows(xn, xn_pitch, x, ldx, scale, M, K, m0, nt * 8, eps);
  __syncthreads();
  float acc[1][8][4];
  flat::mainloop<BN, BK, 1, true, true, WT>(smem, xn, xn_pitch, nullptr, 0,
                                            Streams<1, WT>{{w}}, N, M, K, N,
                                            m0, n0, nt, acc);

  // (scale,) round, add the bias, stage the head's rows: ys[r][c], c < BN,
  // over the stages and the resident rows, dead after the mainloop (the
  // launch gives at least mt * BN bf16 of shared memory)
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = j * 8 + 2 * t + (i & 1);
        const int c = warp * 16 + g + (i >> 1) * 8;
        const float b = bias != nullptr ? bf2f(bias[n0 + c]) : 0.f;
        float a = acc[0][j][i];
        if constexpr (flat::kIsCode<WT>) a *= step[n0 + c];
        ys[r * BN + c] = f2bf(bf2f(f2bf(a)) + b);
      }
    }
  }
  __syncthreads();

  // rope on (i, i + half) of q and k in f32, one rounding; v as staged.
  // __fmul_rn / __fadd_rn keep the split chain's separate roundings
  // (no contraction into fma).
  constexpr int kHalf = BN / 2;
  for (int e = threadIdx.x; e < nt * 8 * kHalf; e += T::kThreads) {
    const int r = e / kHalf, i = e % kHalf;
    const int gm = m0 + r;
    if (gm >= M) continue;
    const float x1 = bf2f(ys[r * BN + i]), x2 = bf2f(ys[r * BN + i + kHalf]);
    float o1 = x1, o2 = x2;
    if (rope && stream < 2) {
      const float freq =
          powf(theta, -static_cast<float>(i) / static_cast<float>(kHalf));
      const float ang = static_cast<float>(pos[gm]) * freq;
      float sn, cs;
      sincosf(ang, &sn, &cs);
      o1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
      o2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
    }
    __nv_bfloat16* row = out + static_cast<long long>(gm) * N + n0;
    row[i] = f2bf(o1);
    row[i + kHalf] = f2bf(o2);
  }
}

template <int BN, int BK, typename WT>
int launch_ingest(const void* x, const void* scale, const void* wq,
                  const void* wk, const void* wv, const void* sq,
                  const void* sk, const void* sv, const void* bq,
                  const void* bk, const void* bv, const int* pos, void* oq,
                  void* ok, void* ov, int M, int K, int NQ, int NK,
                  long long ldx, int mt, int rope, float theta, float eps,
                  cudaStream_t st) {
  using T = Tile<BN, BK, 1, true, true, WT>;
  const size_t smem = std::max(
      T::kStagesBytes +
          static_cast<size_t>(mt) * flat::resident_pitch(K, BK) * 2,
      static_cast<size_t>(mt) * BN * 2);
  cudaError_t e = allow_smem(ingest_kernel<BN, BK, WT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  using B = __nv_bfloat16;
  using F = float;
  dim3 grid(NQ / BN + 2 * (NK / BN), (M + mt - 1) / mt);
  ingest_kernel<BN, BK, WT><<<grid, T::kThreads, smem, st>>>(
      static_cast<const B*>(x), static_cast<const B*>(scale),
      static_cast<const WT*>(wq), static_cast<const WT*>(wk),
      static_cast<const WT*>(wv), static_cast<const F*>(sq),
      static_cast<const F*>(sk), static_cast<const F*>(sv),
      static_cast<const B*>(bq),
      static_cast<const B*>(bk), static_cast<const B*>(bv), pos,
      static_cast<B*>(oq), static_cast<B*>(ok), static_cast<B*>(ov), M, K,
      NQ, NK, ldx, mt, rope, theta, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int dispatch_ingest(int head_dim, int bkt, const void* x, const void* scale,
                    const void* wq, const void* wk, const void* wv,
                    const void* sq, const void* sk, const void* sv,
                    const void* bq, const void* bk, const void* bv,
                    const void* pos, void* oq, void* ok, void* ov, int M,
                    int K, int NQ, int NK, long long ldx, int mt, int rope,
                    float theta, float eps, cudaStream_t st) {
  const int* p = static_cast<const int*>(pos);
#define REPRO_IN_CASE(BN_, BK_)                                            \
  if (head_dim == BN_ && bkt == BK_)                                       \
    return launch_ingest<BN_, BK_, WT>(x, scale, wq, wk, wv, sq, sk, sv,   \
                                       bq, bk, bv, p, oq, ok, ov, M, K,    \
                                       NQ, NK, ldx, mt, rope, theta, eps,  \
                                       st);
  REPRO_IN_CASE(32, 32)
  REPRO_IN_CASE(32, 64)
  REPRO_IN_CASE(32, 128)
  REPRO_IN_CASE(64, 32)
  REPRO_IN_CASE(64, 64)
  REPRO_IN_CASE(64, 128)
  REPRO_IN_CASE(128, 32)
  REPRO_IN_CASE(128, 64)
  REPRO_IN_CASE(128, 128)
#undef REPRO_IN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (M, NQ), k / v (M, NK) row-major bf16 = rope(rmsnorm(x) @ W + b) for
// q and k, rmsnorm(x) @ Wv + bv for v; x (M, K; row stride ldx), scale
// (K,), W row-major (K, N), biases (N,) or null (zero), pos (M,) int32.
// head_dim (32, 64 or 128) is the block's column tile and must divide NQ
// and NK; tiles (bk, mt). Needs K % 8 == 0 with 16-byte aligned rows.
REPRO_EXPORT int decode_ingest_bf16(const void* x, const void* scale,
                                    const void* wq, const void* wk,
                                    const void* wv, const void* bq,
                                    const void* bk, const void* bv,
                                    const void* pos, void* oq, void* ok,
                                    void* ov, int M, int K, int NQ, int NK,
                                    long long ldx, int head_dim, int bkt,
                                    int mt, int rope, float theta, float eps,
                                    void* stream) {
  return dispatch_ingest<__nv_bfloat16>(
      head_dim, bkt, x, scale, wq, wk, wv, nullptr, nullptr, nullptr, bq,
      bk, bv, pos, oq, ok, ov, M, K, NQ, NK, ldx, mt, rope, theta, eps,
      static_cast<cudaStream_t>(stream));
}

// decode_ingest_bf16 with quantized weights: wq / wk / wv (K, N) row-major
// codes, int8 (fp8 = 0) or e4m3 (fp8 = 1), and their (N,) f32 steps sq /
// sk / sv; q, k, v = rope(bf16(acc * step) + b). Needs N % 16 == 0 too.
REPRO_EXPORT int decode_ingest_q8(const void* x, const void* scale,
                                  const void* wq, const void* wk,
                                  const void* wv, const void* sq,
                                  const void* sk, const void* sv,
                                  const void* bq, const void* bk,
                                  const void* bv, const void* pos, void* oq,
                                  void* ok, void* ov, int M, int K, int NQ,
                                  int NK, long long ldx, int head_dim,
                                  int bkt, int mt, int rope, float theta,
                                  float eps, int fp8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return dispatch_ingest<__nv_fp8_e4m3>(
        head_dim, bkt, x, scale, wq, wk, wv, sq, sk, sv, bq, bk, bv, pos,
        oq, ok, ov, M, K, NQ, NK, ldx, mt, rope, theta, eps, st);
  return dispatch_ingest<int8_t>(head_dim, bkt, x, scale, wq, wk, wv, sq, sk,
                                 sv, bq, bk, bv, pos, oq, ok, ov, M, K, NQ,
                                 NK, ldx, mt, rope, theta, eps, st);
}

// out (M, N) row-major bf16 = resid + bf16(o @ W); o (M, K; row stride
// ldo), W row-major (K, N), resid (M, N; row stride ldr); tiles (bn, bk),
// K in `splits` ranges summed in order (flat_gemm.cu's split K).
// Needs K % 8 == 0 and N % 8 == 0 with 16-byte aligned rows.
REPRO_EXPORT int oproj_residual_bf16(const void* o, const void* w,
                                     const void* resid, void* out, int M,
                                     int K, int N, long long ldo,
                                     long long ldr, int bn, int bkt,
                                     int splits, void* stream) {
  return flat::dispatch_gemm<true, __nv_bfloat16>(
      bn, bkt, splits, o, w, nullptr, resid, out, M, K, N, ldo, N, ldr,
      static_cast<cudaStream_t>(stream));
}

// oproj_residual_bf16 with quantized weights: W (K, N) row-major codes,
// int8 (fp8 = 0) or e4m3 (fp8 = 1), steps (N,) f32; out = resid +
// bf16(acc * step). Needs N % 16 == 0.
REPRO_EXPORT int oproj_residual_q8(const void* o, const void* w,
                                   const void* wscale, const void* resid,
                                   void* out, int M, int K, int N,
                                   long long ldo, long long ldr, int bn,
                                   int bkt, int splits, int fp8,
                                   void* stream) {
  return flat::dispatch_gemm_q8<>(fp8, bn, bkt, splits, o, w, wscale, resid,
                                  out, M, K, N, ldo, N, ldr,
                                  static_cast<cudaStream_t>(stream));
}

// out (M, N) row-major bf16 = act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu);
// x (M, K; row stride ldx), scale (K,), Wg / Wu row-major (K, N); act =
// silu (gelu = 0) or the tanh gelu (gelu = 1); tiles (bn, bk, mt). Needs
// K % 8 == 0 and N % 8 == 0 with 16-byte aligned rows.
REPRO_EXPORT int ffn_norm_bf16(const void* x, const void* scale,
                               const void* wg, const void* wu, void* out,
                               int M, int K, int N, long long ldx, int gelu,
                               int bn, int bkt, int mt, float eps,
                               void* stream) {
  return flat::dispatch_ffn_up<true, __nv_bfloat16>(
      bn, bkt, x, scale, wg, wu, nullptr, nullptr, out, M, K, N, ldx, mt,
      gelu != 0, eps, static_cast<cudaStream_t>(stream));
}

// ffn_norm_bf16 with quantized weights: Wg / Wu (K, N) row-major codes,
// int8 (fp8 = 0) or e4m3 (fp8 = 1), steps sg / su (N,) f32 applied before
// the activation. Needs N % 16 == 0.
REPRO_EXPORT int ffn_norm_q8(const void* x, const void* scale,
                             const void* wg, const void* wu, const void* sg,
                             const void* su, void* out, int M, int K, int N,
                             long long ldx, int gelu, int bn, int bkt,
                             int mt, float eps, int fp8, void* stream) {
  return flat::dispatch_ffn_up_q8<true>(
      fp8, bn, bkt, x, scale, wg, wu, sg, su, out, M, K, N, ldx, mt,
      gelu != 0, eps, static_cast<cudaStream_t>(stream));
}
