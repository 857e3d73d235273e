// T2 extension — fused FFN-up: h = act(x @ Wg) * (x @ Wu) in one kernel.
//
// Replaces: src/repro/kernels/fused_ffn.py::fused_ffn_up
// (_fused_ffn_kernel), the TPU kernel whose two K-stream pipelines share
// one x tile and whose epilogue applies the activation to the f32
// accumulators before the only write.
//
// Bound on H100: device-memory bytes at decode and chunk shapes. The two
// weight streams (2 * K * N * 2 bytes) dominate; for M <= 256 token rows
// the work is 4 * M * K * N FLOPs, at most ~256 FLOP per weight byte,
// under the ~295 FLOP/byte ridge of the bf16 tensor cores. Fusing saves
// the second read of x, the (M, N) gate and up round trips through
// device memory and two of three launches.
//
// Design: flat_gemm.cu's kernel with a second weight stream.
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
//   * Weights are row-major (K, N), as the model stores w_gate / w_up.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMT = 64;  // token rows per block (8 n8 tiles)

template <int BN, int BK>
struct Tile {
  static constexpr int kThreads = BN / 16 * 32;
  static constexpr int kXPitch = BK + 8;    // xs[m][k]
  static constexpr int kWPitch = BN + 8;    // ws[k][n]
  static constexpr int kXElems = kMT * kXPitch;
  static constexpr int kWElems = BK * kWPitch;
  static constexpr int kStageElems = kXElems + 2 * kWElems;
  static constexpr size_t kSmemBytes = 2 * kStageElems * 2;
};

template <int BN, int BK>
__device__ __forceinline__ void load_w(__nv_bfloat16* ws,
                                       const __nv_bfloat16* __restrict__ w,
                                       int K, int N, int n0, int k0) {
  using T = Tile<BN, BK>;
  constexpr int kChunks = BK * (BN / 8);
  for (int c = threadIdx.x; c < kChunks; c += T::kThreads) {
    const int r = c / (BN / 8), cc = c % (BN / 8);
    const int gk = k0 + r, gn = n0 + cc * 8;
    const bool ok = gk < K && gn < N;
    cp_async16(ws + r * T::kWPitch + cc * 8,
               ok ? w + static_cast<long long>(gk) * N + gn : w, ok);
  }
}

template <int BN, int BK>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* stage, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wg,
    const __nv_bfloat16* __restrict__ wu, int M, int K, int N,
    long long ldx, int m0, int n0, int k0) {
  using T = Tile<BN, BK>;
  __nv_bfloat16* xs = stage;
  constexpr int kXChunks = kMT * (BK / 8);
  for (int c = threadIdx.x; c < kXChunks; c += T::kThreads) {
    const int r = c / (BK / 8), cc = c % (BK / 8);
    const int gm = m0 + r, gk = k0 + cc * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(xs + r * T::kXPitch + cc * 8, ok ? x + gm * ldx + gk : x, ok);
  }
  load_w<BN, BK>(stage + T::kXElems, wg, K, N, n0, k0);
  load_w<BN, BK>(stage + T::kXElems + T::kWElems, wu, K, N, n0, k0);
}

// A fragment of W^T (16 columns n of this warp x 16 k) from ws[k][n].
template <int BN, int BK>
__device__ __forceinline__ void w_frag(const uint16_t* ws16, int kk, int wn,
                                       int g, int t, uint32_t* a) {
  using T = Tile<BN, BK>;
  const int ka = kk + 2 * t, na = wn + g;
  a[0] = pack2(ws16[ka * T::kWPitch + na], ws16[(ka + 1) * T::kWPitch + na]);
  a[1] = pack2(ws16[ka * T::kWPitch + na + 8],
               ws16[(ka + 1) * T::kWPitch + na + 8]);
  a[2] = pack2(ws16[(ka + 8) * T::kWPitch + na],
               ws16[(ka + 9) * T::kWPitch + na]);
  a[3] = pack2(ws16[(ka + 8) * T::kWPitch + na + 8],
               ws16[(ka + 9) * T::kWPitch + na + 8]);
}

__device__ __forceinline__ float activate(float g, bool gelu) {
  if (gelu) {
    // tanh approximation, jax.nn.gelu's default
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    return 0.5f * g * (1.f + tanhf(inner));
  }
  return g / (1.f + expf(-g));
}

template <int BN, int BK>
__global__ void __launch_bounds__(BN / 16 * 32)
fused_ffn_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wg,
                 const __nv_bfloat16* __restrict__ wu,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                 long long ldx, bool gelu) {
  using T = Tile<BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kMT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp * 16;                     // this warp's 16 columns
  const int nt = min(8, (M - m0 + 7) / 8);      // live n8 token tiles

  float cg[8][4], cu[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) cg[j][i] = cu[j][i] = 0.f;

  const int n_kt = (K + BK - 1) / BK;
  load_stage<BN, BK>(stages, x, wg, wu, M, K, N, ldx, m0, n0, 0);
  cp_async_commit();

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt)
      load_stage<BN, BK>(stages + ((kt + 1) & 1) * T::kStageElems, x, wg,
                         wu, M, K, N, ldx, m0, n0, (kt + 1) * BK);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait1();    // tile kt has landed
    __syncthreads();

    const __nv_bfloat16* stage = stages + (kt & 1) * T::kStageElems;
    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(stage);
    const uint16_t* wg16 =
        reinterpret_cast<const uint16_t*>(stage + T::kXElems);
    const uint16_t* wu16 = wg16 + T::kWElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t ag[4], au[4];
      w_frag<BN, BK>(wg16, kk, wn, g, t, ag);
      w_frag<BN, BK>(wu16, kk, wn, g, t, au);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const uint16_t* xr = xs16 + (j * 8 + g) * T::kXPitch + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
          mma_bf16(cg[j], ag[0], ag[1], ag[2], ag[3], b0, b1);
          mma_bf16(cu[j], au[0], au[1], au[2], au[3], b0, b1);
        }
      }
    }
    __syncthreads();     // stage kt may be refilled next iteration
  }

  // C^T fragment: c0,c1 at (n = g, m = 2t, 2t+1); c2,c3 at (n = g + 8, ...)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + j * 8 + 2 * t + (i & 1);
        const int n = n0 + wn + g + (i >> 1) * 8;
        if (m < M && n < N)
          out[static_cast<long long>(m) * N + n] =
              f2bf(activate(cg[j][i], gelu) * cu[j][i]);
      }
    }
  }
}

template <int BN, int BK>
int launch(const void* x, const void* wg, const void* wu, void* out, int M,
           int K, int N, long long ldx, bool gelu, cudaStream_t st) {
  using T = Tile<BN, BK>;
  cudaError_t e = allow_smem(fused_ffn_kernel<BN, BK>, T::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + kMT - 1) / kMT);
  fused_ffn_kernel<BN, BK><<<grid, T::kThreads, T::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu),
      static_cast<__nv_bfloat16*>(out), M, K, N, ldx, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = act(x @ Wg) * (x @ Wu); x (M, K; row
// stride ldx), Wg/Wu row-major (K, N); act = silu (gelu = 0) or the tanh
// gelu (gelu = 1); tiles (bn, bk). Needs K % 8 == 0 and N % 8 == 0 with
// 16-byte aligned rows.
REPRO_EXPORT int fused_ffn_up_bf16(const void* x, const void* wg,
                                   const void* wu, void* out, int M, int K,
                                   int N, long long ldx, int gelu, int bn,
                                   int bk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ge = gelu != 0;
#define REPRO_FF_CASE(BN_, BK_)                                          \
  if (bn == BN_ && bk == BK_)                                            \
    return launch<BN_, BK_>(x, wg, wu, out, M, K, N, ldx, ge, st);
  REPRO_FF_CASE(32, 32)
  REPRO_FF_CASE(32, 64)
  REPRO_FF_CASE(32, 128)
  REPRO_FF_CASE(64, 32)
  REPRO_FF_CASE(64, 64)
  REPRO_FF_CASE(64, 128)
  REPRO_FF_CASE(128, 32)
  REPRO_FF_CASE(128, 64)
  REPRO_FF_CASE(128, 128)
#undef REPRO_FF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
