// T2 — flat GEMM: (M, K) x (K, N) with M padded only to 8 (paper §4).
//
// Replaces: src/repro/kernels/flat_gemm.py::flat_gemm (_flat_gemm_kernel),
// the TPU MXU kernel with a double-buffered K grid.
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
//   * W is taken in two layouts, as in the GEMV: "KN" (row-major (K, N))
//     and "NK" (the transposed view of a row-major (N, K) tensor, e.g.
//     the tied LM head), read in place.
//   * BN and BK come from pick_bn/pick_bk (kernels/flat_gemm.py): the
//     paper's Eq. 5 trade of parallel blocks against x-tile reuse,
//     budgeted on the SM count and shared memory.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMT = 64;  // token rows per block (8 n8 tiles)

template <int BN, int BK, bool KN>
struct Tile {
  static constexpr int kThreads = BN / 16 * 32;
  static constexpr int kXPitch = BK + 8;                 // xs[m][k]
  static constexpr int kWRows = KN ? BK : BN;
  static constexpr int kWPitch = KN ? BN + 8 : BK + 8;   // ws[k][n] / ws[n][k]
  static constexpr int kXElems = kMT * kXPitch;
  static constexpr int kWElems = kWRows * kWPitch;
  static constexpr int kStageElems = kXElems + kWElems;
  static constexpr size_t kSmemBytes = 2 * kStageElems * 2;
};

template <int BN, int BK, bool KN>
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* stage, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, int M, int K, int N, long long ldx,
    long long ldw, int m0, int n0, int k0) {
  using T = Tile<BN, BK, KN>;
  __nv_bfloat16* xs = stage;
  __nv_bfloat16* ws = stage + T::kXElems;
  constexpr int kXChunks = kMT * (BK / 8);
  for (int c = threadIdx.x; c < kXChunks; c += T::kThreads) {
    const int r = c / (BK / 8), cc = c % (BK / 8);
    const int gm = m0 + r, gk = k0 + cc * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(xs + r * T::kXPitch + cc * 8, ok ? x + gm * ldx + gk : x, ok);
  }
  if (KN) {
    constexpr int kWChunks = BK * (BN / 8);
    for (int c = threadIdx.x; c < kWChunks; c += T::kThreads) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      const int gk = k0 + r, gn = n0 + cc * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(ws + r * T::kWPitch + cc * 8, ok ? w + gk * ldw + gn : w,
                 ok);
    }
  } else {
    constexpr int kWChunks = BN * (BK / 8);
    for (int c = threadIdx.x; c < kWChunks; c += T::kThreads) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      const int gn = n0 + r, gk = k0 + cc * 8;
      const bool ok = gn < N && gk < K;
      cp_async16(ws + r * T::kWPitch + cc * 8, ok ? w + gn * ldw + gk : w,
                 ok);
    }
  }
}

template <int BN, int BK, bool KN>
__global__ void __launch_bounds__(BN / 16 * 32)
flat_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, int M, int K, int N,
                 long long ldx, long long ldw) {
  using T = Tile<BN, BK, KN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kMT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp * 16;                     // this warp's 16 columns
  const int nt = min(8, (M - m0 + 7) / 8);      // live n8 token tiles

  float c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;

  const int n_kt = (K + BK - 1) / BK;
  load_stage<BN, BK, KN>(stages, x, w, M, K, N, ldx, ldw, m0, n0, 0);
  cp_async_commit();

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt)
      load_stage<BN, BK, KN>(stages + ((kt + 1) & 1) * T::kStageElems, x, w,
                             M, K, N, ldx, ldw, m0, n0, (kt + 1) * BK);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait1();    // tile kt has landed
    __syncthreads();

    const __nv_bfloat16* xs = stages + (kt & 1) * T::kStageElems;
    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(xs);
    const uint16_t* ws16 =
        reinterpret_cast<const uint16_t*>(xs + T::kXElems);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      if (KN) {
        // element (n, k) of W^T sits at ws[k][n]
        const int ka = kk + 2 * t, na = wn + g;
        a[0] = pack2(ws16[ka * T::kWPitch + na],
                     ws16[(ka + 1) * T::kWPitch + na]);
        a[1] = pack2(ws16[ka * T::kWPitch + na + 8],
                     ws16[(ka + 1) * T::kWPitch + na + 8]);
        a[2] = pack2(ws16[(ka + 8) * T::kWPitch + na],
                     ws16[(ka + 9) * T::kWPitch + na]);
        a[3] = pack2(ws16[(ka + 8) * T::kWPitch + na + 8],
                     ws16[(ka + 9) * T::kWPitch + na + 8]);
      } else {
        const uint16_t* r0 = ws16 + (wn + g) * T::kWPitch + kk + 2 * t;
        const uint16_t* r8 = r0 + 8 * T::kWPitch;
        a[0] = *reinterpret_cast<const uint32_t*>(r0);
        a[1] = *reinterpret_cast<const uint32_t*>(r8);
        a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const uint16_t* xr = xs16 + (j * 8 + g) * T::kXPitch + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
          mma_bf16(c[j], a[0], a[1], a[2], a[3], b0, b1);
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
          out[static_cast<long long>(m) * N + n] = f2bf(c[j][i]);
      }
    }
  }
}

template <int BN, int BK, bool KN>
int launch(const void* x, const void* w, void* out, int M, int K, int N,
           long long ldx, long long ldw, cudaStream_t st) {
  using T = Tile<BN, BK, KN>;
  cudaError_t e = allow_smem(flat_gemm_kernel<BN, BK, KN>, T::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + kMT - 1) / kMT);
  flat_gemm_kernel<BN, BK, KN><<<grid, T::kThreads, T::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      M, K, N, ldx, ldw);
  return static_cast<int>(cudaGetLastError());
}

template <bool KN>
int dispatch(int bn, int bk, const void* x, const void* w, void* out, int M,
             int K, int N, long long ldx, long long ldw, cudaStream_t st) {
#define REPRO_FG_CASE(BN_, BK_)                                         \
  if (bn == BN_ && bk == BK_)                                           \
    return launch<BN_, BK_, KN>(x, w, out, M, K, N, ldx, ldw, st);
  REPRO_FG_CASE(32, 32)
  REPRO_FG_CASE(32, 64)
  REPRO_FG_CASE(32, 128)
  REPRO_FG_CASE(64, 32)
  REPRO_FG_CASE(64, 64)
  REPRO_FG_CASE(64, 128)
  REPRO_FG_CASE(128, 32)
  REPRO_FG_CASE(128, 64)
  REPRO_FG_CASE(128, 128)
#undef REPRO_FG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = x (M, K; row stride ldx) @ W, tiles (bn, bk).
// w_kn = 1: W[k, n] at w[k*ldw + n]; w_kn = 0: W[k, n] at w[n*ldw + k].
// Needs K % 8 == 0 (and N % 8 == 0 for "KN") with 16-byte aligned rows.
REPRO_EXPORT int flat_gemm_bf16(const void* x, const void* w, void* out,
                                int M, int K, int N, long long ldx,
                                long long ldw, int w_kn, int bn, int bk,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_kn) return dispatch<true>(bn, bk, x, w, out, M, K, N, ldx, ldw, st);
  return dispatch<false>(bn, bk, x, w, out, M, K, N, ldx, ldw, st);
}
