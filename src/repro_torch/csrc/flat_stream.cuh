// The flat-GEMM mainloop and the kernels built on it, shared by
// flat_gemm.cu, fused_ffn.cu and decode_fuse.cu: S weight streams, with x
// either streamed beside the weights or resident in shared memory after
// an rmsnorm prologue.
//
//   * Operands swapped: each warp computes 16 (N) x 8 (M) tiles of
//     C^T = W^T x^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate), so N
//     fills the MMA's 16-row slot and the token rows fill n8: M is padded
//     to 8 in-kernel (masked, zero-filled copies), never on the host.
//   * A block covers BN columns (BN/16 warps) of each of its S weight
//     streams and up to 8 n8 tiles of token rows. W is read in place in
//     one of two layouts: "KN" (row-major (K, N), leading dimension ldw)
//     or "NK" (the transposed view of a row-major (N, K) tensor, e.g. the
//     tied LM head).
//   * K streams in BK tiles through two shared-memory stages filled by
//     cp.async (zero-filled past K and N): tile k+1 lands while tile k is
//     consumed.
//   * x is either streamed (kMT = 64 rows per block, one x tile per
//     stage) or resident: norm_rows() writes the block's rows, rms-
//     normalised and rounded to bf16, into shared memory once before the
//     loop, and every weight tile reads them in place. The rows are the
//     same in every block because the reduction order is fixed.
#pragma once

#include "common.cuh"

namespace repro {
namespace flat {

constexpr int kMT = 64;  // token rows per block at most (8 n8 tiles)

template <int BN, int BK, int S, bool XRES, bool KN = true>
struct Tile {
  static constexpr int kThreads = BN / 16 * 32;
  static constexpr int kXPitch = BK + 8;                // streamed xs[m][k]
  static constexpr int kWRows = KN ? BK : BN;
  static constexpr int kWPitch = KN ? BN + 8 : BK + 8;  // ws[k][n] / ws[n][k]
  static constexpr int kXElems = XRES ? 0 : kMT * kXPitch;
  static constexpr int kWElems = kWRows * kWPitch;
  static constexpr int kStageElems = kXElems + S * kWElems;
  static constexpr size_t kStagesBytes = 2 * kStageElems * 2;
};

// Row pitch of the resident rows: K rounded up to whole BK tiles, plus 8
// elements of padding.
__host__ __device__ inline int resident_pitch(int K, int BK) {
  return (K + BK - 1) / BK * BK + 8;
}

// The S weight streams of one block.
template <int S>
struct Streams {
  const __nv_bfloat16* w[S];
};

template <int BN, int BK, int NT, bool KN>
__device__ __forceinline__ void load_w(__nv_bfloat16* ws,
                                       const __nv_bfloat16* __restrict__ w,
                                       int K, int N, long long ldw, int n0,
                                       int k0) {
  if constexpr (KN) {
    constexpr int kPitch = BN + 8;
    constexpr int kChunks = BK * (BN / 8);
    for (int c = threadIdx.x; c < kChunks; c += NT) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      const int gk = k0 + r, gn = n0 + cc * 8;
      const bool ok = gk < K && gn < N;
      cp_async16(ws + r * kPitch + cc * 8,
                 ok ? w + static_cast<long long>(gk) * ldw + gn : w, ok);
    }
  } else {
    constexpr int kPitch = BK + 8;
    constexpr int kChunks = BN * (BK / 8);
    for (int c = threadIdx.x; c < kChunks; c += NT) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      const int gn = n0 + r, gk = k0 + cc * 8;
      const bool ok = gn < N && gk < K;
      cp_async16(ws + r * kPitch + cc * 8,
                 ok ? w + static_cast<long long>(gn) * ldw + gk : w, ok);
    }
  }
}

template <int BK, int NT>
__device__ __forceinline__ void load_x(__nv_bfloat16* xs,
                                       const __nv_bfloat16* __restrict__ x,
                                       int M, int K, long long ldx, int m0,
                                       int k0) {
  constexpr int kPitch = BK + 8;
  constexpr int kChunks = kMT * (BK / 8);
  for (int c = threadIdx.x; c < kChunks; c += NT) {
    const int r = c / (BK / 8), cc = c % (BK / 8);
    const int gm = m0 + r, gk = k0 + cc * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(xs + r * kPitch + cc * 8, ok ? x + gm * ldx + gk : x, ok);
  }
}

// A fragment of W^T (16 columns n of this warp x 16 k), from ws[k][n]
// (KN) or ws[n][k].
template <int BN, int BK, bool KN>
__device__ __forceinline__ void w_frag(const uint16_t* ws16, int kk, int wn,
                                       int g, int t, uint32_t* a) {
  if constexpr (KN) {
    constexpr int P = BN + 8;
    const int ka = kk + 2 * t, na = wn + g;
    a[0] = pack2(ws16[ka * P + na], ws16[(ka + 1) * P + na]);
    a[1] = pack2(ws16[ka * P + na + 8], ws16[(ka + 1) * P + na + 8]);
    a[2] = pack2(ws16[(ka + 8) * P + na], ws16[(ka + 9) * P + na]);
    a[3] = pack2(ws16[(ka + 8) * P + na + 8], ws16[(ka + 9) * P + na + 8]);
  } else {
    constexpr int P = BK + 8;
    const uint16_t* r0 = ws16 + (wn + g) * P + kk + 2 * t;
    const uint16_t* r8 = r0 + 8 * P;
    a[0] = *reinterpret_cast<const uint32_t*>(r0);
    a[1] = *reinterpret_cast<const uint32_t*>(r8);
    a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
  }
}

// Rows m0 .. m0 + rows of x, rms-normalised as rmsnorm_ref does (f32 sum
// of squares over the real K, x * (1 / sqrt(mean + eps)) * scale in f32,
// one rounding to bf16), into xn[r][k] with the given pitch; zero past K
// (up to pitch - 8) and in rows past M. One warp per row: lanes take
// 8-element vectors in a fixed order, so every block gets the same bits.
// Needs K % 8 == 0 and 16-byte aligned rows of x and scale.
__device__ __forceinline__ void norm_rows(
    __nv_bfloat16* xn, int pitch, const __nv_bfloat16* __restrict__ x,
    long long ldx, const __nv_bfloat16* __restrict__ scale, int M, int K,
    int m0, int rows, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int kp = pitch - 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int r = warp; r < rows; r += nw) {
    const int gm = m0 + r;
    __nv_bfloat16* dst = xn + r * pitch;
    if (gm >= M) {
      for (int c = lane * 8; c < kp; c += 256)
        *reinterpret_cast<uint4*>(dst + c) = zero;
      continue;
    }
    const __nv_bfloat16* src = x + gm * ldx;
    float ss = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(src + c), v);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
    }
    ss = warp_sum(ss);
    const float inv = 1.f / sqrtf(ss / static_cast<float>(K) + eps);
    for (int c = lane * 8; c < kp; c += 256) {
      uint4 o = zero;
      if (c < K) {
        float v[8], s[8];
        unpack8(*reinterpret_cast<const uint4*>(src + c), v);
        unpack8(*reinterpret_cast<const uint4*>(scale + c), s);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = __floats2bfloat162_rn(v[2 * i] * inv * s[2 * i],
                                       v[2 * i + 1] * inv * s[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(dst + c) = o;
    }
  }
}

// acc[s] (this warp's 16 columns x nt n8 row tiles of stream s) =
// x[m0.., :K] @ W_s[:K, n0..]. `stages` holds the two pipeline stages;
// with XRES the rows come from `xn` (pitch xn_pitch, written before the
// call), otherwise from x (row stride ldx). Ends with __syncthreads(), so
// the caller may reuse the stages and xn at once.
// C^T fragment: acc[s][j][0..1] at (n = g, m = j*8 + 2t, +1),
// acc[s][j][2..3] at (n = g + 8, same m).
template <int BN, int BK, int S, bool XRES, bool KN = true>
__device__ __forceinline__ void mainloop(
    __nv_bfloat16* stages, const __nv_bfloat16* xn, int xn_pitch,
    const __nv_bfloat16* __restrict__ x, long long ldx,
    const Streams<S>& ws, long long ldw, int M, int K, int N, int m0,
    int n0, int nt, float (&acc)[S][8][4]) {
  using T = Tile<BN, BK, S, XRES, KN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp * 16;  // this warp's 16 columns
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][j][i] = 0.f;

  auto load_stage = [&](__nv_bfloat16* stage, int k0) {
    if constexpr (!XRES) load_x<BK, T::kThreads>(stage, x, M, K, ldx, m0, k0);
#pragma unroll
    for (int s = 0; s < S; ++s)
      load_w<BN, BK, T::kThreads, KN>(stage + T::kXElems + s * T::kWElems,
                                      ws.w[s], K, N, ldw, n0, k0);
  };

  const int n_kt = (K + BK - 1) / BK;
  load_stage(stages, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt)
      load_stage(stages + ((kt + 1) & 1) * T::kStageElems, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // tile kt has landed
    __syncthreads();

    const __nv_bfloat16* stage = stages + (kt & 1) * T::kStageElems;
    const uint16_t* xs16 =
        XRES ? reinterpret_cast<const uint16_t*>(xn) + kt * BK
             : reinterpret_cast<const uint16_t*>(stage);
    const int xp = XRES ? xn_pitch : T::kXPitch;
    const uint16_t* w16 =
        reinterpret_cast<const uint16_t*>(stage + T::kXElems);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[S][4];
#pragma unroll
      for (int s = 0; s < S; ++s)
        w_frag<BN, BK, KN>(w16 + s * T::kWElems, kk, wn, g, t, a[s]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const uint16_t* xr = xs16 + (j * 8 + g) * xp + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
          for (int s = 0; s < S; ++s)
            mma_bf16(acc[s][j], a[s][0], a[s][1], a[s][2], a[s][3], b0, b1);
        }
      }
    }
    __syncthreads();  // stage kt may be refilled next iteration
  }
}

// ---------------------------------------------------------------------------
// The flat GEMM, out = x @ W, or resid + x @ W with a residual: flat_gemm.cu
// instantiates it without one (resid = nullptr), decode_fuse.cu's
// oproj_residual with one. The accumulator rounds to bf16 before the add,
// so the residual form writes bf16(resid + bf16(x @ W)), as
// `resid + matmul(o, wo)` does.
// ---------------------------------------------------------------------------

template <int BN, int BK, bool KN>
__global__ void __launch_bounds__(BN / 16 * 32)
gemm_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ resid,
            __nv_bfloat16* __restrict__ out, int M, int K, int N,
            long long ldx, long long ldw, long long ldr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kMT;
  const int nt = min(8, (M - m0 + 7) / 8);  // live n8 token tiles
  float acc[1][8][4];
  mainloop<BN, BK, 1, false, KN>(stages, nullptr, 0, x, ldx,
                                 Streams<1>{{w}}, ldw, M, K, N, m0, n0, nt,
                                 acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + j * 8 + 2 * t + (i & 1);
        const int n = n0 + warp * 16 + g + (i >> 1) * 8;
        if (m < M && n < N) {
          float v = acc[0][j][i];
          if (resid != nullptr) v = bf2f(resid[m * ldr + n]) + bf2f(f2bf(v));
          out[static_cast<long long>(m) * N + n] = f2bf(v);
        }
      }
    }
  }
}

template <int BN, int BK, bool KN>
int launch_gemm(const void* x, const void* w, const void* resid, void* out,
                int M, int K, int N, long long ldx, long long ldw,
                long long ldr, cudaStream_t st) {
  using T = Tile<BN, BK, 1, false, KN>;
  cudaError_t e = allow_smem(gemm_kernel<BN, BK, KN>, T::kStagesBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  using B = __nv_bfloat16;
  dim3 grid((N + BN - 1) / BN, (M + kMT - 1) / kMT);
  gemm_kernel<BN, BK, KN><<<grid, T::kThreads, T::kStagesBytes, st>>>(
      static_cast<const B*>(x), static_cast<const B*>(w),
      static_cast<const B*>(resid), static_cast<B*>(out), M, K, N, ldx, ldw,
      ldr);
  return static_cast<int>(cudaGetLastError());
}

template <bool KN>
int dispatch_gemm(int bn, int bk, const void* x, const void* w,
                  const void* resid, void* out, int M, int K, int N,
                  long long ldx, long long ldw, long long ldr,
                  cudaStream_t st) {
#define REPRO_FG_CASE(BN_, BK_)                                       \
  if (bn == BN_ && bk == BK_)                                         \
    return launch_gemm<BN_, BK_, KN>(x, w, resid, out, M, K, N, ldx,  \
                                     ldw, ldr, st);
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

// ---------------------------------------------------------------------------
// The fused FFN-up, h = act(x @ Wg) * (x @ Wu), with the activation on the
// unrounded f32 accumulators and one rounding: fused_ffn.cu instantiates
// it with x streamed (NORM = false), decode_fuse.cu's ffn_norm with the
// rmsnorm prologue and x resident (NORM = true).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float activate(float g, bool gelu) {
  if (gelu) {
    // tanh approximation, jax.nn.gelu's default
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    return 0.5f * g * (1.f + tanhf(inner));
  }
  return g / (1.f + expf(-g));
}

template <int BN, int BK, bool NORM>
__global__ void __launch_bounds__(BN / 16 * 32)
ffn_up_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ scale,
              const __nv_bfloat16* __restrict__ wg,
              const __nv_bfloat16* __restrict__ wu,
              __nv_bfloat16* __restrict__ out, int M, int K, int N,
              long long ldx, int mt, bool gelu, float eps) {
  using T = Tile<BN, BK, 2, NORM>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xn = stages + 2 * T::kStageElems;
  const int xn_pitch = resident_pitch(K, BK);

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * mt;
  const int nt = min(mt / 8, (M - m0 + 7) / 8);  // live n8 token tiles
  if constexpr (NORM) {
    norm_rows(xn, xn_pitch, x, ldx, scale, M, K, m0, nt * 8, eps);
    __syncthreads();
  }
  float acc[2][8][4];
  mainloop<BN, BK, 2, NORM>(stages, xn, xn_pitch, x, ldx,
                            Streams<2>{{wg, wu}}, N, M, K, N, m0, n0, nt,
                            acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + j * 8 + 2 * t + (i & 1);
        const int n = n0 + warp * 16 + g + (i >> 1) * 8;
        if (m < M && n < N)
          out[static_cast<long long>(m) * N + n] =
              f2bf(activate(acc[0][j][i], gelu) * acc[1][j][i]);
      }
    }
  }
}

template <int BN, int BK, bool NORM>
int launch_ffn_up(const void* x, const void* scale, const void* wg,
                  const void* wu, void* out, int M, int K, int N,
                  long long ldx, int mt, bool gelu, float eps,
                  cudaStream_t st) {
  using T = Tile<BN, BK, 2, NORM>;
  const size_t smem =
      T::kStagesBytes +
      (NORM ? static_cast<size_t>(mt) * resident_pitch(K, BK) * 2 : 0);
  cudaError_t e = allow_smem(ffn_up_kernel<BN, BK, NORM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + BN - 1) / BN, (M + mt - 1) / mt);
  ffn_up_kernel<BN, BK, NORM><<<grid, T::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu),
      static_cast<__nv_bfloat16*>(out), M, K, N, ldx, mt, gelu, eps);
  return static_cast<int>(cudaGetLastError());
}

template <bool NORM>
int dispatch_ffn_up(int bn, int bk, const void* x, const void* scale,
                    const void* wg, const void* wu, void* out, int M, int K,
                    int N, long long ldx, int mt, bool gelu, float eps,
                    cudaStream_t st) {
#define REPRO_FF_CASE(BN_, BK_)                                           \
  if (bn == BN_ && bk == BK_)                                             \
    return launch_ffn_up<BN_, BK_, NORM>(x, scale, wg, wu, out, M, K, N,  \
                                         ldx, mt, gelu, eps, st);
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

}  // namespace flat
}  // namespace repro
