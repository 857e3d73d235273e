// ImplA — FastGEMV on CUDA cores for M <= 4 token rows (paper §5).
//
// Replaces: src/repro/kernels/gemv.py::gemv (_gemv_kernel, and
// _gemv_quant_kernel for int8 / fp8 weights), the TPU VPU
// broadcast-multiply-reduce GEMV.
//
// Bound on H100: device-memory bytes. The work is M*K*N FMAs over K*N
// weight bytes — at M <= 4 that is <= 4 FLOP/byte, far below the ~295
// FLOP/byte where the tensor cores would become the limit, so the only
// thing that matters is streaming W once at full rate. Tensor cores
// would waste >= 75% of an m16 tile and buy nothing.
//
// Design: x (at most 4 x K bf16) is staged once per block in shared
// memory; W is read exactly once with 16-byte loads and accumulated in
// f32. Two weight layouts, picked by the wrapper from the strides:
//   * "KN": W[k, n] at w[k*ldw + n] (a row-major (K, N) weight). Each
//     thread owns 8 adjacent columns, so a warp reads 4 rows x 128
//     contiguous bytes; 32 k-groups split K inside the block and are
//     reduced with shuffles, then across warps in shared memory.
//   * "NK": W[k, n] at w[n*ldw + k] (the transposed view of a row-major
//     (N, K) tensor — the tied LM head, embedding.T, 152064 x 896).
//     One warp per output column: lanes read K with 16-byte loads and
//     the column's dot products finish with a warp-shuffle reduction.
//     Reading the view in place avoids a 272 MB copy per decode tick.
//   * "KN" with quantized weights (models/wquant.py): W is (K, N) int8 or
//     fp8 e4m3 codes with one f32 step per column. A 16-byte load now
//     carries 16 codes, so each thread owns 16 adjacent columns and 4
//     threads cover a block's 64 (64 k-groups): the block still reads 64
//     columns of every row, at half the bytes. Each code becomes a float
//     exactly, the FMAs run against the staged x in f32, and the step
//     multiplies the reduced f32 sum before the one bf16 rounding (the
//     reference's acc * scale). Quantized leaves are always (K, N) and
//     the tied head never quantizes, so "NK" has no quantized variant.
// Every path loads only whole 16-byte vectors: the contiguous axis is a
// multiple of 8 (16 for codes) and every row is 16-byte aligned (the
// wrapper raises otherwise, as the flat GEMM's does).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxM = 4;
constexpr int kThreads = 256;
constexpr int kColThreads = 8;                       // KN: threads along N
constexpr int kKGroups = kThreads / kColThreads;     // KN: 32 k-groups
constexpr int kColsPerBlock = kColThreads * 8;       // KN: 64 columns
constexpr int kWarps = kThreads / 32;
constexpr int kQColThreads = 4;                      // KN codes: 16 each
constexpr int kQKGroups = kThreads / kQColThreads;   // KN codes: 64
static_assert(kQColThreads * 16 == kColsPerBlock, "one block, 64 columns");

// Stage x (M x K, row stride ldx) into shared memory as bf16 (M*K dense).
__device__ __forceinline__ void stage_x(const __nv_bfloat16* __restrict__ x,
                                        __nv_bfloat16* xs, int M, int K,
                                        long long ldx) {
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) {
    int m = i / K, k = i - m * K;
    xs[i] = x[m * ldx + k];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gemv_kn_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               long long ldx, long long ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(M) * K * 2 + 15) / 16) * 16);
  stage_x(x, xs, M, K, ldx);

  const int ct = threadIdx.x % kColThreads;
  const int kg = threadIdx.x / kColThreads;
  const int n0 = blockIdx.x * kColsPerBlock + ct * 8;

  float acc[kMaxM][8];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  // N % 8 == 0, so a thread's 8 columns lie wholly inside or past N
  if (n0 < N) {
    for (int k = kg; k < K; k += kKGroups) {
      float wv[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(w + k * ldw + n0)), wv);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          float xv = bf2f(xs[m * K + k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }
  }

  // k-groups kg, kg+4, kg+8, kg+12 of one warp sit 8 lanes apart
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  const int lane = threadIdx.x % 32;
  if (lane < kColThreads) {
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * kMaxM + m) * kColsPerBlock + ct * 8 + j] = acc[m][j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * kColsPerBlock; t += blockDim.x) {
    const int m = t / kColsPerBlock, c = t % kColsPerBlock;
    const int n = blockIdx.x * kColsPerBlock + c;
    if (n < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        s += red[(wi * kMaxM + m) * kColsPerBlock + c];
      out[static_cast<long long>(m) * N + n] = f2bf(s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gemv_nk_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               long long ldx, long long ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  stage_x(x, xs, M, K, ldx);

  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const __nv_bfloat16* col = w + static_cast<long long>(n) * ldw;

  float acc[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = 0.f;

  for (int k0 = lane * 8; k0 < K; k0 += 32 * 8) {
    float wv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(col + k0)), wv);
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        float xv[8];
        unpack8(*reinterpret_cast<const uint4*>(xs + m * K + k0), xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m] = fmaf(xv[j], wv[j], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) acc[m] = warp_sum(acc[m]);
  if (lane == 0) {
    for (int m = 0; m < M; ++m)
      out[static_cast<long long>(m) * N + n] = f2bf(acc[m]);
  }
}

template <typename CT>
__global__ void __launch_bounds__(kThreads)
gemv_kn_q8_kernel(const __nv_bfloat16* __restrict__ x,
                  const unsigned char* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N,
                  long long ldx, long long ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + ((static_cast<size_t>(M) * K * 2 + 15) / 16) * 16);
  stage_x(x, xs, M, K, ldx);

  const int ct = threadIdx.x % kQColThreads;
  const int kg = threadIdx.x / kQColThreads;
  const int n0 = blockIdx.x * kColsPerBlock + ct * 16;

  float acc[kMaxM][16];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  // N % 16 == 0, so a thread's 16 columns lie wholly inside or past N
  if (n0 < N) {
    for (int k = kg; k < K; k += kQKGroups) {
      float wv[16];
      unpack16<CT>(__ldg(reinterpret_cast<const uint4*>(w + k * ldw + n0)),
                   wv);
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          float xv = bf2f(xs[m * K + k]);
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
        }
      }
    }
  }

  // the 8 k-groups of one warp sit 4 lanes apart
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  }
  const int lane = threadIdx.x % 32;
  if (lane < kQColThreads) {
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        red[(warp * kMaxM + m) * kColsPerBlock + ct * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * kColsPerBlock; t += blockDim.x) {
    const int m = t / kColsPerBlock, c = t % kColsPerBlock;
    const int n = blockIdx.x * kColsPerBlock + c;
    if (n < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi)
        s += red[(wi * kMaxM + m) * kColsPerBlock + c];
      out[static_cast<long long>(m) * N + n] = f2bf(s * scale[n]);
    }
  }
}

template <typename CT>
int launch_gemv_q8(const void* x, const void* w, const void* scale,
                   void* out, int M, int K, int N, long long ldx,
                   long long ldw, cudaStream_t st) {
  const size_t smem = ((static_cast<size_t>(M) * K * 2 + 15) / 16) * 16 +
                      static_cast<size_t>(kWarps) * kMaxM * kColsPerBlock * 4;
  cudaError_t e = allow_smem(gemv_kn_q8_kernel<CT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock);
  gemv_kn_q8_kernel<CT><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const unsigned char*>(w), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, K, N, ldx, ldw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = x (M, K; row stride ldx) @ W.
// w_kn = 1: W[k, n] at w[k*ldw + n]; w_kn = 0: W[k, n] at w[n*ldw + k].
// Needs K % 8 == 0 (and N % 8 == 0 for w_kn = 1) with 16-byte aligned rows
// of W and x; the wrapper checks this.
REPRO_EXPORT int gemv_bf16(const void* x, const void* w, void* out, int M,
                           int K, int N, long long ldx, long long ldw,
                           int w_kn, void* stream) {
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t xs_bytes = ((static_cast<size_t>(M) * K * 2 + 15) / 16) * 16;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (w_kn) {
    const size_t smem =
        xs_bytes + static_cast<size_t>(kWarps) * kMaxM * kColsPerBlock * 4;
    cudaError_t e = allow_smem(gemv_kn_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock);
    gemv_kn_kernel<<<grid, kThreads, smem, st>>>(xp, wp, op, M, K, N, ldx,
                                                 ldw);
  } else {
    cudaError_t e = allow_smem(gemv_nk_kernel, xs_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((N + kWarps - 1) / kWarps);
    gemv_nk_kernel<<<grid, kThreads, xs_bytes, st>>>(xp, wp, op, M, K, N,
                                                     ldx, ldw);
  }
  return static_cast<int>(cudaGetLastError());
}

// Quantized weights: out (M, N) bf16 = bf16((x @ codes) * scale), codes
// (K, N) row-major int8 (fp8 = 0) or e4m3 (fp8 = 1), leading dimension ldw,
// scale (N,) f32. Needs K % 8 == 0, N % 16 == 0 and ldw % 16 == 0 with
// 16-byte aligned rows of the codes and x.
REPRO_EXPORT int gemv_q8(const void* x, const void* w, const void* scale,
                         void* out, int M, int K, int N, long long ldx,
                         long long ldw, int fp8, void* stream) {
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return launch_gemv_q8<__nv_fp8_e4m3>(x, w, scale, out, M, K, N, ldx, ldw,
                                         st);
  return launch_gemv_q8<int8_t>(x, w, scale, out, M, K, N, ldx, ldw, st);
}
