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
// Design: W is read exactly once with 16-byte loads and accumulated in
// f32 against x in shared memory. Two weight layouts, picked by the
// wrapper from the strides:
//   * "KN": W[k, n] at w[k*ldw + n] (a row-major (K, N) weight), bf16 or
//     the int8 / fp8 codes of a quantized weight (models/wquant.py) with
//     one f32 step per column. Each thread owns one 16-byte vector of
//     adjacent columns (8 bf16 or 16 codes); CT threads cover a block's
//     COLS = CT * vector columns (64, or 32 for narrow N) and the other
//     threads split the block's rows of K into k-groups. Split K: the
//     columns of a decode GEMM (N = 128 .. 4,864) give far fewer blocks
//     than the card has SMs, so the launch's z axis cuts K into S fixed
//     ranges of whole kSplitRows-row chunks counted from K = 0 (S from
//     kernels/gemv.py::pick_splits: a function of K, N and the card, never
//     of M; 1 where the columns alone give every SM two blocks). The S
//     blocks of a column tile form one thread-block cluster along z. A
//     block issues its first weight loads (12 bf16 or 5 code vectors a
//     thread, streamed past L1), stages its range of x meanwhile, walks
//     the range with those loads in flight ahead of the FMAs, reduces
//     over its k-groups (shuffles, then across warps in shared memory)
//     and leaves an f32 (M x COLS) partial tile in shared memory; after
//     cluster.sync() every block folds a slice of the tile over the S
//     splits in split order through distributed shared memory (no
//     atomics, no scratch, nothing to reset between graph replays) and
//     runs the epilogue on the sum: the step for codes, then the one bf16
//     rounding. An element's sum depends only on its own row and column,
//     so a row's bits are the same alone and in any batch.
//   * "NK": W[k, n] at w[n*ldw + k] (the transposed view of a row-major
//     (N, K) tensor — the tied LM head, embedding.T, 152064 x 896), bf16
//     only (the tied head never quantizes). A warp takes groups of
//     kNkCols adjacent columns in turn (two blocks a SM, each staging x
//     once) and treats a group's K/8 16-byte vectors as one list that its
//     lanes share out, kNkVec a lane a pass, so no lane idles on a ragged
//     last step (896 / 8 = 112 vectors per column do not divide by 32
//     lanes; 2 x 112 = 7 x 32 do). The next group's vectors are loaded
//     before this group's FMAs, so the stream never waits on a
//     reduction; the columns' dot products finish with warp shuffles.
//     Reading the view in place avoids a 272 MB copy per decode tick; its
//     76,032 column pairs fill the card unsplit.
// Both layouts load whole 16-byte vectors wherever every weight row is
// 16-byte aligned. A bf16 (K, N) weight whose N or leading dimension is
// not a multiple of 8 (hymba's w_dt, 1,600 -> 50) runs the same "KN"
// kernel with TAIL set: each thread's 8 columns load element by element,
// those past N as zero (common.cuh's ld_cols8), so the products and
// their order, and with them every output's bits, are the aligned
// body's. Codes keep N % 16 == 0 with aligned rows, and x's rows (K a
// multiple of 8) stay 16-byte vectors (the wrapper raises otherwise).
#include <cooperative_groups.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxM = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;     // a portable cluster at most
constexpr int kSplitRows = 64;    // K rows per split chunk (kernels/gemv.py)
constexpr int kNkCols = 2;        // NK: columns per warp group
constexpr int kNkVec = 8;         // NK: 16-byte weight vectors a lane a pass

// The column layout of a KN block: CT threads along N, each owning one
// 16-byte vector of kVec columns; the block's other threads are k-groups,
// each with kUnroll weight vectors in flight.
template <int CT, typename WT>
struct KnTile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(WT));
  static constexpr int kCols = CT * kVec;
  static constexpr int kKGroups = kThreads / CT;
  static constexpr int kUnroll = sizeof(WT) == 1 ? 5 : 12;
  static_assert(kCols == 32 || kCols == 64, "32 or 64 columns per block");
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Shared memory of a KN launch whose largest split range holds `kr` rows:
// the warps' and the block's partial tiles, then x's rows of the range.
template <int CT, typename WT>
size_t kn_smem(int M, int kr) {
  using T = KnTile<CT, WT>;
  return static_cast<size_t>(kWarps + 1) * kMaxM * T::kCols * 4 +
         align16(static_cast<size_t>(M) * kr * 2);
}

// A 16-byte weight vector, read once: streamed past L1.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Rows of x (row stride ldx) from column k0, `kr` wide, into xs (M x kr)
// in 16-byte vectors (kr, ldx and k0 are multiples of 8).
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        int M, long long ldx, int k0,
                                        int kr) {
  const int vrow = kr / 8;
  for (int i = threadIdx.x; i < M * vrow; i += kThreads) {
    const int m = i / vrow, c = i - m * vrow;
    reinterpret_cast<uint4*>(xs + m * kr)[c] =
        *reinterpret_cast<const uint4*>(x + m * ldx + k0 + c * 8);
  }
}

template <typename WT>
__device__ __forceinline__ void unpack_vec(const uint4& u, float* out) {
  if constexpr (sizeof(WT) == 1)
    unpack16<WT>(u, out);
  else
    unpack8(u, out);
}

template <int CT, typename WT, bool TAIL>
__global__ void __launch_bounds__(kThreads, 2)
gemv_kn_kernel(const __nv_bfloat16* __restrict__ x, const WT* __restrict__ w,
               const float* __restrict__ scale,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               long long ldx, long long ldw) {
  using T = KnTile<CT, WT>;
  constexpr int V = T::kVec, COLS = T::kCols, KG = T::kKGroups;
  constexpr int U = T::kUnroll;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());

  // this split's rows of K: whole chunks from K = 0
  const int per = ((K + kSplitRows - 1) / kSplitRows + S - 1) / S;
  const int k_lo = min(K, z * per * kSplitRows);
  const int kr = min(K, (z + 1) * per * kSplitRows) - k_lo;

  // the partial tiles first: the fold reads its partners' `part` at this
  // block's own offset, and the splits' ranges (so x's rows) differ
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);    // warps x kMaxM x COLS
  float* part = red + kWarps * kMaxM * COLS;      // M x COLS
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(part + kMaxM * COLS);  // M x kr

  const int ct = threadIdx.x % CT, kg = threadIdx.x / CT;
  const int n0 = blockIdx.x * COLS + ct * V;
  // aligned, N is a multiple of V, so a thread's columns lie wholly inside
  // or past N; with TAIL the first `live` of them lie inside
  const bool cols_in = n0 < N;
  const int live = min(V, N - n0);
  const WT* wp = w + static_cast<long long>(k_lo) * ldw + n0;
  auto load = [&](const WT* p) {
    if constexpr (TAIL)
      return ld_cols8(reinterpret_cast<const __nv_bfloat16*>(p), live);
    else
      return ld_stream(p);
  };
  uint4 raw[U];
  // the first weight vectors are in flight while x is staged
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = kg + u * KG;
    raw[u] = cols_in && kk < kr ? load(wp + kk * ldw)
                                : make_uint4(0u, 0u, 0u, 0u);
  }
  stage_x(xs, x, M, ldx, k_lo, kr);
  __syncthreads();

  float acc[kMaxM][V];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[m][j] = 0.f;
  for (int k = kg; k < kr; k += U * KG) {
    if (k != kg) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = k + u * KG;
        raw[u] = cols_in && kk < kr ? load(wp + kk * ldw)
                                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * KG;
      if (kk < kr) {
        float wv[V];
        unpack_vec<WT>(raw[u], wv);
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < M) {
            const float xv = bf2f(xs[m * kr + kk]);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
          }
        }
      }
    }
  }

  // the k-groups of one warp sit CT lanes apart
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = acc[m][j];
#pragma unroll
        for (int o = CT; o < 32; o <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[m][j] = v;
      }
    }
  }
  if (lane < CT) {
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          red[(warp * kMaxM + m) * COLS + ct * V + j] = acc[m][j];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * COLS; t += kThreads) {
    const int m = t / COLS, c = t % COLS;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * kMaxM + m) * COLS + c];
    part[t] = s;
  }
  cluster.sync();  // every split's partial tile is written and visible

  const int E = M * COLS;
  for (int e = E * z / S + threadIdx.x; e < E * (z + 1) / S; e += kThreads) {
    const int m = e / COLS, n = blockIdx.x * COLS + e % COLS;
    if (n < N) {
      float v = *cluster.map_shared_rank(part + e, 0);
      for (int q = 1; q < S; ++q) v += *cluster.map_shared_rank(part + e, q);
      if constexpr (sizeof(WT) == 1) v *= scale[n];
      out[static_cast<long long>(m) * N + n] = f2bf(v);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// The weight vectors of pass p of column group g for this lane: vector
// i = p * 32 * kNkVec + lane + 32 u of the group's list, column i / kv
// (by comparisons), k (i - column * kv) * 8.
__device__ __forceinline__ void nk_load(uint4 (&raw)[kNkVec],
                                        const __nv_bfloat16* __restrict__ w,
                                        long long ldw, int N, int kv, int g,
                                        int p, int lane) {
  const int total = kNkCols * kv;
#pragma unroll
  for (int u = 0; u < kNkVec; ++u) {
    const int i = p * 32 * kNkVec + lane + 32 * u;
    int c = 0;
#pragma unroll
    for (int j = 1; j < kNkCols; ++j) c += i >= j * kv;
    const int n = g * kNkCols + c;
    raw[u] = i < total && n < N
                 ? ld_stream(w + static_cast<long long>(n) * ldw +
                             (i - c * kv) * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gemv_nk_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int M, int K, int N,
               long long ldx, long long ldw) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // M x K
  const int lane = threadIdx.x % 32;
  const int kv = K / 8;                // 16-byte vectors per column
  const int passes = (kNkCols * kv + 32 * kNkVec - 1) / (32 * kNkVec);
  const int groups = (N + kNkCols - 1) / kNkCols;
  const int stride = gridDim.x * kWarps;
  // this warp's items: passes 0 .. passes - 1 of groups g, g + stride, ...
  int g = blockIdx.x * kWarps + threadIdx.x / 32, p = 0;

  uint4 cur[kNkVec], nxt[kNkVec];
  if (g < groups) nk_load(cur, w, ldw, N, kv, g, 0, lane);
  stage_x(xs, x, M, ldx, 0, K);   // while the first vectors are in flight
  __syncthreads();

  float acc[kNkCols][kMaxM];
#pragma unroll
  for (int c = 0; c < kNkCols; ++c)
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) acc[c][m] = 0.f;
  while (g < groups) {
    // the next item's vectors go out before this one's FMAs
    int gn = g, pn = p + 1;
    if (pn == passes) {
      pn = 0;
      gn += stride;
    }
    if (gn < groups) nk_load(nxt, w, ldw, N, kv, gn, pn, lane);
#pragma unroll
    for (int u = 0; u < kNkVec; ++u) {
      const int i = p * 32 * kNkVec + lane + 32 * u;
      if (i < kNkCols * kv) {
        int col = 0;
#pragma unroll
        for (int j = 1; j < kNkCols; ++j) col += i >= j * kv;
        const int k8 = (i - col * kv) * 8;
        float wv[8];
        unpack8(cur[u], wv);
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < M) {
            float xv[8];
            unpack8(*reinterpret_cast<const uint4*>(xs + m * K + k8), xv);
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) dot = fmaf(xv[j], wv[j], dot);
#pragma unroll
            for (int c = 0; c < kNkCols; ++c)
              if (col == c) acc[c][m] += dot;
          }
        }
      }
    }
    if (p == passes - 1) {
#pragma unroll
      for (int c = 0; c < kNkCols; ++c) {
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < M) {
            const float v = warp_sum(acc[c][m]);
            const int n = g * kNkCols + c;
            if (lane == 0 && n < N)
              out[static_cast<long long>(m) * N + n] = f2bf(v);
          }
          acc[c][m] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kNkVec; ++u) cur[u] = nxt[u];
    g = gn;
    p = pn;
  }
}

// SMs of the current device (the NK grid is two blocks a SM at most).
inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int CT, typename WT, bool TAIL>
int launch_kn(int splits, const void* x, const void* w, const void* scale,
              void* out, int M, int K, int N, long long ldx, long long ldw,
              cudaStream_t st) {
  using T = KnTile<CT, WT>;
  const int per = ((K + kSplitRows - 1) / kSplitRows + splits - 1) / splits;
  const size_t smem = kn_smem<CT, WT>(M, min(K, per * kSplitRows));
  auto kernel = gemv_kn_kernel<CT, WT, TAIL>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + T::kCols - 1) / T::kCols, 1, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using B = __nv_bfloat16;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const B*>(x),
                         static_cast<const WT*>(w),
                         static_cast<const float*>(scale), static_cast<B*>(out),
                         M, K, N, ldx, ldw);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// cols 64 or 32 (a 16-byte vector per column thread: 8 bf16, 16 codes)
template <typename WT, bool TAIL>
int dispatch_cols(int cols, int splits, const void* x, const void* w,
                  const void* scale, void* out, int M, int K, int N,
                  long long ldx, long long ldw, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(WT));
  if (cols == 64)
    return launch_kn<64 / V, WT, TAIL>(splits, x, w, scale, out, M, K, N,
                                       ldx, ldw, st);
  if (cols == 32)
    return launch_kn<32 / V, WT, TAIL>(splits, x, w, scale, out, M, K, N,
                                       ldx, ldw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The KN launch; bf16 weights whose rows are not 16-byte aligned (N or
// ldw not a multiple of 8) run the TAIL loads. Codes must be aligned.
template <typename WT>
int dispatch_kn(int cols, int splits, const void* x, const void* w,
                const void* scale, void* out, int M, int K, int N,
                long long ldx, long long ldw, cudaStream_t st) {
  if (M < 1 || M > kMaxM || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(WT) == 2) {
    if (kn_tail(N, ldw, w))
      return dispatch_cols<WT, true>(cols, splits, x, w, scale, out, M, K, N,
                                     ldx, ldw, st);
  } else {
    if (kn_tail(N, ldw, w) || N % 16 || ldw % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_cols<WT, false>(cols, splits, x, w, scale, out, M, K, N,
                                  ldx, ldw, st);
}

}  // namespace

REPRO_ERROR_STRING_FN

// out (M, N) row-major bf16 = x (M, K; row stride ldx) @ W.
// w_kn = 1: W[k, n] at w[k*ldw + n], launched in `cols`-column blocks over
// `splits` K ranges (kernels/gemv.py::gemv_tiles); w_kn = 0: W[k, n] at
// w[n*ldw + k], unsplit (cols and splits ignored). Needs K % 8 == 0 with
// 16-byte aligned rows of x (and of W for w_kn = 0); a w_kn = 1 weight
// of any N and ldw runs (its unaligned rows through the TAIL loads). The
// wrapper checks this.
REPRO_EXPORT int gemv_bf16(const void* x, const void* w, void* out, int M,
                           int K, int N, long long ldx, long long ldw,
                           int w_kn, int cols, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_kn)
    return dispatch_kn<__nv_bfloat16>(cols, splits, x, w, nullptr, out, M, K,
                                      N, ldx, ldw, st);
  if (M < 1 || M > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = align16(static_cast<size_t>(M) * K * 2);
  cudaError_t e = allow_smem(gemv_nk_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_block = kWarps * kNkCols;
  const int blocks = min((N + per_block - 1) / per_block, 2 * num_sms());
  gemv_nk_kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      M, K, N, ldx, ldw);
  return static_cast<int>(cudaGetLastError());
}

// Quantized weights: out (M, N) bf16 = bf16((x @ codes) * scale), codes
// (K, N) row-major int8 (fp8 = 0) or e4m3 (fp8 = 1), leading dimension ldw,
// scale (N,) f32, launched like gemv_bf16's KN layout. Needs K % 8 == 0,
// N % 16 == 0 and ldw % 16 == 0 with 16-byte aligned rows of the codes and
// x.
REPRO_EXPORT int gemv_q8(const void* x, const void* w, const void* scale,
                         void* out, int M, int K, int N, long long ldx,
                         long long ldw, int cols, int splits, int fp8,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return dispatch_kn<__nv_fp8_e4m3>(cols, splits, x, w, scale, out, M, K, N,
                                      ldx, ldw, st);
  return dispatch_kn<int8_t>(cols, splits, x, w, scale, out, M, K, N, ldx,
                             ldw, st);
}
