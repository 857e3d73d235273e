// The mma.sync pieces of the flat GEMM family, shared by flat_gemm.cu,
// decode_fuse.cu and the wgmma bodies: the split-K GEMM for narrow N
// (gemm_split_kernel), the weight-tile loads and fragments the decode
// ingest also runs on, the rmsnorm of a row range (norm_rows_range), and
// the epilogues (gemm_store, activate).
//
//   * Operands swapped: each warp computes 16 (N) x 8 (M) tiles of
//     C^T = W^T x^T with mma.sync.m16n8k16 (bf16 in, f32 accumulate), so N
//     fills the MMA's 16-row slot and the token rows fill n8: M is padded
//     to 8 in-kernel (masked, zero-filled copies), never on the host.
//   * A block covers BN columns (BN/16 warps) and up to 8 n8 tiles of
//     token rows. W is read in place in one of two layouts: "KN"
//     (row-major (K, N), leading dimension ldw) or "NK" (the transposed
//     view of a row-major (N, K) tensor, e.g. the tied LM head).
//   * The split-K GEMM (gemm_split_kernel) walks one fixed range of whole
//     BK tiles per block through a kSplitStages-deep cp.async ring
//     (zero-filled past K and N), copying only its live x rows, and sums
//     the ranges' f32 partials in order through a thread-block cluster's
//     distributed shared memory.
//   * The weight element type WT is bf16, or a 1-byte code (int8_t,
//     __nv_fp8_e4m3) of a quantized weight in the "KN" layout: the codes
//     stream at their stored width (16 per cp.async chunk), w_frag turns
//     each into its exact bf16 value for the unchanged bf16 MMA, and the
//     kernels multiply the f32 accumulators by the per-output-channel
//     step in their epilogues, before the first rounding (the JAX
//     package's quantized bodies: dot on codes cast to the activation
//     dtype, f32 accumulation, acc * step).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace flat {

constexpr int kMT = 64;  // token rows per block at most (8 n8 tiles)
constexpr int kMaxSplits = 8;    // K splits: a portable cluster at most
constexpr int kSplitBN = 64;     // the split GEMM's column tile
constexpr int kSplitStages = 4;  // the split GEMM's cp.async ring

template <typename WT>
constexpr bool kIsCode = sizeof(WT) == 1;   // a quantized weight's codes

// One stage of the split GEMM's ring: the streamed x tile (kMT bf16 rows
// of BK), then the weight tile. Every row is padded by 16 bytes (8 bf16
// or 16 codes), which keeps each row start 16-byte aligned. NST stages.
// The ingest kernel rings the weight tiles alone (kWBytes a stage).
template <int BN, int BK, bool KN = true, typename WT = __nv_bfloat16,
          int NST = kSplitStages>
struct Tile {
  static_assert(KN || !kIsCode<WT>, "codes come in the (K, N) layout only");
  static constexpr int kThreads = BN / 16 * 32;
  static constexpr int kXPitch = BK + 8;                // streamed xs[m][k]
  static constexpr int kWRows = KN ? BK : BN;
  // ws[k][n] / ws[n][k] row pitch in bytes
  static constexpr int kWPitchBytes =
      (KN ? BN : BK) * static_cast<int>(sizeof(WT)) + 16;
  static constexpr int kXBytes = kMT * kXPitch * 2;
  static constexpr int kWBytes = kWRows * kWPitchBytes;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr size_t kStagesBytes =
      NST * static_cast<size_t>(kStageBytes);
};

// One BK x BN weight tile into ws (row pitch kWPitchBytes), 16 bytes per
// cp.async: 8 bf16 or 16 codes. Chunks past K or N are zero-filled, so N
// must be a multiple of 16 / sizeof(WT), with 16-byte aligned rows.
// TAIL (a bf16 (K, N) weight whose N or leading dimension is not a
// multiple of 8, so its rows are not 16-byte aligned): each chunk loads
// element by element (common.cuh's ld_cols8), the columns past N as zero,
// and lands in shared memory with one plain 16-byte store. The stage it
// fills was released by the __syncthreads() that ended its last use, and
// the one before its own compute makes the stores visible, as for the
// cp.async copies.
template <int BN, int BK, int NT, bool KN, typename WT, bool TAIL = false>
__device__ __forceinline__ void load_w(unsigned char* ws,
                                       const WT* __restrict__ w, int K,
                                       int N, long long ldw, int n0,
                                       int k0) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(WT));
  static_assert(!TAIL || (KN && !kIsCode<WT>),
                "the tail loads take a bf16 (K, N) weight");
  if constexpr (KN) {
    constexpr int kPitch = BN * static_cast<int>(sizeof(WT)) + 16;
    constexpr int kCpr = BN / kVec;   // copies per row
    constexpr int kChunks = BK * kCpr;
    for (int c = threadIdx.x; c < kChunks; c += NT) {
      const int r = c / kCpr, cc = c % kCpr;
      const int gk = k0 + r, gn = n0 + cc * kVec;
      const bool ok = gk < K && gn < N;
      if constexpr (TAIL) {
        *reinterpret_cast<uint4*>(ws + r * kPitch + cc * 16) =
            ok ? ld_cols8(reinterpret_cast<const __nv_bfloat16*>(w) +
                              static_cast<long long>(gk) * ldw + gn,
                          N - gn)
               : make_uint4(0u, 0u, 0u, 0u);
      } else {
        cp_async16(ws + r * kPitch + cc * 16,
                   ok ? w + static_cast<long long>(gk) * ldw + gn : w, ok);
      }
    }
  } else {
    constexpr int kPitch = BK * static_cast<int>(sizeof(WT)) + 16;
    constexpr int kCpr = BK / kVec;
    constexpr int kChunks = BN * kCpr;
    for (int c = threadIdx.x; c < kChunks; c += NT) {
      const int r = c / kCpr, cc = c % kCpr;
      const int gn = n0 + r, gk = k0 + cc * kVec;
      const bool ok = gn < N && gk < K;
      cp_async16(ws + r * kPitch + cc * 16,
                 ok ? w + static_cast<long long>(gn) * ldw + gk : w, ok);
    }
  }
}

// Rows m0 .. m0 + rows of a BK-wide x tile (zero-filled past M and K).
template <int BK, int NT>
__device__ __forceinline__ void load_x(__nv_bfloat16* xs,
                                       const __nv_bfloat16* __restrict__ x,
                                       int M, int K, long long ldx, int m0,
                                       int k0, int rows = kMT) {
  constexpr int kPitch = BK + 8;
  const int chunks = rows * (BK / 8);
  for (int c = threadIdx.x; c < chunks; c += NT) {
    const int r = c / (BK / 8), cc = c % (BK / 8);
    const int gm = m0 + r, gk = k0 + cc * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(xs + r * kPitch + cc * 8, ok ? x + gm * ldx + gk : x, ok);
  }
}

// A fragment of W^T (16 columns n of this warp x 16 k), from ws[k][n]
// (KN) or ws[n][k]; codes become their exact bf16 values.
template <int BN, int BK, bool KN, typename WT>
__device__ __forceinline__ void w_frag(const unsigned char* ws, int kk,
                                       int wn, int g, int t, uint32_t* a) {
  const uint16_t* ws16 = reinterpret_cast<const uint16_t*>(ws);
  if constexpr (kIsCode<WT>) {
    constexpr int P = BN + 16;
    const unsigned char* r0 = ws + (kk + 2 * t) * P + wn + g;
    a[0] = pack2(code_bits<WT>(r0[0]), code_bits<WT>(r0[P]));
    a[1] = pack2(code_bits<WT>(r0[8]), code_bits<WT>(r0[P + 8]));
    a[2] = pack2(code_bits<WT>(r0[8 * P]), code_bits<WT>(r0[9 * P]));
    a[3] = pack2(code_bits<WT>(r0[8 * P + 8]), code_bits<WT>(r0[9 * P + 8]));
  } else if constexpr (KN) {
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

// Rows lo .. hi - 1 of xn[r][k] (pitch a multiple of 8) set to zero, 16
// bytes a thread at a time over `nt` threads: contiguous, so no division.
__device__ __forceinline__ void zero_rows(__nv_bfloat16* xn, int pitch,
                                          int lo, int hi, int nt) {
  uint4* p = reinterpret_cast<uint4*>(xn + lo * pitch);
  const int n = (hi - lo) * pitch / 8;
  for (int i = threadIdx.x; i < n; i += nt) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

constexpr int kNormBatch = 8;  // a row's 16-byte vectors a lane loads at once
constexpr int kRangeBatch = 4;  // its range's x and scale vectors likewise

// Rows m0 .. m0 + rows of x, rms-normalised over all of K as rmsnorm_ref
// does (f32 sum of squares; x * (1 / sqrt(mean + eps)) * scale in f32,
// one rounding to bf16), columns k_lo .. k_lo + span only: the 16-byte
// vector of row r from column k_lo + c goes to *dst(r, c) (c a multiple
// of 8, k_lo too); zero past K. meanwhile(live) runs on every thread of
// the nw warps once their first row's loads are out: it must zero the
// rows from `live` (the first past M) on, and may issue other work. Warp
// `warp` of `nw` takes the live rows warp, warp + nw, ... Each lane sums
// its 8-element vectors from lane * 8 in steps of 256 in K order (a
// vector past K adds +0, which leaves the sum's bits alone) and warp_sum
// folds the lanes in a fixed order, so every block gets the same bits
// whatever range it writes. A row's loads (the sum's first kNormBatch
// vectors a lane, the range's first kRangeBatch x and scale vectors) go
// out together: with one warp a scheduler every dependent round trip
// shows. Needs K % 8 == 0 and 16-byte aligned rows of x and scale.
template <typename Dst, typename Meanwhile>
__device__ __forceinline__ void norm_rows_range(
    Dst dst, Meanwhile meanwhile, const __nv_bfloat16* __restrict__ x,
    long long ldx, const __nv_bfloat16* __restrict__ scale, int M, int K,
    int m0, int rows, int k_lo, int span, float eps, int warp, int nw) {
  const int lane = threadIdx.x % 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int live = max(0, min(rows, M - m0));
  uint4 raw[kNormBatch], xv[kRangeBatch], sv[kRangeBatch];
  auto ld = [&](const __nv_bfloat16* p, bool in) {
    return in ? *reinterpret_cast<const uint4*>(p) : zero;
  };
  auto issue = [&](int r) {
    const __nv_bfloat16* src = x + (m0 + r) * ldx;
#pragma unroll
    for (int u = 0; u < kNormBatch; ++u) {
      const int c = lane * 8 + 256 * u;
      raw[u] = ld(src + c, c < K);
    }
#pragma unroll
    for (int u = 0; u < kRangeBatch; ++u) {
      const int c = lane * 8 + 256 * u, k = k_lo + c;
      xv[u] = ld(src + k, c < span && k < K);
      sv[u] = ld(scale + k, c < span && k < K);
    }
  };
  // the range's vectors u of a batch: normed, rounded, stored
  auto put = [&](int r, int c0, float inv) {
#pragma unroll
    for (int u = 0; u < kRangeBatch; ++u) {
      const int c = c0 + 256 * u;
      if (c < span) {
        uint4 o = zero;
        if (k_lo + c < K) {
          float v[8], s[8];
          unpack8(xv[u], v);
          unpack8(sv[u], s);
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            h[i] = __floats2bfloat162_rn(v[2 * i] * inv * s[2 * i],
                                         v[2 * i + 1] * inv * s[2 * i + 1]);
        }
        *dst(r, c) = o;
      }
    }
  };

  if (warp < live) issue(warp);
  meanwhile(live);  // while the first row's loads fly
  for (int r = warp; r < live; r += nw) {
    if (r != warp) issue(r);
    const __nv_bfloat16* src = x + (m0 + r) * ldx;
    float ss = 0.f;
    for (int c0 = lane * 8;; c0 += 256 * kNormBatch) {
#pragma unroll
      for (int u = 0; u < kNormBatch; ++u) {
        float v[8];
        unpack8(raw[u], v);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
      }
      if (c0 + 256 * kNormBatch >= K) break;
#pragma unroll
      for (int u = 0; u < kNormBatch; ++u) {
        const int c = c0 + 256 * (kNormBatch + u);
        raw[u] = ld(src + c, c < K);
      }
    }
    ss = warp_sum(ss);
    const float inv = 1.f / sqrtf(ss / static_cast<float>(K) + eps);
    for (int c0 = lane * 8;; c0 += 256 * kRangeBatch) {
      put(r, c0, inv);
      if (c0 + 256 * kRangeBatch >= span) break;
#pragma unroll
      for (int u = 0; u < kRangeBatch; ++u) {
        const int c = c0 + 256 * (kRangeBatch + u), k = k_lo + c;
        xv[u] = ld(src + k, c < span && k < K);
        sv[u] = ld(scale + k, c < span && k < K);
      }
    }
  }
}

// The split GEMM's walk: acc (this warp's 16 columns x nt n8 row tiles)
// = x[m0.., K tiles kt_lo .. min(kt_hi, ceil(K / BK)) - 1] @ W[same, n0..]
// in K order, through an NST-deep ring that copies only the nt * 8 live x
// rows. C^T fragment: acc[j][0..1] at (n = g, m = j*8 + 2t, +1),
// acc[j][2..3] at (n = g + 8, same m). Ends with __syncthreads().
template <int BN, int BK, bool KN, typename WT, int NST, bool TAIL = false>
__device__ __forceinline__ void split_mainloop(
    unsigned char* stages, const __nv_bfloat16* __restrict__ x,
    long long ldx, const WT* __restrict__ w, long long ldw, int M, int K,
    int N, int m0, int n0, int nt, int kt_lo, int kt_hi,
    float (&acc)[8][4]) {
  using T = Tile<BN, BK, KN, WT, NST>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wn = warp * 16;  // this warp's 16 columns
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  auto load_stage = [&](int i) {
    unsigned char* stage = stages + i % NST * T::kStageBytes;
    const int k0 = (kt_lo + i) * BK;
    load_x<BK, T::kThreads>(reinterpret_cast<__nv_bfloat16*>(stage), x, M, K,
                            ldx, m0, k0, nt * 8);
    load_w<BN, BK, T::kThreads, KN, WT, TAIL>(stage + T::kXBytes, w, K, N,
                                              ldw, n0, k0);
  };

  const int n = min(kt_hi, (K + BK - 1) / BK) - kt_lo;  // tiles to walk
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + NST - 1 < n) load_stage(i + NST - 1);
    cp_async_commit();         // possibly empty: keeps the group count uniform
    cp_async_wait<NST - 1>();  // tile i has landed
    __syncthreads();

    const unsigned char* stage = stages + i % NST * T::kStageBytes;
    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(stage);
    const unsigned char* wsb = stage + T::kXBytes;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      w_frag<BN, BK, KN, WT>(wsb, kk, wn, g, t, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const uint16_t* xr = xs16 + (j * 8 + g) * T::kXPitch + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
          mma_bf16(acc[j], a[0], a[1], a[2], a[3], b0, b1);
        }
      }
    }
    __syncthreads();  // stage i may be refilled next iteration
  }
}

// ---------------------------------------------------------------------------
// The flat GEMM's epilogue, out = x @ W, or resid + x @ W with a residual
// (decode_fuse.cu's oproj_residual; resid = nullptr for flat_gemm.cu),
// for the split body here and gemm_wgmma.cuh's. The accumulator rounds
// to bf16 before the add, so the residual form writes bf16(resid +
// bf16(x @ W)), as `resid + matmul(o, wo)` does. With codes (WT 1 byte)
// the step scale[n] multiplies the accumulator first: bf16(acc * step),
// and with a residual bf16(resid + bf16(acc * step)); bf16 weights take
// no scale.
// ---------------------------------------------------------------------------

// The epilogue of one output element from its f32 sum over all of K.
template <typename WT>
__device__ __forceinline__ void gemm_store(
    float v, int m, int n, int N, const float* __restrict__ scale,
    const __nv_bfloat16* __restrict__ resid, long long ldr,
    __nv_bfloat16* __restrict__ out) {
  if constexpr (kIsCode<WT>) v *= scale[n];
  if (resid != nullptr) v = bf2f(resid[m * ldr + n]) + bf2f(f2bf(v));
  out[static_cast<long long>(m) * N + n] = f2bf(v);
}

// Split K, for grids whose columns alone leave SMs idle (N = 896 gives
// 28 blocks of BN = 32 on 132 SMs, each walking all of K; gemm_wgmma.cuh
// takes every wider N). The launch's
// z axis holds S = gridDim.z fixed K ranges of ceil(n_kt / S) whole BK
// tiles each, counted from K = 0; the S blocks of one (column, row) tile
// form one thread-block cluster along z, block rank = split. Each block
// walks its range through a kSplitStages-deep cp.async ring, copying only
// its live x rows, and leaves its f32 accumulators in shared memory;
// after cluster.sync() every block folds one slice of the tile's
// elements over the S splits in split order (distributed shared memory:
// no atomics, no scratch) and runs the epilogue on the sum, so the step
// multiplies the summed f32 accumulator once, before the first rounding.
// S is a function of K, N and the card (kernels/flat_gemm.py::
// pick_splits), never of M, and an element's sum depends only on its own
// row and column: a row's bits are the same alone and in any batch,
// launch after launch. Launched at BN = kSplitBN: on the H100, at the
// same split count, 128-byte weight row segments stream faster than
// 64-byte ones, and the time falls with each block's share of K more
// than with anything else tried (ring depth, x rows per stage, warps
// that only copy). TAIL: a bf16 (K, N) weight whose rows are not 16-byte
// aligned, loaded element by element (load_w); the products are the
// same.
template <int BN, int BK, bool KN, typename WT, bool TAIL = false>
__global__ void __launch_bounds__(BN / 16 * 32)
gemm_split_kernel(const __nv_bfloat16* __restrict__ x,
                  const WT* __restrict__ w, const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ resid,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N,
                  long long ldx, long long ldw, long long ldr) {
  using T = Tile<BN, BK, KN, WT>;
  constexpr int NT = T::kThreads;
  static_assert(8 * 4 * NT * sizeof(float) <= T::kStagesBytes,
                "the partials reuse the stages");
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kMT;
  const int nt = min(8, (M - m0 + 7) / 8);  // live n8 token tiles
  const int per = ((K + BK - 1) / BK + S - 1) / S;  // K tiles per split
  float acc[8][4];
  split_mainloop<BN, BK, KN, WT, kSplitStages, TAIL>(
      smem, x, ldx, w, ldw, M, K, N, m0, n0, nt, z * per, (z + 1) * per, acc);

  // this split's partials, element e = (j * 4 + i) * NT + thread
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(j * 4 + i) * NT + threadIdx.x] = acc[j][i];
    }
  }
  cluster.sync();  // every split's partials are written and visible

  const int E = nt * 4 * NT;
  for (int e = E * z / S + threadIdx.x; e < E * (z + 1) / S; e += NT) {
    const int tid = e % NT, i = e / NT % 4, j = e / (4 * NT);
    const int lane = tid % 32;
    const int m = m0 + j * 8 + 2 * (lane % 4) + (i & 1);
    const int n = n0 + tid / 32 * 16 + lane / 4 + (i >> 1) * 8;
    if (m < M && n < N) {
      float v = *cluster.map_shared_rank(part + e, 0);
#pragma unroll 4
      for (int q = 1; q < S; ++q) v += *cluster.map_shared_rank(part + e, q);
      gemm_store<WT>(v, m, n, N, scale, resid, ldr, out);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int BN, int BK, bool KN, typename WT, bool TAIL>
int launch_gemm_split(int splits, const void* x, const void* w,
                      const void* scale, const void* resid, void* out, int M,
                      int K, int N, long long ldx, long long ldw,
                      long long ldr, cudaStream_t st) {
  using T = Tile<BN, BK, KN, WT>;
  auto kernel = gemm_split_kernel<BN, BK, KN, WT, TAIL>;
  cudaError_t e = allow_smem(kernel, T::kStagesBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + kMT - 1) / kMT, splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kStagesBytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using B = __nv_bfloat16;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const B*>(x),
                         static_cast<const WT*>(w),
                         static_cast<const float*>(scale),
                         static_cast<const B*>(resid), static_cast<B*>(out),
                         M, K, N, ldx, ldw, ldr);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool KN, typename WT, bool TAIL>
int dispatch_split_bk(int bk, int splits, const void* x, const void* w,
                      const void* scale, const void* resid, void* out, int M,
                      int K, int N, long long ldx, long long ldw,
                      long long ldr, cudaStream_t st) {
  constexpr int BN = kSplitBN;
#define REPRO_FS_CASE(BK_)                                                   \
  if (bk == BK_)                                                             \
    return launch_gemm_split<BN, BK_, KN, WT, TAIL>(splits, x, w, scale,     \
                                                    resid, out, M, K, N, ldx, \
                                                    ldw, ldr, st);
  REPRO_FS_CASE(32)
  REPRO_FS_CASE(64)
  REPRO_FS_CASE(128)
#undef REPRO_FS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// gemm_split_kernel at (kSplitBN, bk), K in 1 .. kMaxSplits ranges; a
// bf16 (K, N) weight with unaligned rows takes the TAIL loads, codes and
// (N, K) views must have aligned rows.
template <bool KN, typename WT>
int dispatch_gemm_split(int bk, int splits, const void* x, const void* w,
                        const void* scale, const void* resid, void* out,
                        int M, int K, int N, long long ldx, long long ldw,
                        long long ldr, cudaStream_t st) {
  if (splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KN && !kIsCode<WT>) {
    if (kn_tail(N, ldw, w))
      return dispatch_split_bk<KN, WT, true>(bk, splits, x, w, scale, resid,
                                             out, M, K, N, ldx, ldw, ldr, st);
  }
  return dispatch_split_bk<KN, WT, false>(bk, splits, x, w, scale, resid,
                                          out, M, K, N, ldx, ldw, ldr, st);
}

// The fused FFN-up's activation on an unrounded f32 accumulator: silu, or
// the tanh gelu.
__device__ __forceinline__ float activate(float g, bool gelu) {
  if (gelu) {
    // tanh approximation, jax.nn.gelu's default
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    return 0.5f * g * (1.f + tanhf(inner));
  }
  return g / (1.f + expf(-g));
}

}  // namespace flat
}  // namespace repro
