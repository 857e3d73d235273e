// The rmsnorm-fused FFN-up at decode M on Hopper's asynchronous
// tensor-core path: h = act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu), with
// wgmma on weight tiles that TMA fills and K split over a thread-block
// cluster, for decode_fuse.cu's ffn_norm_bf16 and ffn_norm_q8 entries.
//
// Bound on H100: device-memory bytes. At a decode tick's M (the slot
// count) the two weight streams (2 * K * N * 2 bytes, 17.4 MB at qwen2-
// 0.5b's 896 -> 4,864; half that as codes) are the work; the products
// are under 1 FLOP a byte. The mma.sync body this replaced ran 152
// blocks of 64 threads, each streaming both weights over all of K
// through a two-stage cp.async ring: two warps a SM issuing copies, 1.15
// waves on 132 SMs.
//
// Design (ffn_wgmma.cuh's operands and ring, sized for decode):
//   * Operands swapped: each wgmma.m64n64k16 computes a 64 (output
//     columns) x 64 (token rows) tile of G^T = Wg^T xn^T (and U^T
//     likewise). A is the weight tile Wg^T, MN-major in shared memory (the
//     transpose bit); B is the normed rows xn^T, K-major.
//   * The token operand is 64 rows whatever M; rows past M are zero and
//     never stored, and every row runs the same instruction sequence over
//     the same K tiles, so a row's bits do not depend on its batch.
//   * x is not copied by TMA: the consumer warpgroup normalises its 64
//     rows once (flat::norm_rows_range: the row's rms over all of K in one
//     fixed order, then bf16(x * inv * scale), rounded where ffn_norm_plain
//     rounds) and writes only its K range, in the 128-byte swizzle that
//     TMA would have written, into a resident K-major operand, while the
//     producer's first weight tiles are already in flight.
//   * Weights: one producer warp (lane 0) fills a ring of [Wg tile | Wu
//     tile] stages (64 K rows x 64 columns each, 128-byte swizzle) with
//     cp.async.bulk.tensor, min(kStages, the split's tiles) deep (at
//     least two), so a short split has all its tiles in flight at once;
//     full / empty mbarriers hand each stage between it and the one
//     consumer warpgroup. The tensor maps are encoded per call and passed
//     __grid_constant__ (a CUDA graph keeps them by value).
//   * Codes (int8 / e4m3, the quantized _ffn_norm_kernel): the stages
//     hold the two code tiles at 1 byte, unswizzled; the consumers turn
//     them into bf16 tiles in one of two buffers (tc::codes_to_bf16, as
//     the fused FFN-up does), fence them to the async proxy and run the
//     bf16 products on them. The steps sg[n] / su[n] multiply the folded
//     f32 sums before the activation.
//   * Split K: 64-column tiles alone (76 at N = 4,864) leave SMs idle, so
//     gridDim.z = S fixed ranges of ceil(n_kt / S) whole 64-row K tiles
//     from K = 0 (S from kernels/decode_fuse.py::ffn_norm_splits: K, N,
//     the weight width and the card only, never M); the S blocks of a
//     column tile form a cluster along z. Each leaves its f32 g and u
//     partials in shared memory; after cluster.sync() every block folds a
//     slice of the live elements over the splits in split order through
//     distributed shared memory (no atomics, nothing to reset between
//     graph replays) and applies act(g) * u to the folded f32 sums, with
//     one rounding.
//   * Blocks of 160 threads (a consumer warpgroup and a producer warp)
//     run up to kMaxBlocks a SM (registers), as shared memory allows; the
//     split count is the largest whose clusters all fit the GPCs at once
//     at that occupancy (a cluster's blocks share a GPC). At qwen2-0.5b:
//     three splits of five K tiles, two blocks a SM, 228 blocks, bf16 and
//     codes alike. (Five splits of three tiles, three a SM, left two
//     clusters for a second wave on the H100 and ran slower.)
//   * Latency, with one warp a scheduler: the norm issues a row's loads
//     (sum and range) at once and zeroes the dead rows under them, so it
//     ends before the first weight tile lands; the fold requests every
//     split's value before summing.
// Needs K % 8 == 0 and N % 8 == 0 (16 for codes: 16-byte row strides for
// TMA and the norm's vectors), W contiguous, 16-byte aligned bases,
// ldx % 8 == 0.
#pragma once

#include <cooperative_groups.h>

#include "ffn_wgmma.cuh"

namespace repro {
namespace tcn {

using tc::bar_sync;
using tc::desc_sw128;
using tc::fence_regs;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::kStages;
using tc::mbar_wait;
using tc::ring_stages;
using tc::smem_u32;
using tc::tma_load;

constexpr int kBN = 64;        // output columns per block: the wgmma's m64
constexpr int kBK = 64;        // K per tile and split chunk: 128-byte rows
constexpr int kTok = 64;       // token rows per block: the wgmma's n64
constexpr int kThreads = 160;  // warps 0-3 multiply, warp 4 copies
constexpr int kMaxBlocks = 4;  // blocks a SM the register cap allows
constexpr int kXBytes = kTok * kBK * 2;     // one K tile of normed rows
constexpr int kAcc = kBN * kTok / 128;      // f32 accumulators a thread

template <typename WT>
struct Smem {
  static constexpr int kWBytes = tc::kWBytes<WT>;
  static constexpr int kStageBytes = 2 * kWBytes;  // gate | up
  // two bf16 buffers of both streams' converted tiles (codes only)
  static constexpr int kConvBytes =
      flat::kIsCode<WT> ? 2 * 2 * tc::kTileBytes : 0;
  // the smallest launch: two stages, one tile of normed rows
  static_assert(2 * kAcc * 128 * 4 <= 2 * kStageBytes + kXBytes + kConvBytes,
                "the partials reuse the ring, the rows and the buffers");
};

// Shared memory of a launch whose splits hold `per` K tiles: the ring, the
// normed rows' tiles, the conversion buffers (codes), 2 x kStages
// mbarriers, and room to align the ring to the swizzle's 1024-byte period.
template <typename WT>
inline size_t smem_bytes(int per) {
  return static_cast<size_t>(ring_stages(per)) * Smem<WT>::kStageBytes +
         static_cast<size_t>(per) * kXBytes + Smem<WT>::kConvBytes +
         2 * kStages * 8 + 1024;
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, kMaxBlocks)
ffn_norm_wgmma_kernel(const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tu,
                      const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ scale,
                      const float* __restrict__ sg,
                      const float* __restrict__ su,
                      __nv_bfloat16* __restrict__ out, int M, int K, int N,
                      long long ldx, int gelu, float eps) {
  using L = Smem<WT>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the same offset in every block of the launch, so the partials below
  // sit at one address in every block of a cluster
  unsigned char* smem = tc::align_1024(smem_raw);

  // this split's K tiles: ceil(n_kt / S) whole tiles each from K = 0
  const int n_kt = (K + kBK - 1) / kBK;
  const int per = (n_kt + S - 1) / S;
  const int kt_lo = min(n_kt, z * per);
  const int n = min(n_kt, kt_lo + per) - kt_lo;
  const int nst = ring_stages(per);
  unsigned char* xres = smem + nst * L::kStageBytes;
  unsigned char* conv = xres + per * kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + L::kConvBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kTok;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // one arrival: the consumer warpgroup's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  } else if (threadIdx.x == 128) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tg) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tu) : "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: one thread issues every weight copy
    if (threadIdx.x % 32 == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % nst;
        if (i >= nst) mbar_wait(&empty[s], (i / nst - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        const int k0 = (kt_lo + i) * kBK;
        mbar_expect_tx(&full[s], L::kStageBytes);
        tma_load(st, &tg, n0, k0, &full[s]);
        tma_load(st + L::kWBytes, &tu, n0, k0, &full[s]);
      }
    }
  } else {
    // the consumer warpgroup: this range of the normed rows, written as
    // TMA's 128-byte swizzle lays a K-major tile (16-byte chunk c of row r
    // at chunk c ^ (r % 8)), then the products
    // the dead rows of tile t are its bytes from live * 128 on (the
    // swizzle moves chunks within a row only)
    flat::norm_rows_range(
        [=](int r, int c) {
          return reinterpret_cast<uint4*>(
              xres + (c / kBK) * kXBytes + r * 128 +
              ((((c % kBK) / 8) ^ (r & 7)) * 16));
        },
        [=](int live) {
          for (int t = 0; t < per; ++t) {
            uint4* p = reinterpret_cast<uint4*>(xres + t * kXBytes);
            for (int i = live * 8 + threadIdx.x; i < kXBytes / 16; i += 128)
              p[i] = make_uint4(0u, 0u, 0u, 0u);
          }
        },
        x, ldx, scale, M, K, m0, kTok, kt_lo * kBK, per * kBK, eps, warp, 4);
    // the generic-proxy writes become visible to wgmma's reads, then the
    // warpgroup meets (named barrier 1: the producer warp is not in it)
    tc::fence_async_smem();
    bar_sync(128);

    float acc[2][kAcc];  // [gate / up][fragment]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[a][i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int s = i % nst;
      mbar_wait(&full[s], (i / nst) & 1);
      unsigned char* stp = smem + s * L::kStageBytes;
      uint32_t wa = smem_u32(stp);  // gate's bf16 tile; up's follows
      if constexpr (flat::kIsCode<WT>) {
        // buffer i % 2 was last read by tile i - 2's products: the first
        // barrier waits for every warp to have seen them done
        unsigned char* cv = conv + (i & 1) * 2 * tc::kTileBytes;
        bar_sync(128);
        tc::codes_to_bf16<WT>(cv, stp, threadIdx.x, 128);
        tc::codes_to_bf16<WT>(cv + tc::kTileBytes, stp + L::kWBytes,
                              threadIdx.x, 128);
        tc::fence_async_smem();
        bar_sync(128);
        wa = smem_u32(cv);
      }
      const uint32_t xb = smem_u32(xres + i * kXBytes);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 16 weight rows of 128 bytes a step, 8-row groups 1024 bytes
        // apart; B: 32 bytes into each token row a step, 8-row groups
        // 1024 bytes apart
        const uint64_t db = desc_sw128(xb + kk * 32, 16, 1024);
        tc::wgmma_n64<1>(acc[0], desc_sw128(wa + kk * 2048, 1024, 1024), db);
        tc::wgmma_n64<1>(
            acc[1], desc_sw128(wa + tc::kTileBytes + kk * 2048, 1024, 1024),
            db);
      }
      tc::wgmma_commit();
      // keep this tile's products in flight; the previous tile's are
      // done, so its stage goes back to the producer
      tc::wgmma_wait<1>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (i > 0 && threadIdx.x == 0) mbar_arrive(&empty[(i - 1) % nst]);
    }
    tc::wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // this split's partials over the dead ring and rows (every tile has
    // landed and been read by every warp): part[(a * kAcc + i) * 128 +
    // thread]
    bar_sync(128);
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        part[(a * kAcc + i) * 128 + threadIdx.x] = acc[a][i];
  }
  cluster.sync();  // every split's partials are written and visible

  // each block folds one slice of the live (token, column) elements over
  // the splits in split order (every split's value requested before the
  // sums); fragment i of consumer thread 32 w + lane
  // holds column 16 w + lane / 4 + 8 (bit 1 of i) and token 8 (i / 4) +
  // 2 (lane % 4) + (bit 0 of i)
  const float* part = reinterpret_cast<const float*>(smem);
  const int E = min(kTok, M - m0) * kBN;
  for (int e = E * z / S + threadIdx.x; e < E * (z + 1) / S;
       e += kThreads) {
    const int m = e / kBN, c = e % kBN;
    const int nn = n0 + c;
    if (nn >= N) continue;
    const int tid = (c / 16) * 32 + (c % 8) * 4 + (m % 8) / 2;
    const int i = (m / 8) * 4 + ((c % 16) / 8) * 2 + m % 2;
    const float* pg = part + i * 128 + tid;
    const float* pu = pg + kAcc * 128;
    float gs[flat::kMaxSplits], us[flat::kMaxSplits];
#pragma unroll
    for (int q = 0; q < flat::kMaxSplits; ++q) {
      if (q < S) {
        gs[q] = *cluster.map_shared_rank(pg, q);
        us[q] = *cluster.map_shared_rank(pu, q);
      }
    }
    float gv = gs[0], uv = us[0];
#pragma unroll
    for (int q = 1; q < flat::kMaxSplits; ++q) {
      if (q < S) {
        gv += gs[q];
        uv += us[q];
      }
    }
    if constexpr (flat::kIsCode<WT>) {
      gv *= sg[nn];
      uv *= su[nn];
    }
    out[static_cast<long long>(m0 + m) * N + nn] =
        f2bf(flat::activate(gv, gelu != 0) * uv);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// out (M, N) = act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu); x (M, K; row
// stride ldx), scale (K,), Wg / Wu contiguous row-major (K, N): bf16, or
// codes with (N,) f32 steps sg / su; K in `splits` ranges folded in order.
template <typename WT>
int launch_ffn_norm_wgmma(const void* x, const void* scale, const void* wgp,
                          const void* wup, const void* sg, const void* su,
                          void* out, int M, int K, int N, long long ldx,
                          int gelu, int splits, float eps, cudaStream_t st) {
  constexpr bool kCode = flat::kIsCode<WT>;
  if (splits < 1 || splits > flat::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::EncodeTiledFn enc = tc::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mg, mu;
  if (!tc::make_map(enc, &mg, wgp, N, K, N, kBK, kCode) ||
      !tc::make_map(enc, &mu, wup, N, K, N, kBK, kCode))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = ((K + kBK - 1) / kBK + splits - 1) / splits;
  const size_t smem = smem_bytes<WT>(per);
  auto kernel = ffn_norm_wgmma_kernel<WT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kTok - 1) / kTok, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using B = __nv_bfloat16;
  e = cudaLaunchKernelEx(&cfg, kernel, mg, mu, static_cast<const B*>(x),
                         static_cast<const B*>(scale),
                         static_cast<const float*>(sg),
                         static_cast<const float*>(su), static_cast<B*>(out),
                         M, K, N, ldx, gelu, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tcn
}  // namespace repro
