// The flat GEMM's body on Hopper's asynchronous tensor-core path:
// out = x @ W (or resid + x @ W) with wgmma on shared-memory tiles that
// TMA fills, for flat_gemm.cu's entries and decode_fuse.cu's
// oproj_residual wherever N is not narrow (narrow N runs
// flat_stream.cuh's split mma.sync body).
//
// Bound on H100: device-memory bytes. The flat GEMM's M < 128 (the T3
// ladder's flat rows) does at most 128 FLOPs a weight byte against the
// ~295 FLOP/byte ridge of the bf16 tensor cores: the weight stream (8.7
// MB for qwen2-0.5b's gate / up, 272 MB for its tied head; half as
// codes) sets the time. The mma.sync body this replaces gave gate / up
// 152 blocks of two warps (1.15 waves), 64-byte weight row segments, two
// cp.async stages of 8 KB and 64 copied x rows a stage whatever M.
//
// Design (ffn_norm_wgmma.cuh's operands, ring and fold):
//   * Operands swapped: each wgmma.m64n64k16 computes a 64 (output
//     columns) x 64 (token rows) tile of C^T = W^T x^T. A is the weight
//     tile: MN-major (the transpose bit) for a row-major (K, N) weight,
//     K-major for the (N, K) view of a row-major (N, K) tensor (the tied
//     head, embedding.T), whose TMA box is taken on the (N, K) tensor
//     itself. B is x^T, K-major.
//   * The token operand is 64 rows whatever M; gridDim.y takes further
//     64-row tiles, so any M runs (the T3 ladder sends M < 128 here). TMA
//     copies min(64, round_up(M, 8)) rows of a tile, zero-filling rows
//     past M; rows past the copy are left unread. A column of B feeds only
//     its own column of D and rows past M are never stored, and every row
//     runs the same instruction sequence over the same K tiles, so a row's
//     bits do not depend on its batch.
//   * Copies: one producer warp (lane 0) fills a ring of [W tile | x
//     tile] stages (64 K rows each, 128-byte swizzle) with
//     cp.async.bulk.tensor, min(kStages, the split's tiles) deep (at
//     least two); full / empty mbarriers hand each stage between it and
//     the one consumer warpgroup. The tensor maps are encoded per call and
//     passed __grid_constant__ (a CUDA graph keeps them by value).
//   * Codes (int8 / e4m3 in the (K, N) layout, _flat_gemm_quant_kernel's
//     port): TMA copies the code tile unswizzled at 1 byte; the consumers
//     turn it into the bf16 tile TMA would have written for a bf16 weight
//     (tc::codes_to_bf16) in one of two buffers, fence it to the async
//     proxy and run the bf16 products on it unchanged. The step
//     multiplies the f32 sum once, before the first rounding (gemm_store).
//   * Split K, only where 64-column tiles leave SMs idle (76 tiles at N =
//     4,864): gridDim.z = S fixed ranges of ceil(n_kt / S) whole 64-row K
//     tiles from K = 0 (S from kernels/flat_gemm.py::wgmma_splits: K, N,
//     the weight width and the card only, never M), the S blocks of a
//     column tile a cluster along z, each leaving its f32 partials in
//     shared memory and folding a slice of the tile's live elements over
//     the splits in split order through distributed shared memory (no
//     atomics, nothing to reset between graph replays). The tied head
//     (2,376 tiles) runs unsplit, each block storing its own sums.
//   * Epilogue (flat::gemm_store): (the step,) one rounding, or with a
//     residual bf16(resid + bf16(acc)).
// Needs K % 8 == 0, N % 8 == 0 ((K, N) bf16) or N % 16 == 0 (codes),
// ldw % 8 == 0 (16-byte row strides for TMA), 16-byte aligned bases.
#pragma once

#include <cooperative_groups.h>

#include "ffn_wgmma.cuh"

namespace repro {
namespace gw {

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
constexpr int kXBytes = kTok * kBK * 2;   // one x tile (8 KB)
constexpr int kAcc = kBN * kTok / 128;    // f32 accumulators a thread
static_assert(kAcc * 128 * 4 <= 2 * kXBytes, "the partials reuse the ring");

template <typename WT>
struct Smem {
  static constexpr int kWBytes = tc::kWBytes<WT>;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kConvBytes =
      flat::kIsCode<WT> ? 2 * tc::kTileBytes : 0;
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle period");
};

// Shared memory of a launch whose splits hold `per` K tiles: the ring,
// the conversion buffers (codes), 2 x kStages mbarriers, and room to
// align the ring to the swizzle's 1024-byte period.
template <typename WT>
inline size_t smem_bytes(int per) {
  return static_cast<size_t>(ring_stages(per)) * Smem<WT>::kStageBytes +
         Smem<WT>::kConvBytes + 2 * kStages * 8 + 1024;
}

template <bool KN, typename WT>
__global__ void __launch_bounds__(kThreads, kMaxBlocks)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap tx,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ resid,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N,
                  long long ldr, int x_rows) {
  static_assert(KN || !flat::kIsCode<WT>, "codes come in the (K, N) layout");
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
  unsigned char* conv = smem + nst * L::kStageBytes;
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
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
  }
  __syncthreads();

  float acc[kAcc];
  if (warp == 4) {
    // the producer: one thread issues every copy
    if (threadIdx.x % 32 == 0) {
      const uint32_t bytes =
          static_cast<uint32_t>(L::kWBytes + x_rows * 128);
      for (int i = 0; i < n; ++i) {
        const int s = i % nst;
        if (i >= nst) mbar_wait(&empty[s], (i / nst - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        const int k0 = (kt_lo + i) * kBK;
        mbar_expect_tx(&full[s], bytes);
        if constexpr (KN)
          tma_load(st, &tw, n0, k0, &full[s]);
        else
          tma_load(st, &tw, k0, n0, &full[s]);
        tma_load(st + L::kWBytes, &tx, k0, m0, &full[s]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int s = i % nst;
      mbar_wait(&full[s], (i / nst) & 1);
      unsigned char* stp = smem + s * L::kStageBytes;
      uint32_t wa = smem_u32(stp);
      if constexpr (flat::kIsCode<WT>) {
        // buffer i % 2 was last read by tile i - 2's products: the first
        // barrier waits for every warp to have seen them done
        unsigned char* cv = conv + (i & 1) * tc::kTileBytes;
        bar_sync(128);
        tc::codes_to_bf16<WT>(cv, stp, threadIdx.x, 128);
        tc::fence_async_smem();
        bar_sync(128);
        wa = smem_u32(cv);
      }
      const uint32_t xb = smem_u32(stp + L::kWBytes);
      fence_regs(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // B: 32 bytes into each token row a step, 8-row groups 1024 bytes
        // apart. A, (K, N): 16 weight rows of 128 bytes a step; (N, K):
        // 32 bytes into each column's row a step, like B
        const uint64_t db = desc_sw128(xb + kk * 32, 16, 1024);
        if constexpr (KN)
          tc::wgmma_n64<1>(acc, desc_sw128(wa + kk * 2048, 1024, 1024), db);
        else
          tc::wgmma_n64<0>(acc, desc_sw128(wa + kk * 32, 16, 1024), db);
      }
      tc::wgmma_commit();
      // keep this tile's products in flight; the previous tile's are
      // done, so its stage goes back to the producer
      tc::wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && threadIdx.x == 0) mbar_arrive(&empty[(i - 1) % nst]);
    }
    tc::wgmma_wait<0>();
    fence_regs(acc);
  }

  // fragment i of consumer thread 32 w + lane holds column 16 w + lane /
  // 4 + 8 (bit 1 of i) and token 8 (i / 4) + 2 (lane % 4) + (bit 0 of i)
  if (S == 1) {
    if (warp < 4) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int nn = n0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int m = m0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        if (m < M && nn < N)
          flat::gemm_store<WT>(acc[i], m, nn, N, scale, resid, ldr, out);
      }
    }
    return;
  }

  // this split's partials over the dead ring (every tile has landed and
  // been read by every warp): part[i * 128 + thread]
  float* part = reinterpret_cast<float*>(smem);
  if (warp < 4) {
    bar_sync(128);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) part[i * 128 + threadIdx.x] = acc[i];
  }
  cluster.sync();  // every split's partials are written and visible

  // each block folds one slice of the live (token, column) elements over
  // the splits in split order (every split's value requested before the
  // sum)
  const int E = min(kTok, M - m0) * kBN;
  for (int e = E * z / S + threadIdx.x; e < E * (z + 1) / S;
       e += kThreads) {
    const int m = e / kBN, c = e % kBN;
    const int nn = n0 + c;
    if (nn >= N) continue;
    const int tid = (c / 16) * 32 + (c % 8) * 4 + (m % 8) / 2;
    const int i = (m / 8) * 4 + ((c % 16) / 8) * 2 + m % 2;
    const float* p = part + i * 128 + tid;
    float vs[flat::kMaxSplits];
#pragma unroll
    for (int q = 0; q < flat::kMaxSplits; ++q)
      if (q < S) vs[q] = *cluster.map_shared_rank(p, q);
    float v = vs[0];
#pragma unroll
    for (int q = 1; q < flat::kMaxSplits; ++q)
      if (q < S) v += vs[q];
    flat::gemm_store<WT>(v, m0 + m, nn, N, scale, resid, ldr, out);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// out (M, N) = x @ W (+ resid); x (M, K; row stride ldx); W[k, n] at
// w[k * ldw + n] (KN) or w[n * ldw + k]; K in `splits` ranges folded in
// order.
template <bool KN, typename WT>
int launch_gemm_wgmma(int splits, const void* x, const void* w,
                      const void* scale, const void* resid, void* out, int M,
                      int K, int N, long long ldx, long long ldw,
                      long long ldr, cudaStream_t st) {
  constexpr bool kCode = flat::kIsCode<WT>;
  if (splits < 1 || splits > flat::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::EncodeTiledFn enc = tc::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int x_rows = min(kTok, (M + 7) / 8 * 8);
  CUtensorMap mw, mx;
  const bool ok = KN ? tc::make_map(enc, &mw, w, N, K, ldw, kBK, kCode)
                     : tc::make_map(enc, &mw, w, K, N, ldw, kBN);
  if (!ok || !tc::make_map(enc, &mx, x, K, M, ldx, x_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = ((K + kBK - 1) / kBK + splits - 1) / splits;
  const size_t smem = smem_bytes<WT>(per);
  auto kernel = gemm_wgmma_kernel<KN, WT>;
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
  e = cudaLaunchKernelEx(&cfg, kernel, mw, mx,
                         static_cast<const float*>(scale),
                         static_cast<const B*>(resid), static_cast<B*>(out),
                         M, K, N, ldr, x_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Every flat GEMM launch: `split` = 1 runs flat_stream.cuh's split
// mma.sync body (narrow N) at (kSplitBN, bk), 0 this wgmma body (bk
// must be kBK); K in `splits` ranges either way.
template <bool KN, typename WT>
int dispatch(int split, int bk, int splits, const void* x, const void* w,
             const void* scale, const void* resid, void* out, int M, int K,
             int N, long long ldx, long long ldw, long long ldr,
             cudaStream_t st) {
  if (split)
    return flat::dispatch_gemm_split<KN, WT>(bk, splits, x, w, scale, resid,
                                            out, M, K, N, ldx, ldw, ldr, st);
  if (bk != kBK) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm_wgmma<KN, WT>(splits, x, w, scale, resid, out, M, K, N,
                                   ldx, ldw, ldr, st);
}

// The quantized entry: codes int8 (fp8 = 0) or e4m3 (fp8 = 1) in the
// (K, N) layout, steps (N,) f32, optional residual.
inline int dispatch_q8(int fp8, int split, int bk, int splits, const void* x,
                       const void* w, const void* scale, const void* resid,
                       void* out, int M, int K, int N, long long ldx,
                       long long ldw, long long ldr, cudaStream_t st) {
  if (fp8)
    return dispatch<true, __nv_fp8_e4m3>(split, bk, splits, x, w, scale,
                                         resid, out, M, K, N, ldx, ldw, ldr,
                                         st);
  return dispatch<true, int8_t>(split, bk, splits, x, w, scale, resid, out,
                                M, K, N, ldx, ldw, ldr, st);
}

}  // namespace gw
}  // namespace repro
