// The bf16 fused FFN-up on Hopper's asynchronous tensor-core path:
// h = act(x @ Wg) * (x @ Wu) with wgmma on shared-memory tiles that TMA
// fills, for fused_ffn.cu's bf16 entry.
//
// Bound on H100: device-memory bytes for a decode tick's rows, the
// tensor cores from about 256 rows up (2 * 8.7 MB of weights at N =
// 4,864; 4 * M * K * N FLOPs). The mma.sync body (flat_stream.cuh's
// ffn_up_kernel) gave every 64-row block its own pass over both weight
// streams through a two-stage cp.async ring: at a chunk step's M = 256
// that is four passes and 9.3x the bound.
//
// Design:
//   * Operands swapped, as in the mma.sync body, so that M is a free
//     dimension: each wgmma.m64n128k16 computes a 64 (output columns)
//     x 128 (token rows) tile of G^T = Wg^T x^T (and U^T likewise). A is the
//     weight tile Wg^T read from shared memory as an MN-major operand (W
//     is row-major (K, N), so its 64 columns are contiguous: the
//     transpose bit); B is x^T, K-major (x is row-major (M, K)).
//   * The token operand is 128 rows (two 64-row x tiles) whatever M;
//     rows past M are zero-filled by the copy or left unread, and never
//     stored (a column of B feeds only its own column of D). Every row
//     runs the same instruction sequence over the same K tiles, so a
//     row's bits do not depend on its batch or on its place in a tile
//     (the smoke checks this at M in {1, 4, 13, 64, 256, 1024}).
//   * A block covers kBN = 64 columns and kRows = 256 token rows: two
//     consumer warpgroups of 128 rows each (2 streams x an m64n128 f32
//     accumulator = 128 registers a thread), each keeping one K tile of
//     products in flight while it issues the next; gridDim.y takes the
//     next 256 rows, which covers a one-shot prefill's B*S. x tiles past
//     M are not copied, and a consumer with no row does nothing.
//   * Copies: one producer thread (warpgroup 0, its registers handed to
//     the consumers with setmaxnreg) fills a kStages-deep ring of
//     [Wg tile | Wu tile | up to four x tiles] with
//     cp.async.bulk.tensor (TMA), 64-element (128-byte) rows in the
//     128-byte swizzle that the wgmma descriptors name; full / empty
//     mbarriers hand each stage between producer and consumers. The
//     tensor maps are built on the host per call (cuTensorMapEncodeTiled,
//     reached through the runtime's driver entry point, so nothing links
//     libcuda) and passed as __grid_constant__ parameters, which a CUDA
//     graph keeps by value.
//   * Epilogue: act(g) * u on the unrounded f32 accumulators (silu, or
//     the tanh gelu of flat::activate), one rounding to bf16, only h
//     written.
// Needs K % 8 == 0 and N % 8 == 0 (16-byte row strides for TMA), W
// contiguous, 16-byte aligned bases.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no driver call is linked

#include "flat_stream.cuh"

namespace repro {
namespace tc {

constexpr int kBN = 64;       // output columns per block: the wgmma's m64
constexpr int kBK = 64;       // K per stage: one 128-byte swizzled bf16 row
constexpr int kTok = 64;      // token rows per x tile (two per wgmma n128)
constexpr int kTiles = 4;     // token tiles per block, two per consumer
constexpr int kRows = kTok * kTiles;
constexpr int kStages = 4;    // TMA ring depth
constexpr int kThreads = 384; // warpgroup 0 copies, 1 and 2 multiply
constexpr int kXBytes = kTok * kBK * 2;   // one x tile (8 KB)
constexpr int kWBytes = kBK * kBN * 2;    // one weight tile (8 KB)
constexpr int kStageBytes = 2 * kWBytes + kTiles * kXBytes;
// the ring, its 2 x kStages mbarriers, and room to align the ring to the
// swizzle's 1024-byte period
constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * kStageBytes + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "the ring must fit a block");
static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle period");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA tile load (c0 the inner coordinate) completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, f32) += A (64 x 16, MN-major: the transpose bit) * B (16
// x 128, K-major), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_tn(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's fence and wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tu,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int gelu) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kRows;
  const int live = min(kTiles, (M - m0 + kTok - 1) / kTok);  // x tiles
  const int n_kt = (K + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], (live + 1) / 2);  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // the producer: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const uint32_t bytes =
          static_cast<uint32_t>(2 * kWBytes + live * kXBytes);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = smem + s * kStageBytes;
        const int k0 = kt * kBK;
        mbar_expect_tx(&full[s], bytes);
        tma_load(st, &tg, n0, k0, &full[s]);
        tma_load(st + kWBytes, &tu, n0, k0, &full[s]);
        for (int t = 0; t < live; ++t)
          tma_load(st + 2 * kWBytes + t * kXBytes, &tx, k0, m0 + t * kTok,
                   &full[s]);
      }
    }
  } else {
    // a consumer: token tiles t0 and t0 + 1 of this block, both in one
    // n128 operand (the two x tiles are adjacent in the stage)
    setmaxnreg_inc<232>();
    const int t0 = 2 * (wgi - 1);
    if (t0 < live) {
      float acc[2][64];  // [gate / up][fragment]
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[a][i] = 0.f;

      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&full[s], (kt / kStages) & 1);
        const uint32_t st = smem_u32(smem + s * kStageBytes);
        const uint32_t xb = st + 2 * kWBytes + t0 * kXBytes;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: 16 weight rows of 128 bytes per step, 8-row groups 1024
          // bytes apart; B: 32 bytes into each token row per step, 8-row
          // groups 1024 bytes apart
          const uint64_t db = desc_sw128(xb + kk * 32, 16, 1024);
          wgmma_tn(acc[0], desc_sw128(st + kk * 2048, 1024, 1024), db);
          wgmma_tn(acc[1], desc_sw128(st + kWBytes + kk * 2048, 1024, 1024),
                   db);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // keep this tile's products in flight; the previous tile's are
        // done, so its stage goes back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(&empty[(kt - 1) % kStages]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc[0]);
      fence_regs(acc[1]);

      // fragment i of a warp: column 16 w + lane / 4 (+ 8 for bit 1 of
      // i), token 8 (i / 4) + 2 (lane % 4) (+ 1 for bit 0 of i) of the
      // two tiles
      const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int n = n0 + 16 * w + lane / 4 + 8 * ((i >> 1) & 1);
        const int m =
            m0 + t0 * kTok + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        if (m < M && n < N)
          out[static_cast<long long>(m) * N + n] =
              f2bf(flat::activate(acc[0][i], gelu != 0) * acc[1][i]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library links no libcuda; nullptr when the driver lacks it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 (rows x inner) matrix with row stride `ld` elements, read in
// boxes of 64 inner elements (128 bytes) x `box_rows`, 128-byte swizzle,
// zeros past the edges.
inline bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                     int inner, int rows, long long ld, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = act(x @ Wg) * (x @ Wu); x (M, K; row stride ldx), Wg / Wu
// contiguous row-major (K, N).
inline int launch_ffn_up_wgmma(const void* x, const void* wgp,
                               const void* wup, void* out, int M, int K,
                               int N, long long ldx, int gelu,
                               cudaStream_t st) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mg, mu;
  if (!make_map(enc, &mx, x, K, M, ldx, kTok) ||
      !make_map(enc, &mg, wgp, N, K, N, kBK) ||
      !make_map(enc, &mu, wup, N, K, N, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(ffn_up_wgmma_kernel, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + kBN - 1) / kBN, (M + kRows - 1) / kRows);
  ffn_up_wgmma_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      mx, mg, mu, static_cast<__nv_bfloat16*>(out), M, K, N, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace repro
