// The fused FFN-up on Hopper's asynchronous tensor-core path:
// h = act(x @ Wg) * (x @ Wu) with wgmma on shared-memory tiles that TMA
// fills, for fused_ffn.cu's bf16 and quantized entries; and the helpers
// every wgmma / TMA body of the port shares (mbarriers, TMA loads, the
// 128-byte-swizzle descriptors, the wgmma instructions, tensor maps,
// the code-tile conversion).
//
// Bound on H100: device-memory bytes for a decode tick's rows, the
// tensor cores from about 256 rows up (2 * 8.7 MB of bf16 weights at N =
// 4,864, half that as codes; 4 * M * K * N FLOPs).
//
// Design:
//   * Operands swapped, so that M is a free dimension: each
//     wgmma.m64n128k16 computes a 64 (output columns) x 128 (token rows)
//     tile of G^T = Wg^T x^T (and U^T likewise). A is the weight tile
//     Wg^T read from shared memory as an MN-major operand (W is row-major
//     (K, N), so its 64 columns are contiguous: the transpose bit); B is
//     x^T, K-major (x is row-major (M, K)).
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
//   * Codes (int8 / e4m3, the quantized branch of _fused_ffn_kernel):
//     TMA copies each (64 K rows x 64 columns) code tile unswizzled at 1
//     byte, half a bf16 tile's bytes. The consumers with rows turn the
//     stage's two code tiles together into the bf16 tiles TMA would have
//     written for bf16 weights (codes_to_bf16: each code its exact bf16
//     value, 128-byte swizzle), fence them to the async proxy and run the
//     bf16 products on them unchanged. Two conversion buffers: tile i's
//     conversion overlaps tile i - 1's products. Kept over feeding A
//     from registers: the fragment loads would be single bytes from
//     64-byte rows, four lanes to a bank.
//   * Epilogue: (the steps sg[n] / su[n] on codes,) act(g) * u on the
//     unrounded f32 accumulators (silu, or the tanh gelu of
//     flat::activate), one rounding to bf16, only h written.
// Needs K % 8 == 0 and N % 8 == 0 (N % 16 for codes: 16-byte row strides
// for TMA), W contiguous, 16-byte aligned bases.
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
constexpr int kStages = 4;    // TMA ring depth (at most, split K)
constexpr int kThreads = 384; // warpgroup 0 copies, 1 and 2 multiply
constexpr int kXBytes = kTok * kBK * 2;   // one x tile (8 KB)
constexpr int kTileBytes = kBK * kBN * 2; // one bf16 weight tile (8 KB)

// One weight tile of WT elements (a bf16 tile, or half of one as codes).
template <typename WT>
constexpr int kWBytes = kBK * kBN * static_cast<int>(sizeof(WT));

template <typename WT>
struct FfnSmem {
  static constexpr int kStageBytes = 2 * kWBytes<WT> + kTiles * kXBytes;
  // two bf16 buffers of both streams' converted tiles (codes only)
  static constexpr int kConvBytes =
      flat::kIsCode<WT> ? 2 * 2 * kTileBytes : 0;
  // the ring, the conversion buffers, 2 x kStages mbarriers, and room to
  // align the ring to the swizzle's 1024-byte period
  static constexpr size_t kBytes =
      static_cast<size_t>(kStages) * kStageBytes + kConvBytes +
      2 * kStages * 8 + 1024;
  static_assert(kBytes <= 232448, "the ring must fit a block");
  static_assert(kStageBytes % 1024 == 0, "stages keep the swizzle period");
};

// Ring stages of a split-K launch whose splits hold `per` K tiles: every
// tile of a split in flight at once where it holds kStages or fewer (at
// least two).
__host__ __device__ inline int ring_stages(int per) {
  return per < 2 ? 2 : per < kStages ? per : kStages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's period): the same offset in every block of a launch.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
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

// Named barrier 1, complete when `threads` threads have arrived (whole
// consumer warpgroups; the producer never takes part).
__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// D (64 x 64, f32) += A (64 x 16) * B (16 x 64, K-major), both bf16 in
// shared memory; A MN-major (TA = 1, the transpose bit: a row-major
// (K, N) weight tile) or K-major (TA = 0: an (N, K) tile).
template <int TA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's fence and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Four codes (the low byte first) as two packed pairs of their exact
// bf16 values. int8 by integer and f32 arithmetic only, at the ALU's rate
// rather than the conversion instructions' quarter rate (two of those a
// code): the code plus 128 (the sign bit flipped) as the low mantissa
// byte of 2^23, minus 2^23 + 128, which is exact, and the bf16 bits are
// the f32's upper half (at most 8 significant bits: truncation is exact).
// e4m3 by the paired conversions (e4m3x2 to f16x2, to f32, to bf16x2).
template <typename CT>
__device__ __forceinline__ uint2 codes4_to_bf16(uint32_t word);

template <>
__device__ __forceinline__ uint2 codes4_to_bf16<int8_t>(uint32_t word) {
  const uint32_t u = word ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

template <>
__device__ __forceinline__ uint2 codes4_to_bf16<__nv_fp8_e4m3>(
    uint32_t word) {
  uint32_t o[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(word >> (16 * i)), __NV_E4M3);
    const float2 v = __half22float2(__half2(h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint2(o[0], o[1]);
}

// The (64 K rows x 64 columns) code tile `src` as TMA copies it
// unswizzled (row k's 64 codes at k * 64) written to `dst` as the bf16
// tile TMA writes for a bf16 weight with the 128-byte swizzle (row k's
// 128 bytes at k * 128, 16-byte chunk c at chunk c ^ (k % 8)), each code
// its exact bf16 value; thread `tid` of `nt` takes chunks tid, tid + nt,
// ... (neighbouring threads read neighbouring 8-byte groups).
template <typename CT>
__device__ __forceinline__ void codes_to_bf16(unsigned char* dst,
                                              const unsigned char* src,
                                              int tid, int nt) {
#pragma unroll 4
  for (int i = tid; i < kBK * kBN / 8; i += nt) {
    const int k = i / 8, c = i % 8;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + i * 8);
    const uint2 lo = codes4_to_bf16<CT>(raw.x), hi = codes4_to_bf16<CT>(raw.y);
    const uint4 o = make_uint4(lo.x, lo.y, hi.x, hi.y);
    *reinterpret_cast<uint4*>(dst + k * 128 + ((c ^ (k & 7)) * 16)) = o;
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tu,
                    const float* __restrict__ sg,
                    const float* __restrict__ su,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N,
                    int gelu) {
  using L = FfnSmem<WT>;
  constexpr int kW = kWBytes<WT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* conv = smem + kStages * L::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + L::kConvBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kRows;
  const int live = min(kTiles, (M - m0 + kTok - 1) / kTok);  // x tiles
  const int consumers = (live + 1) / 2;  // with token rows
  const int n_kt = (K + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    // the producer: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(2 * kW + live * kXBytes);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        const int k0 = kt * kBK;
        mbar_expect_tx(&full[s], bytes);
        tma_load(st, &tg, n0, k0, &full[s]);
        tma_load(st + kW, &tu, n0, k0, &full[s]);
        for (int t = 0; t < live; ++t)
          tma_load(st + 2 * kW + t * kXBytes, &tx, k0, m0 + t * kTok,
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
        unsigned char* stp = smem + s * L::kStageBytes;
        uint32_t wa = smem_u32(stp);  // gate's bf16 tile; up's follows
        if constexpr (flat::kIsCode<WT>) {
          // the consumers convert the stage's code tiles into buffer
          // kt % 2, last read by tile kt - 2's products: the first
          // barrier waits for every consumer warp to have seen them done
          unsigned char* cv = conv + (kt & 1) * 2 * kTileBytes;
          const int nt = 128 * consumers;
          bar_sync(nt);
          codes_to_bf16<WT>(cv, stp, threadIdx.x - 128, nt);
          codes_to_bf16<WT>(cv + kTileBytes, stp + kW, threadIdx.x - 128,
                            nt);
          fence_async_smem();
          bar_sync(nt);
          wa = smem_u32(cv);
        }
        const uint32_t xb = smem_u32(stp + 2 * kW + t0 * kXBytes);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: 16 weight rows of 128 bytes per step, 8-row groups 1024
          // bytes apart; B: 32 bytes into each token row per step, 8-row
          // groups 1024 bytes apart
          const uint64_t db = desc_sw128(xb + kk * 32, 16, 1024);
          wgmma_tn(acc[0], desc_sw128(wa + kk * 2048, 1024, 1024), db);
          wgmma_tn(acc[1],
                   desc_sw128(wa + kTileBytes + kk * 2048, 1024, 1024), db);
        }
        wgmma_commit();
        // keep this tile's products in flight; the previous tile's are
        // done, so its stage goes back to the producer
        wgmma_wait<1>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        if (kt > 0 && threadIdx.x % 128 == 0)
          mbar_arrive(&empty[(kt - 1) % kStages]);
      }
      wgmma_wait<0>();
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
        if (m < M && n < N) {
          float gv = acc[0][i], uv = acc[1][i];
          if constexpr (flat::kIsCode<WT>) {
            gv *= sg[n];
            uv *= su[n];
          }
          out[static_cast<long long>(m) * N + n] =
              f2bf(flat::activate(gv, gelu != 0) * uv);
        }
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

// A (rows x inner) matrix with row stride `ld` elements, read in boxes
// of 64 inner elements x `box_rows` rows, zeros past the edges: bf16 in
// the 128-byte swizzle the wgmma descriptors name, or (`code`) 1-byte
// codes unswizzled, the layout codes_to_bf16 reads.
inline bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                     int inner, int rows, long long ld, int box_rows,
                     bool code = false) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * (code ? 1 : 2)};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return enc(map,
             code ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             code ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = act(x @ Wg) * (x @ Wu); x (M, K; row stride ldx), Wg / Wu
// contiguous row-major (K, N): bf16, or codes with (N,) f32 steps sg / su
// applied to the sums before the activation.
template <typename WT>
int launch_ffn_up_wgmma(const void* x, const void* wgp, const void* wup,
                        const void* sg, const void* su, void* out, int M,
                        int K, int N, long long ldx, int gelu,
                        cudaStream_t st) {
  constexpr bool kCode = flat::kIsCode<WT>;
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mx, mg, mu;
  if (!make_map(enc, &mx, x, K, M, ldx, kTok) ||
      !make_map(enc, &mg, wgp, N, K, N, kBK, kCode) ||
      !make_map(enc, &mu, wup, N, K, N, kBK, kCode))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = FfnSmem<WT>::kBytes;
  auto kernel = ffn_up_wgmma_kernel<WT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + kBN - 1) / kBN, (M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, st>>>(
      mx, mg, mu, static_cast<const float*>(sg),
      static_cast<const float*>(su), static_cast<__nv_bfloat16*>(out), M, K,
      N, gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace repro
