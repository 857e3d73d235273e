// Shared helpers for the port's Hopper kernels (built for sm_90a).
//
// Every kernel library exposes a plain C interface: pointers and the
// stream arrive as void*, every entry returns cudaGetLastError() right
// after its launch, and repro_error_string() turns that code into text
// for the Python wrapper's exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ __nv_bfloat16 f2bf(float v) {
  return __float2bfloat16(v);
}

// Unpack 8 bf16 values held in one 16-byte vector into floats.
__device__ __forceinline__ void unpack8(const uint4& u, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Quantized weights (models/wquant.py) arrive as 1-byte codes: int8
// (|code| <= 127) or fp8 e4m3 (|code| <= 448). Both become floats, and
// bf16 values, exactly: int8 fits bf16's 8-bit significand, and e4m3's
// 3 mantissa bits and its 2^-9 .. 448 range fit bf16's. encode() never
// writes -128 or the e4m3 NaN, so neither is handled here.
template <typename CT>
__device__ __forceinline__ float code_to_float(unsigned char b);

template <>
__device__ __forceinline__ float code_to_float<int8_t>(unsigned char b) {
  return static_cast<float>(static_cast<signed char>(b));
}

template <>
__device__ __forceinline__ float code_to_float<__nv_fp8_e4m3>(
    unsigned char b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// A code's value as bf16 bits (exact), for the bf16 MMA.
template <typename CT>
__device__ __forceinline__ uint16_t code_bits(unsigned char b) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(code_to_float<CT>(b)));
}

// Unpack the 16 codes held in one 16-byte vector into floats.
template <typename CT>
__device__ __forceinline__ void unpack16(const uint4& u, float* out) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = code_to_float<CT>(b[i]);
}

// Elements of a K/V page pool: bf16 values, or 1-byte codes (int8, fp8
// e4m3) of a quantized pool, whose value is code * step in f32 with one
// step per (page, kv head) (the JAX kernels' codes.astype(f32) * step).
// `load` reads kVec elements with one 16-byte load (8 bf16, 16 codes);
// `one` reads a single element. bf16 ignores the step, so its
// arithmetic is the unquantized kernels' to the bit.
template <typename T>
struct KVElem {
  static constexpr bool kCodes = true;
  static constexpr int kVec = 16;
  __device__ __forceinline__ static void load(const T* p, float step,
                                              float* out) {
    unpack16<T>(__ldg(reinterpret_cast<const uint4*>(p)), out);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] *= step;
  }
  __device__ __forceinline__ static float one(const T* p, float step) {
    return code_to_float<T>(*reinterpret_cast<const unsigned char*>(p)) *
           step;
  }
};

template <>
struct KVElem<__nv_bfloat16> {
  static constexpr bool kCodes = false;
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float,
                                              float* out) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p,
                                              float) {
    return bf2f(*p);
  }
};

// Bring the 128-byte lines of [p, p + bytes) into this SM's L1 cache,
// one line per thread from thread `tid` of `nthreads`: epilogue operands
// whose first use would otherwise wait on device memory.
__device__ __forceinline__ void prefetch_l1(const void* p, int bytes,
                                            int tid, int nthreads) {
  const char* base = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(127));
  const int lines =
      static_cast<int>((reinterpret_cast<const char*>(p) + bytes - base +
                        127) / 128);
  for (int l = tid; l < lines; l += nthreads)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(base + l * 128));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// cp.async copies of 16 bytes (zero-filled when `pred` is false), and
// the bf16 mma.sync tile m16n8k16 with f32 accumulators, shared by the
// GEMM kernels.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix: four 8x8 b16 matrices from shared memory, lane l giving the
// 16-byte row address of row l % 8 of matrix l / 8. Lane l receives, in
// r[i], row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i; with
// .trans, rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* row) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* row) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// The 8 bf16 at p as one 16-byte vector, element by element: those from
// `live` on (columns past N) read as zero. For rows that are not 16-byte
// aligned (a (K, N) weight whose N or leading dimension is not a
// multiple of 8), where a vector load would fault.
__device__ __forceinline__ uint4 ld_cols8(const __nv_bfloat16* p, int live) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint16_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = j < live ? __ldg(h + j) : 0;
  return make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]), pack2(e[4], e[5]),
                    pack2(e[6], e[7]));
}

// True where a (K, N) weight's rows are not all 16-byte aligned: N or the
// leading dimension not a multiple of 8 elements of 2 bytes, or the base
// off 16 bytes. A bf16 weight then takes the tail loads (ld_cols8).
inline bool kn_tail(int N, long long ldw, const void* w) {
  return N % 8 != 0 || ldw % 8 != 0 ||
         reinterpret_cast<uintptr_t>(w) % 16 != 0;
}

// Two floats rounded to bf16 and packed as an MMA operand register (lo
// in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2(__bfloat16_as_ushort(__float2bfloat16_rn(lo)),
               __bfloat16_as_ushort(__float2bfloat16_rn(hi)));
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs
// more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

#define REPRO_ERROR_STRING_FN                                   \
  REPRO_EXPORT const char* repro_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }
