// Shared helpers for the port's Hopper kernels (built for sm_90a).
//
// Every kernel library exposes a plain C interface: pointers and the
// stream arrive as void*, every entry returns cudaGetLastError() right
// after its launch, and repro_error_string() turns that code into text
// for the Python wrapper's exception.
#pragma once

#include <cuda_bf16.h>
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
