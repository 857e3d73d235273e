// T1 — GQA decode attention over the dense KV cache, in both softmax
// schemes (paper §3).
//
// Replaces: src/repro/kernels/decode_attention.py::
//   decode_attention_unified_max (_decode_kernel) and
//   decode_attention_sync (_decode_kernel_sync).
//
// Bound on H100: device-memory bytes. One new token per sequence reads
// every valid K and V row once (2 * len * HK * D * 2 bytes) for only
// 4 * len * HQ * D FLOPs — about G = HQ/HK FLOP per byte.
//
// Design: grid (B, HK); one block of 4 warps per (sequence, kv head),
// holding that head's G = HQ/HK query rows in shared memory (7 for
// qwen2), so each K/V row is read once for all G rows. Each warp walks
// its own 32-key chunks of the cache (chunk c, c+4, ...):
//   * QK: lane j scores key j of the chunk against all G rows, reading
//     its K row with 16-byte loads straight from the (B, S, HK, D) cache
//     through strides — no transposed copy of the cache.
//   * the exp weights go to shared memory and the lanes switch to the D
//     axis for PV, each lane owning D/32 output columns of every row.
//   * unified-max (T1): weights are exp(s - φ) with a static φ, so warp
//     partials merge by plain addition — no running max, no rescale;
//     the block also reports stat = max(s − φ) over valid positions.
//   * sync (online max): each warp carries (m, den, acc) and rescales
//     per chunk; warps merge by the LSE rule. This is the overflow
//     recompute: given a device flag it returns at entry unless the flag
//     is set, so the recompute decision never leaves the device.
// Positions >= lengths[b] are masked. The grid is small at decode batch
// sizes (B * HK blocks on 132 SMs); split-KV across blocks, where T1's
// merge-by-addition pays off most, is left to a later kernel.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 16;

template <int D, bool UNIFIED>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
              float* __restrict__ stat, const bool* __restrict__ flag, int HK,
              int G, int S, long long sb, long long ss, long long sh,
              float scale, float phi) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  constexpr int DL = D / 32;                    // output columns per lane
  __shared__ float q_s[kMaxG][D];
  __shared__ float ebuf[kWarps][kMaxG][32];
  __shared__ float abuf[kMaxG][D];
  __shared__ float mbuf[kMaxG], dbuf[kMaxG], sbuf;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int HQ = HK * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[g][d] = bf2f(q[(static_cast<long long>(b) * HQ + h * G + g) * D + d]) *
                scale;
  }
  __syncthreads();

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const __nv_bfloat16* kb = k + b * sb + h * sh;
  const __nv_bfloat16* vb = v + b * sb + h * sh;

  float acc[kMaxG][DL], den[kMaxG], m_run[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    den[g] = 0.f;
    m_run[g] = -INFINITY;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.f;
  }
  float msc = -INFINITY;

  for (int c = warp; c * 32 < len; c += kWarps) {
    const int j = c * 32 + lane;
    const bool valid = j < len;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (valid) {
      const __nv_bfloat16* kr = kb + j * ss;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(kr + d0)), kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < 8; ++i) s[g] = fmaf(q_s[g][d0 + i], kv[i], s[g]);
          }
        }
      }
    }
    float rescale[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float e;
        if (UNIFIED) {
          const float centered = s[g] - phi;
          e = valid ? expf(centered) : 0.f;
          if (valid) msc = fmaxf(msc, centered);
          rescale[g] = 1.f;
        } else {
          // the chunk's first key is always valid, so m_new is finite
          const float m_new = fmaxf(m_run[g], warp_max(valid ? s[g] : -INFINITY));
          rescale[g] = expf(m_run[g] - m_new);
          m_run[g] = m_new;
          e = valid ? expf(s[g] - m_new) : 0.f;
        }
        ebuf[warp][g][lane] = e;
      }
    }
    __syncwarp();
    const int nvalid = min(32, len - c * 32);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G && !UNIFIED) {
        den[g] *= rescale[g];
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] *= rescale[g];
      }
    }
    for (int jj = 0; jj < nvalid; ++jj) {
      const __nv_bfloat16* vr = vb + (c * 32 + jj) * ss + lane * DL;
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = bf2f(vr[i]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = ebuf[warp][g][jj];
          den[g] += p;
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  // merge warp partials into warp 0 (register arrays are indexed only
  // by unrolled loop counters, so they stay in registers)
  if (UNIFIED) msc = warp_max(msc);
  for (int w = 1; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
#pragma unroll
          for (int i = 0; i < DL; ++i) abuf[g][lane * DL + i] = acc[g][i];
          if (lane == 0) {
            mbuf[g] = m_run[g];
            dbuf[g] = den[g];
          }
        }
      }
      if (lane == 0) sbuf = msc;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float r0 = 1.f, r1 = 1.f;
          if (!UNIFIED) {
            const float m = fmaxf(m_run[g], mbuf[g]);
            r0 = m == -INFINITY ? 0.f : expf(m_run[g] - m);
            r1 = m == -INFINITY ? 0.f : expf(mbuf[g] - m);
            m_run[g] = m;
          }
          den[g] = den[g] * r0 + dbuf[g] * r1;
#pragma unroll
          for (int i = 0; i < DL; ++i)
            acc[g][i] = acc[g][i] * r0 + abuf[g][lane * DL + i] * r1;
        }
      }
      msc = fmaxf(msc, sbuf);
    }
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        // a sequence with no valid position comes out as zeros
        const float inv = den[g] > 0.f ? 1.f / den[g] : 0.f;
        __nv_bfloat16* o = out +
            (static_cast<long long>(b) * HQ + h * G + g) * D + lane * DL;
#pragma unroll
        for (int i = 0; i < DL; ++i) o[i] = f2bf(acc[g][i] * inv);
      }
    }
    if (UNIFIED && lane == 0) stat[b * HK + h] = msc;
  }
}

template <bool UNIFIED>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* stat, const void* flag, int B, int HK, int G,
           int S, int D, long long sb, long long ss, long long sh,
           float scale, float phi, cudaStream_t st) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B, HK);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* sp = static_cast<float*>(stat);
  const auto* fp = static_cast<const bool*>(flag);
  switch (D) {
    case 32:
      decode_kernel<32, UNIFIED><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, lp, op, sp, fp, HK, G, S, sb, ss, sh, scale, phi);
      break;
    case 64:
      decode_kernel<64, UNIFIED><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, lp, op, sp, fp, HK, G, S, sb, ss, sh, scale, phi);
      break;
    case 128:
      decode_kernel<128, UNIFIED><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, lp, op, sp, fp, HK, G, S, sb, ss, sh, scale, phi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, HQ, D) contiguous; k/v element (b, s, h, d) at b*sb + s*ss + h*sh + d
// (any cache layout whose head_dim is contiguous); lengths (B,) int32;
// out (B, HQ, D) contiguous; stat (B, HK) f32 = max over valid s of (s − φ).
REPRO_EXPORT int decode_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* stat, int B, int HK, int G, int S, int D, long long sb,
    long long ss, long long sh, float scale, float phi, void* stream) {
  return launch<true>(q, k, v, lengths, out, stat, nullptr, B, HK, G, S, D,
                      sb, ss, sh, scale, phi,
                      static_cast<cudaStream_t>(stream));
}

// Online-max scheme. With a non-null device `flag` (one bool) the kernel
// returns at entry unless *flag is true — the overflow recompute.
REPRO_EXPORT int decode_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, const void* flag, int B, int HK, int G, int S, int D,
    long long sb, long long ss, long long sh, float scale, void* stream) {
  return launch<false>(q, k, v, lengths, out, nullptr, flag, B, HK, G, S, D,
                       sb, ss, sh, scale, 0.f,
                       static_cast<cudaStream_t>(stream));
}
