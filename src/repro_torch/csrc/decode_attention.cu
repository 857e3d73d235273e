// T1 — GQA decode attention over the dense KV cache or the block-paged
// pool, in both softmax schemes (paper §3).
//
// Replaces: src/repro/kernels/decode_attention.py::
//   decode_attention_unified_max (_decode_kernel),
//   decode_attention_sync (_decode_kernel_sync),
//   paged_decode_attention_unified_max (_paged_decode_kernel) and
//   paged_decode_attention_sync (_paged_decode_kernel_sync).
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
//
// Dense and paged share one kernel body, templated on how it addresses
// key j of (sequence b, kv head h): DenseKV reads b*sb + j*ss + h*sh;
// PagedKV reads page bt[b, j / PS] (clamped to the pool: unassigned
// table entries hold the sentinel NP) at row j % PS. Both walk the same
// 32-key warp chunks and do the same arithmetic in the same order, so the
// paged kernel is bitwise equal to the dense one on the same KV laid into
// any pages. The TPU kernel's per-page grid steps become a per-key table
// lookup: a page is never read past lengths[b], so a fully masked page
// costs nothing.
//
// Quantized pools (int8 / fp8 e4m3 codes, src/repro/kernels/
// decode_attention.py's quantized=True bodies of _paged_decode_kernel and
// _paged_decode_kernel_sync) run the same body templated on the element
// type: each K and V element becomes code * step[page, kv head] in f32
// before the score dot and the P.V product, as in the JAX kernel. A row
// is 1 byte per element, so one 16-byte load carries 16 codes of a K row;
// the step of a K row is loaded with it (lanes on one page share the
// address), and the P.V loop reloads the V step only where a new page
// starts. Bound: the same bytes argument at half the K/V bytes, plus
// 4 bytes per (page, kv head) of steps.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 16;

// Element offset of key j's head-h row in a (B, S, HK, D) dense cache
// (any strides with a contiguous head_dim).
struct DenseKV {
  long long sb, ss, sh;
  __device__ __forceinline__ long long row(int b, int h, int j) const {
    return b * sb + j * ss + h * sh;
  }
};

// Element offset of key j's head-h row in an (NP, PS, HK, D) page pool
// read through block tables bt (B, NB); page() is the clamped physical
// page, which also indexes a quantized pool's (NP, HK) steps.
struct PagedKV {
  const int* bt;
  int nb, ps, np;
  long long sp, ss, sh;
  __device__ __forceinline__ int page(int b, int j) const {
    const int p = __ldg(bt + static_cast<long long>(b) * nb + j / ps);
    return p < 0 ? 0 : (p >= np ? np - 1 : p);
  }
  __device__ __forceinline__ long long row(int b, int h, int j) const {
    return page(b, j) * sp + (j % ps) * ss + h * sh;
  }
};

template <int D, bool UNIFIED, typename KV, typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ k_step,
              const float* __restrict__ v_step,
              const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
              float* __restrict__ stat, const bool* __restrict__ flag, int HK,
              int G, int S, KV addr, float scale, float phi) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  using E = KVElem<T>;
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
      const T* kr = k + addr.row(b, h, j);
      float kst = 1.f;
      if constexpr (E::kCodes)
        kst = __ldg(k_step + static_cast<long long>(addr.page(b, j)) * HK + h);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += E::kVec) {
        float kv[E::kVec];
        E::load(kr + d0, kst, kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < E::kVec; ++i)
              s[g] = fmaf(q_s[g][d0 + i], kv[i], s[g]);
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
    float vst = 1.f;
    int vst_end = 0;                 // the V step holds for keys < vst_end
    for (int jj = 0; jj < nvalid; ++jj) {
      const int key = c * 32 + jj;
      const T* vr = v + addr.row(b, h, key) + lane * DL;
      if constexpr (E::kCodes) {
        if (key >= vst_end) {
          vst = __ldg(v_step + static_cast<long long>(addr.page(b, key)) * HK +
                      h);
          vst_end = (key / addr.ps + 1) * addr.ps;
        }
      }
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = E::one(vr + i, vst);
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

template <bool UNIFIED, typename KV, typename T = __nv_bfloat16>
int launch(const void* q, const void* k, const void* v, const void* k_step,
           const void* v_step, const void* lengths, void* out, void* stat,
           const void* flag, int B, int HK, int G, int S, int D, KV addr,
           float scale, float phi, cudaStream_t st) {
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B, HK);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* ksp = static_cast<const float*>(k_step);
  const auto* vsp = static_cast<const float*>(v_step);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* sp = static_cast<float*>(stat);
  const auto* fp = static_cast<const bool*>(flag);
  switch (D) {
    case 32:
      decode_kernel<32, UNIFIED, KV, T><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, ksp, vsp, lp, op, sp, fp, HK, G, S, addr, scale, phi);
      break;
    case 64:
      decode_kernel<64, UNIFIED, KV, T><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, ksp, vsp, lp, op, sp, fp, HK, G, S, addr, scale, phi);
      break;
    case 128:
      decode_kernel<128, UNIFIED, KV, T><<<grid, kWarps * 32, 0, st>>>(
          qp, kp, vp, ksp, vsp, lp, op, sp, fp, HK, G, S, addr, scale, phi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The quantized entries' code type: int8 (fp8 == 0) or fp8 e4m3.
template <bool UNIFIED>
int launch_q8(const void* q, const void* k, const void* v, const void* k_step,
              const void* v_step, const void* lengths, void* out, void* stat,
              const void* flag, int B, int HK, int G, int S, int D,
              PagedKV addr, float scale, float phi, int fp8,
              cudaStream_t st) {
  if (fp8)
    return launch<UNIFIED, PagedKV, __nv_fp8_e4m3>(
        q, k, v, k_step, v_step, lengths, out, stat, flag, B, HK, G, S, D,
        addr, scale, phi, st);
  return launch<UNIFIED, PagedKV, int8_t>(q, k, v, k_step, v_step, lengths,
                                          out, stat, flag, B, HK, G, S, D,
                                          addr, scale, phi, st);
}

PagedKV paged(const void* bt, int NB, int PS, int NP, long long sp,
              long long ss, long long sh) {
  return PagedKV{static_cast<const int*>(bt), NB, PS, NP, sp, ss, sh};
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
  return launch<true>(q, k, v, nullptr, nullptr, lengths, out, stat, nullptr,
                      B, HK, G, S, D, DenseKV{sb, ss, sh}, scale, phi,
                      static_cast<cudaStream_t>(stream));
}

// Online-max scheme. With a non-null device `flag` (one bool) the kernel
// returns at entry unless *flag is true — the overflow recompute.
REPRO_EXPORT int decode_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, const void* flag, int B, int HK, int G, int S, int D,
    long long sb, long long ss, long long sh, float scale, void* stream) {
  return launch<false>(q, k, v, nullptr, nullptr, lengths, out, nullptr, flag,
                       B, HK, G, S, D, DenseKV{sb, ss, sh}, scale, 0.f,
                       static_cast<cudaStream_t>(stream));
}

// Paged: k/v pools (NP, PS, HK, D), element (p, r, h, d) at
// p*sp + r*ss + h*sh + d; bt (B, NB) int32 contiguous; lengths (B,) are
// clamped to NB * PS. Outputs as the dense entries.
REPRO_EXPORT int paged_decode_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, void* stat, int B, int HK, int G,
    int NB, int PS, int NP, int D, long long sp, long long ss, long long sh,
    float scale, float phi, void* stream) {
  return launch<true>(q, k, v, nullptr, nullptr, lengths, out, stat, nullptr,
                      B, HK, G, NB * PS, D, paged(bt, NB, PS, NP, sp, ss, sh),
                      scale, phi, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_decode_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, const void* flag, int B, int HK, int G,
    int NB, int PS, int NP, int D, long long sp, long long ss, long long sh,
    float scale, void* stream) {
  return launch<false>(q, k, v, nullptr, nullptr, lengths, out, nullptr, flag,
                       B, HK, G, NB * PS, D,
                       paged(bt, NB, PS, NP, sp, ss, sh), scale, 0.f,
                       static_cast<cudaStream_t>(stream));
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous, one step per (page, kv head). Otherwise as the bf16 entries.
REPRO_EXPORT int paged_decode_attention_unified_max_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    void* stat, int B, int HK, int G, int NB, int PS, int NP, int D,
    long long sp, long long ss, long long sh, float scale, float phi, int fp8,
    void* stream) {
  return launch_q8<true>(q, k, v, k_step, v_step, lengths, out, stat,
                         nullptr, B, HK, G, NB * PS, D,
                         paged(bt, NB, PS, NP, sp, ss, sh), scale, phi, fp8,
                         static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_decode_attention_sync_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    const void* flag, int B, int HK, int G, int NB, int PS, int NP, int D,
    long long sp, long long ss, long long sh, float scale, int fp8,
    void* stream) {
  return launch_q8<false>(q, k, v, k_step, v_step, lengths, out, nullptr,
                          flag, B, HK, G, NB * PS, D,
                          paged(bt, NB, PS, NP, sp, ss, sh), scale, 0.f, fp8,
                          static_cast<cudaStream_t>(stream));
}
