// Causal / sliding-window flash attention for the prefill phase, in both
// softmax schemes (paper §3 applied to prefill).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill
//   (_prefill_kernel_async for unified_max=True, _prefill_kernel_sync).
//
// Bound on H100: at the main path's prompt lengths (64..512 tokens,
// head_dim 64) the causal work is 4 * Sq * Sk / 2 * D FLOPs per head
// against (Sq + 2 Sk) * D * 2 bytes — tens of FLOP per byte, so the
// device-memory bytes bound it on paper; this first kernel computes on
// the CUDA cores in f32 and is in practice limited by its shared-memory
// FMA loop (tensor-core wgmma tiles are a later PR's work).
//
// Design: grid (ceil(Sq / 32), HQ, B); one block of 128 threads per
// (32-query tile, query head), with kv_head = h / G (GQA by index, no
// repeated KV). The block walks 32-key tiles only up to its causal /
// window limit. Q, K, V tiles are staged in shared memory as f32; each
// thread scores 8 keys of one query row, and the row's 4 threads share
// row statistics through quad shuffles.
//   * unified-max (T1): weights exp(s − φ), no running max, no rescale;
//     each block writes the max of (s − φ) over its tile into a
//     (B, HQ, n_q_tiles) buffer, and the wrapper takes one amax over the
//     tiles, so `stat` is the true per-(b, h) max over every query row.
//   * sync: the online-max FlashAttention-2 update, masked logits at
//     -1e30 as in the reference; given a device flag it returns at entry
//     unless the flag is set (the overflow recompute).
// Ragged edges (Sq or Sk not a tile multiple) are masked in the kernel;
// rows with no valid key come out as zeros.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr float kNegBig = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D, bool UNIFIED>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, float* __restrict__ stat_part,
               const bool* __restrict__ flag, int Sq, int Sk, int HQ, int G,
               long long qsb, long long qss, long long qsh, long long ksb,
               long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, int causal, int window, float scale,
               float phi) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  extern __shared__ float sm[];
  float* q_s = sm;                          // [kBQ][D + 1]
  float* k_s = q_s + kBQ * (D + 1);         // [kBK][D + 1]
  float* v_s = k_s + kBK * (D + 1);         // [kBK][D]
  float* p_s = v_s + kBK * D;               // [kBQ][kBK + 1]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = qt * kBQ;
  const int r = threadIdx.x / 4, cg = threadIdx.x % 4;
  const int delta = Sk - Sq;       // query i sits at key position i + delta

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    q_s[rr * (D + 1) + d] =
        qi < Sq ? bf2f(q[b * qsb + qi * qss + h * qsh + d]) * scale : 0.f;
  }

  // key range this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int hi = Sk;
  if (causal) hi = min(Sk, q_last + delta + 1);
  int lo = 0;
  if (window) lo = max(0, q0 + delta - window + 1);

  constexpr int DT = D / 4;        // output columns per thread: cg + 4*j
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;
  float den = 0.f;                 // this thread's share of the row sum
  float m_run = kNegBig;           // sync: running row max
  float msc = -INFINITY;           // unified: max centered logit
  const int qi = q0 + r;
  const int qpos = qi + delta;

  for (int kv0 = (lo / kBK) * kBK; kv0 < hi; kv0 += kBK) {
    __syncthreads();               // previous tile fully consumed
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int key = kv0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = bf2f(k[b * ksb + key * kss + kvh * ksh + d]);
        vv = bf2f(v[b * vsb + key * vss + kvh * vsh + d]);
      }
      k_s[c * (D + 1) + d] = kv;
      v_s[c * D + d] = vv;
    }
    __syncthreads();

    float s[kBK / 4];
    bool ok[kBK / 4];
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int c = cg + 4 * i, key = kv0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d)
        dot = fmaf(q_s[r * (D + 1) + d], k_s[c * (D + 1) + d], dot);
      bool valid = qi < Sq && key < Sk;
      if (causal) valid = valid && qpos >= key;
      if (window) valid = valid && qpos - key < window;
      s[i] = dot;
      ok[i] = valid;
    }

    float rescale = 1.f;
    if (UNIFIED) {
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const float cen = s[i] - phi;
        const float e = ok[i] ? expf(cen) : 0.f;
        if (ok[i]) msc = fmaxf(msc, cen);
        den += e;
        p_s[r * (kBK + 1) + cg + 4 * i] = e;
      }
    } else {
      float mt = kNegBig;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) mt = fmaxf(mt, ok[i] ? s[i] : kNegBig);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      rescale = expf(m_run - m_new);
      m_run = m_new;
      den *= rescale;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const float e = ok[i] ? expf(s[i] - m_new) : 0.f;
        den += e;
        p_s[r * (kBK + 1) + cg + 4 * i] = e;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < DT; ++j) acc[j] *= rescale;
    for (int c = 0; c < kBK; ++c) {
      const float p = p_s[r * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DT; ++j)
        acc[j] = fmaf(p, v_s[c * D + cg + 4 * j], acc[j]);
    }
  }

  den += __shfl_xor_sync(0xffffffffu, den, 1);
  den += __shfl_xor_sync(0xffffffffu, den, 2);
  if (qi < Sq) {
    const float inv = den != 0.f ? 1.f / den : 0.f;
    __nv_bfloat16* o = out + ((static_cast<long long>(b) * Sq + qi) * HQ + h) * D;
#pragma unroll
    for (int j = 0; j < DT; ++j) o[cg + 4 * j] = f2bf(acc[j] * inv);
  }

  if (UNIFIED) {
    __shared__ float wmax[kThreads / 32];
    msc = warp_max(msc);
    if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = msc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = wmax[0];
      for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, wmax[w]);
      stat_part[(static_cast<long long>(b) * HQ + h) * gridDim.x + qt] = m;
    }
  }
}

template <int D, bool UNIFIED>
int launch_d(dim3 grid, const void* q, const void* k, const void* v,
             void* out, void* stat_part, const void* flag, int Sq, int Sk,
             int HQ, int G, const long long* qs, const long long* ks,
             const long long* vs, int causal, int window, float scale,
             float phi, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(prefill_kernel<D, UNIFIED>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  prefill_kernel<D, UNIFIED><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(stat_part), static_cast<const bool*>(flag), Sq, Sk,
      HQ, G, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      causal, window, scale, phi);
  return static_cast<int>(cudaGetLastError());
}

template <bool UNIFIED>
int launch(const void* q, const void* k, const void* v, void* out,
           void* stat_part, const void* flag, int B, int Sq, int Sk, int HQ,
           int HK, int D, const long long* qs, const long long* ks,
           const long long* vs, int causal, int window, float scale,
           float phi, cudaStream_t st) {
  if (HK < 1 || HQ % HK) return static_cast<int>(cudaErrorInvalidValue);
  const int G = HQ / HK;
  dim3 grid((Sq + kBQ - 1) / kBQ, HQ, B);
  switch (D) {
    case 32:
      return launch_d<32, UNIFIED>(grid, q, k, v, out, stat_part, flag, Sq,
                                   Sk, HQ, G, qs, ks, vs, causal, window,
                                   scale, phi, st);
    case 64:
      return launch_d<64, UNIFIED>(grid, q, k, v, out, stat_part, flag, Sq,
                                   Sk, HQ, G, qs, ks, vs, causal, window,
                                   scale, phi, st);
    case 128:
      return launch_d<128, UNIFIED>(grid, q, k, v, out, stat_part, flag, Sq,
                                    Sk, HQ, G, qs, ks, vs, causal, window,
                                    scale, phi, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, Sq, HQ, D), k/v (B, Sk, HK, D) through element strides
// (batch, seq, head; head_dim contiguous); out (B, Sq, HQ, D) contiguous;
// stat_part (B, HQ, ceil(Sq/32)) f32 per-tile max of (s − φ).
REPRO_EXPORT int flash_prefill_unified_max_bf16(
    const void* q, const void* k, const void* v, void* out, void* stat_part,
    int B, int Sq, int Sk, int HQ, int HK, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int window, float scale, float phi, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  return launch<true>(q, k, v, out, stat_part, nullptr, B, Sq, Sk, HQ, HK,
                      D, qs, ks, vs, causal, window, scale, phi,
                      static_cast<cudaStream_t>(stream));
}

// Online-max scheme; with a non-null device `flag` (one bool) the kernel
// returns at entry unless *flag is true — the overflow recompute.
REPRO_EXPORT int flash_prefill_sync_bf16(
    const void* q, const void* k, const void* v, void* out, const void* flag,
    int B, int Sq, int Sk, int HQ, int HK, int D, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh},
                  vs[3] = {vsb, vss, vsh};
  return launch<false>(q, k, v, out, nullptr, flag, B, Sq, Sk, HQ, HK, D,
                       qs, ks, vs, causal, window, scale, 0.f,
                       static_cast<cudaStream_t>(stream));
}
