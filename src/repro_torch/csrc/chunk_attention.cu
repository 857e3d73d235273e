// Fused paged chunk-prefill attention: a C-token query chunk attends,
// causally, to its sequence's whole KV read in place from the block pool,
// in both softmax schemes (paper §3 on the chunked-prefill path).
//
// Replaces: src/repro/kernels/chunk_attention.py::
//   paged_chunk_attention_unified_max (_paged_chunk_kernel) and
//   paged_chunk_attention_sync (_paged_chunk_kernel_sync).
//
// Bound on H100: device-memory bytes at the serving path's shapes. Each
// resident K/V row is worth C * G = 448 FLOP per byte for qwen2 (C = 64,
// before the causal half), above the card's ~295 ridge, but the chunk's
// own q and out rows move as many bytes as ~450 K/V positions, so at
// prompts of up to a few thousand tokens the bytes set the least time.
// This first kernel computes on the CUDA cores in f32 and its time
// follows the longest block's walk over the keys, not either bound
// (splitting the keys across blocks and wgmma tiles are later work).
//
// Design: the flash-prefill kernel (flash_prefill.cu) with paged keys.
// Grid (ceil(C / 32), HQ, B); one block of 128 threads per (32-query
// tile, query head), kv_head = h / G. Query row i of the chunk sits at
// absolute position lengths[b] + i and sees keys at positions <= it (the
// chunk's own KV is already in the pool). The block walks 32-key tiles
// only up to its last row's position; each K/V row is fetched through
// the block table (page bt[b, key / PS], clamped to the pool — unassigned
// entries hold the sentinel NP), staged in shared memory as f32.
//   * unified-max (T1): weights exp(s − φ), no running max, no rescale;
//     each block writes the max of (s − φ) over its valid entries into a
//     (B, HQ, n_q_tiles) buffer, and the wrapper takes the amax over tiles
//     and over the G query heads of each kv head: stat (B, HK), as the
//     TPU kernel's max over all C·G rows of a kv head.
//   * sync: the online-max update with masked logits at -1e30, so no
//     partial ever starts from exp(-inf - -inf); given a device flag it
//     returns at entry unless the flag is set (the overflow recompute).
// A row's P·V loop stops at its own causal frontier, so no value row past
// it is ever multiplied, even by a zero weight. Rows with no valid key
// come out as zeros.
//
// Quantized pools (int8 / fp8 e4m3 codes; the quantized=True bodies of
// src/repro/kernels/chunk_attention.py's _paged_chunk_kernel and
// _paged_chunk_kernel_sync) run the same body templated on the element
// type: at the start of each key tile one thread per key loads that key's
// K and V steps (one per page and kv head) into shared memory, and the
// staging loop turns every code into code * step in f32, so the tiles the
// block computes on hold the JAX kernel's dequantized values.
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

template <int D, bool UNIFIED, typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ k_step,
             const float* __restrict__ v_step,
             const int* __restrict__ bt, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, float* __restrict__ stat_part,
             const bool* __restrict__ flag, int C, int HQ, int G, int NB,
             int PS, int NP, long long qsb, long long qss, long long qsh,
             long long sp, long long ss, long long sh, float scale,
             float phi) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  using E = KVElem<T>;
  extern __shared__ float sm[];
  __shared__ float kst_s[kBK], vst_s[kBK];  // the tile's steps (codes only)
  float* q_s = sm;                          // [kBQ][D + 1]
  float* k_s = q_s + kBQ * (D + 1);         // [kBK][D + 1]
  float* v_s = k_s + kBK * (D + 1);         // [kBK][D]
  float* p_s = v_s + kBK * D;               // [kBQ][kBK + 1]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = qt * kBQ;
  const int r = threadIdx.x / 4, cg = threadIdx.x % 4;
  const int len0 = max(lengths[b], 0);     // positions before the chunk
  const int* btb = bt + static_cast<long long>(b) * NB;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    q_s[rr * (D + 1) + d] =
        qi < C ? bf2f(q[b * qsb + qi * qss + h * qsh + d]) * scale : 0.f;
  }

  // keys this tile can see: up to its last row's position, within the
  // table's NB * PS positions
  const int q_last = min(q0 + kBQ, C) - 1;
  const int hi = min(NB * PS, len0 + q_last + 1);

  constexpr int DT = D / 4;        // output columns per thread: cg + 4*j
  float acc[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j] = 0.f;
  float den = 0.f;                 // this thread's share of the row sum
  float m_run = kNegBig;           // sync: running row max
  float msc = -INFINITY;           // unified: max centered logit
  const int qi = q0 + r;
  const int qpos = len0 + qi;

  for (int kv0 = 0; kv0 < hi; kv0 += kBK) {
    __syncthreads();               // previous tile fully consumed
    if constexpr (E::kCodes) {
      const int key = kv0 + threadIdx.x;
      if (threadIdx.x < kBK && key < hi) {
        int page = __ldg(btb + key / PS);
        page = page < 0 ? 0 : (page >= NP ? NP - 1 : page);
        const long long at = static_cast<long long>(page) * (HQ / G) + kvh;
        kst_s[threadIdx.x] = __ldg(k_step + at);
        vst_s[threadIdx.x] = __ldg(v_step + at);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int key = kv0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < hi) {
        int page = __ldg(btb + key / PS);
        page = page < 0 ? 0 : (page >= NP ? NP - 1 : page);
        const long long off = page * sp + (key % PS) * ss + kvh * sh + d;
        float kst = 1.f, vst = 1.f;
        if constexpr (E::kCodes) {
          kst = kst_s[c];
          vst = vst_s[c];
        }
        kv = E::one(k + off, kst);
        vv = E::one(v + off, vst);
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
      s[i] = dot;
      ok[i] = qi < C && key < hi && key <= qpos;
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
    // this row's keys in the tile end at its own position (and at hi)
    const int n_row = qi < C ? min(min(kBK, hi - kv0), qpos - kv0 + 1) : 0;
    for (int c = 0; c < n_row; ++c) {
      const float p = p_s[r * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DT; ++j)
        acc[j] = fmaf(p, v_s[c * D + cg + 4 * j], acc[j]);
    }
  }

  den += __shfl_xor_sync(0xffffffffu, den, 1);
  den += __shfl_xor_sync(0xffffffffu, den, 2);
  if (qi < C) {
    const float inv = den != 0.f ? 1.f / den : 0.f;
    __nv_bfloat16* o = out + ((static_cast<long long>(b) * C + qi) * HQ + h) * D;
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

struct Args {
  const void *q, *k, *v, *k_step, *v_step, *bt, *lengths;
  void *out, *stat_part;
  const void* flag;
  int B, C, HQ, HK, NB, PS, NP;
  long long qsb, qss, qsh, sp, ss, sh;
  float scale, phi;
};

template <int D, bool UNIFIED, typename T>
int launch_d(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(chunk_kernel<D, UNIFIED, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.C + kBQ - 1) / kBQ, a.HQ, a.B);
  chunk_kernel<D, UNIFIED, T><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.k_step),
      static_cast<const float*>(a.v_step), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.stat_part), static_cast<const bool*>(a.flag),
      a.C, a.HQ, a.HQ / a.HK, a.NB, a.PS, a.NP, a.qsb, a.qss, a.qsh, a.sp,
      a.ss, a.sh, a.scale, a.phi);
  return static_cast<int>(cudaGetLastError());
}

template <bool UNIFIED, typename T = __nv_bfloat16>
int launch(const Args& a, int D, cudaStream_t st) {
  if (a.HK < 1 || a.HQ % a.HK || a.C < 1 || a.NB < 1 || a.PS < 1 ||
      a.NP < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch_d<32, UNIFIED, T>(a, st);
    case 64:
      return launch_d<64, UNIFIED, T>(a, st);
    case 128:
      return launch_d<128, UNIFIED, T>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The quantized entries' code type: int8 (fp8 == 0) or fp8 e4m3.
template <bool UNIFIED>
int launch_q8(const Args& a, int D, int fp8, cudaStream_t st) {
  return fp8 ? launch<UNIFIED, __nv_fp8_e4m3>(a, D, st)
             : launch<UNIFIED, int8_t>(a, D, st);
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, C, HQ, D) through element strides (batch, chunk, head; head_dim
// contiguous); k/v pools (NP, PS, HK, D), element (p, r, h, d) at
// p*sp + r*ss + h*sh + d; bt (B, NB) int32 contiguous; lengths (B,) int32,
// the positions before the chunk; out (B, C, HQ, D) contiguous;
// stat_part (B, HQ, ceil(C/32)) f32 per-tile max of (s − φ).
REPRO_EXPORT int paged_chunk_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, void* stat_part, int B, int C, int HQ,
    int HK, int NB, int PS, int NP, int D, long long qsb, long long qss,
    long long qsh, long long sp, long long ss, long long sh, float scale,
    float phi, void* stream) {
  const Args a{q,   k,   v,   nullptr, nullptr, bt, lengths, out,
               stat_part, nullptr, B, C, HQ, HK, NB, PS, NP, qsb, qss, qsh,
               sp, ss, sh, scale, phi};
  return launch<true>(a, D, static_cast<cudaStream_t>(stream));
}

// Online-max scheme; with a non-null device `flag` (one bool) the kernel
// returns at entry unless *flag is true — the overflow recompute.
REPRO_EXPORT int paged_chunk_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, const void* flag, int B, int C, int HQ,
    int HK, int NB, int PS, int NP, int D, long long qsb, long long qss,
    long long qsh, long long sp, long long ss, long long sh, float scale,
    void* stream) {
  const Args a{q,  k,  v,  nullptr, nullptr, bt, lengths, out, nullptr, flag,
               B,  C,  HQ, HK,      NB,      PS, NP,      qsb, qss,     qsh,
               sp, ss, sh, scale,   0.f};
  return launch<false>(a, D, static_cast<cudaStream_t>(stream));
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous, one step per (page, kv head). Otherwise as the bf16 entries.
REPRO_EXPORT int paged_chunk_attention_unified_max_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    void* stat_part, int B, int C, int HQ, int HK, int NB, int PS, int NP,
    int D, long long qsb, long long qss, long long qsh, long long sp,
    long long ss, long long sh, float scale, float phi, int fp8,
    void* stream) {
  const Args a{q,   k,   v,   k_step, v_step, bt, lengths, out,
               stat_part, nullptr, B, C, HQ, HK, NB, PS, NP, qsb, qss, qsh,
               sp, ss, sh, scale, phi};
  return launch_q8<true>(a, D, fp8, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_chunk_attention_sync_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    const void* flag, int B, int C, int HQ, int HK, int NB, int PS, int NP,
    int D, long long qsb, long long qss, long long qsh, long long sp,
    long long ss, long long sh, float scale, int fp8, void* stream) {
  const Args a{q,  k,  v,  k_step, v_step, bt, lengths, out, nullptr, flag,
               B,  C,  HQ, HK,     NB,     PS, NP,      qsb, qss,     qsh,
               sp, ss, sh, scale,  0.f};
  return launch_q8<false>(a, D, fp8, static_cast<cudaStream_t>(stream));
}
