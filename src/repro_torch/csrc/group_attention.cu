// Grouped prefix-shared decode attention (T1, unified max), two stages.
//
// Replaces: src/repro/kernels/group_attention.py::
//   grouped_paged_decode_attention_unified_max (stage 1
//   _group_prefix_kernel, stage 2 _tail_merge_kernel).
//
// Requests whose block tables lead with the same run of shared pages form
// a group; stage 1 reads that run once per (group, kv head) for every
// member's query rows, stage 2 reads each row's private tail and merges.
// Under the unified max (static φ) two partials merge by addition, so the
// stages meet with no rescale.
//
// Bound on H100: device-memory bytes. Decode reads each K/V row once
// (about G = HQ/HK FLOP per byte); grouping cuts the bytes from every
// member's prefix to one prefix per group plus the tails.
//
// Design: the walk of decode_attention.cu's decode_kernel (row 5), split.
// There warp w of a (sequence, kv head) block owns the 32-key chunks
// c = w, w + 4, ... and folds exp(s − φ)·v into its accumulators with
// fmaf in key order; the four warp partials are added at the end. Here:
//   * stage 1, grid (NG, HK, ceil(M·G / 16)): a block of 4 warps takes 16
//     of the group's M·G query rows and walks keys [0, prefix_len) of the
//     group's table. Each warp writes its own unnormalised partial
//     (num, den, max(s − φ)) per row: nothing is merged across warps.
//     The blocks of one (group, kv head) read the same prefix rows; those
//     after the first find them in L2.
//   * stage 2, grid (B, HK): warp w seeds its accumulators with warp w's
//     stage-1 partial of its row (zeros for a solo row) and walks keys
//     [prefix_len, length) of the row's own table; then row 5's merge and
//     finalize.
// Every row thus sees row 5's sequence of floating-point operations, in
// the same order (a chunk that straddles prefix_len is finished by stage
// 2 from the key where stage 1 stopped), so the output is bitwise row
// 5's on the same pool, for any prefix length. The stat is per row, the
// max over the row's prefix and tail keys: row 5's stat bit for bit (the
// JAX kernel reports the group-wide max; the overflow flag is the same).
// Table entries are clamped to the pool (sentinel NP), member rows to the
// batch (sentinel B); padding rows of stage 1 get the empty partial.
//
// Quantized pools (int8 / fp8 e4m3 codes; the quantized=True bodies of
// src/repro/kernels/group_attention.py's _group_prefix_kernel and
// _tail_merge_kernel): both stages are templated on the element type and
// dequantize exactly as row 5's quantized body does (code * step in f32
// before the dot and the P.V product, the K step per key, the V step
// reloaded where a page starts), so the pair stays bitwise row 5 on the
// same quantized pool.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kWarps = 4;   // chunk c belongs to warp c % 4, as in row 5
constexpr int kRows = 16;   // query rows per block (row 5's kMaxG)

// Element offset of key j's head-h row for table row r (decode_attention's
// PagedKV).
struct Pages {
  const int* bt;
  int nb, ps, np;
  long long sp, ss, sh;
  __device__ __forceinline__ int page(int r, int j) const {
    const int p = __ldg(bt + static_cast<long long>(r) * nb + j / ps);
    return p < 0 ? 0 : (p >= np ? np - 1 : p);
  }
  __device__ __forceinline__ long long row(int r, int h, int j) const {
    return page(r, j) * sp + (j % ps) * ss + h * sh;
  }
};

// A quantized pool's (NP, HK) steps (null for bf16 pools).
struct Steps {
  const float* k;
  const float* v;
  int hk;
};

// One warp's share of keys [lo, hi) of table row r, kv head h, against
// query rows q_s[0, nrows): row 5's unified-max chunk walk, expression
// for expression. msc[g] is the running max of s − φ of row g.
template <int D, typename T>
__device__ __forceinline__ void walk(
    float (*q_s)[D], int nrows, const T* __restrict__ k,
    const T* __restrict__ v, const Steps& st, const Pages& addr, int r, int h,
    int lo, int hi, float phi, float (*ebuf)[32], float (&acc)[kRows][D / 32],
    float (&den)[kRows], float (&msc)[kRows]) {
  using E = KVElem<T>;
  constexpr int DL = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = lo / 32;
  for (int c = c0 + (warp - c0 % kWarps + kWarps) % kWarps; c * 32 < hi;
       c += kWarps) {
    const int j = c * 32 + lane;
    const bool valid = j >= lo && j < hi;
    float s[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = k + addr.row(r, h, j);
      float kst = 1.f;
      if constexpr (E::kCodes)
        kst = __ldg(st.k + static_cast<long long>(addr.page(r, j)) * st.hk + h);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += E::kVec) {
        float kv[E::kVec];
        E::load(kr + d0, kst, kv);
#pragma unroll
        for (int g = 0; g < kRows; ++g) {
          if (g < nrows) {
#pragma unroll
            for (int i = 0; i < E::kVec; ++i)
              s[g] = fmaf(q_s[g][d0 + i], kv[i], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g < nrows) {
        const float centered = s[g] - phi;
        const float e = valid ? expf(centered) : 0.f;
        if (valid) msc[g] = fmaxf(msc[g], centered);
        ebuf[g][lane] = e;
      }
    }
    __syncwarp();
    const int jlo = max(0, lo - c * 32), jhi = min(32, hi - c * 32);
    float vst = 1.f;
    int vst_end = 0;                 // the V step holds for keys < vst_end
    for (int jj = jlo; jj < jhi; ++jj) {
      const int key = c * 32 + jj;
      const T* vr = v + addr.row(r, h, key) + lane * DL;
      if constexpr (E::kCodes) {
        if (key >= vst_end) {
          vst = __ldg(st.v + static_cast<long long>(addr.page(r, key)) * st.hk +
                      h);
          vst_end = (key / addr.ps + 1) * addr.ps;
        }
      }
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = E::one(vr + i, vst);
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        if (g < nrows) {
          const float p = ebuf[g][jj];
          den[g] += p;
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }
}

template <int D>
__device__ __forceinline__ void clear(float (&acc)[kRows][D / 32],
                                      float (&den)[kRows],
                                      float (&msc)[kRows]) {
#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    den[g] = 0.f;
    msc[g] = -INFINITY;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[g][i] = 0.f;
  }
}

// Stage 1. num (NG, HK, 4, MG, D), den / stat (NG, HK, 4, MG) f32.
template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
group_prefix_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    Steps st, const int* __restrict__ g_prefix_len,
                    const int* __restrict__ num_members,
                    const int* __restrict__ member_rows,
                    float* __restrict__ num, float* __restrict__ den_out,
                    float* __restrict__ stat, int B, int HK, int G, int M,
                    Pages addr, float scale, float phi) {
  constexpr int DL = D / 32;
  __shared__ float q_s[kRows][D];
  __shared__ float ebuf[kWarps][kRows][32];

  const int grp = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int MG = M * G, HQ = HK * G;
  int nm = num_members[grp];
  nm = nm < 0 ? 0 : (nm > M ? M : nm);
  const int nrows = max(0, min(kRows, nm * G - row0));
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int g = i / D, d = i % D, rr = row0 + g;
    int b = member_rows[grp * M + rr / G];
    b = b < 0 ? 0 : (b >= B ? B - 1 : b);
    q_s[g][d] =
        bf2f(q[(static_cast<long long>(b) * HQ + h * G + rr % G) * D + d]) *
        scale;
  }
  __syncthreads();

  int plen = g_prefix_len[grp];
  plen = plen < 0 ? 0 : min(plen, addr.nb * addr.ps);
  float acc[kRows][DL], den[kRows], msc[kRows];
  clear<D>(acc, den, msc);
  if (nrows > 0)
    walk<D, T>(q_s, nrows, k, v, st, addr, grp, h, 0, plen, phi, ebuf[warp],
               acc, den, msc);

#pragma unroll
  for (int g = 0; g < kRows; ++g) {
    const int rr = row0 + g;
    if (rr < MG) {
      const long long at =
          ((static_cast<long long>(grp) * HK + h) * kWarps + warp) * MG + rr;
      float* o = num + at * D + lane * DL;
#pragma unroll
      for (int i = 0; i < DL; ++i) o[i] = acc[g][i];
      const float m = warp_max(msc[g]);
      if (lane == 0) {
        den_out[at] = den[g];
        stat[at] = m;
      }
    }
  }
}

// Stage 2. out (B, HQ, D) bf16, stat_out (B, HK) f32.
template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
group_tail_kernel(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ k, const T* __restrict__ v, Steps st,
                  const int* __restrict__ lengths, const int* __restrict__ gid,
                  const int* __restrict__ member,
                  const int* __restrict__ prefix_len,
                  const float* __restrict__ num,
                  const float* __restrict__ den_in,
                  const float* __restrict__ stat_in,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ stat_out, int HK, int G, int NG, int MG,
                  Pages addr, float scale, float phi) {
  constexpr int DL = D / 32;
  __shared__ float q_s[kRows][D];
  __shared__ float ebuf[kWarps][kRows][32];
  __shared__ float abuf[kRows][D];
  __shared__ float dbuf[kRows], sbuf;

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int HQ = HK * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    q_s[g][d] = bf2f(q[(static_cast<long long>(b) * HQ + h * G + g) * D + d]) *
                scale;
  }
  __syncthreads();

  const int S = addr.nb * addr.ps;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  int plen = prefix_len[b];
  const int grp = gid[b], mem = member[b];
  const bool seeded = plen > 0 && grp >= 0 && grp < NG && mem >= 0 &&
                      (mem + 1) * G <= MG;
  plen = seeded ? min(plen, S) : 0;

  float acc[kRows][DL], den[kRows], msc[kRows];
  clear<D>(acc, den, msc);
  if (seeded) {
    const long long at0 =
        ((static_cast<long long>(grp) * HK + h) * kWarps + warp) * MG +
        mem * G;
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g < G) {
        const float* src = num + (at0 + g) * D + lane * DL;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] = src[i];
        den[g] = den_in[at0 + g];
        msc[g] = stat_in[at0 + g];
      }
    }
  }
  walk<D, T>(q_s, G, k, v, st, addr, b, h, plen, len, phi, ebuf[warp], acc,
             den, msc);

  // row 5's merge of the warp partials into warp 0, then finalize
  float m = -INFINITY;
#pragma unroll
  for (int g = 0; g < kRows; ++g)
    if (g < G) m = fmaxf(m, msc[g]);
  m = warp_max(m);
  for (int w = 1; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        if (g < G) {
#pragma unroll
          for (int i = 0; i < DL; ++i) abuf[g][lane * DL + i] = acc[g][i];
          if (lane == 0) dbuf[g] = den[g];
        }
      }
      if (lane == 0) sbuf = m;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        if (g < G) {
          den[g] = den[g] + dbuf[g];
#pragma unroll
          for (int i = 0; i < DL; ++i)
            acc[g][i] = acc[g][i] + abuf[g][lane * DL + i];
        }
      }
      m = fmaxf(m, sbuf);
    }
    __syncthreads();
  }

  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      if (g < G) {
        // a sequence with no valid position comes out as zeros
        const float inv = den[g] > 0.f ? 1.f / den[g] : 0.f;
        __nv_bfloat16* o = out +
            (static_cast<long long>(b) * HQ + h * G + g) * D + lane * DL;
#pragma unroll
        for (int i = 0; i < DL; ++i) o[i] = f2bf(acc[g][i] * inv);
      }
    }
    if (lane == 0) stat_out[b * HK + h] = m;
  }
}

Pages pages(const void* bt, int nb, int ps, int np, long long sp,
            long long ss, long long sh) {
  return Pages{static_cast<const int*>(bt), nb, ps, np, sp, ss, sh};
}

}  // namespace

REPRO_ERROR_STRING_FN

#define REPRO_GA_DISPATCH(LAUNCH) \
  switch (D) {                    \
    case 32: LAUNCH(32); break;   \
    case 64: LAUNCH(64); break;   \
    case 128: LAUNCH(128); break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

namespace {

template <typename T>
int prefix(const void* q, const void* k, const void* v, Steps st,
           const void* tables, const void* g_prefix_len,
           const void* num_members, const void* member_rows, void* num,
           void* den, void* stat, int B, int HK, int G, int NG, int LP, int M,
           int PS, int NP, int D, long long sp, long long ss, long long sh,
           float scale, float phi, void* stream) {
  if (NG < 1 || M < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(NG, HK, (M * G + kRows - 1) / kRows);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Pages addr = pages(tables, LP, PS, NP, sp, ss, sh);
#define REPRO_GA_PREFIX(DD)                                                  \
  group_prefix_kernel<DD, T><<<grid, kWarps * 32, 0, cs>>>(                  \
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),        \
      static_cast<const T*>(v), st, static_cast<const int*>(g_prefix_len),   \
      static_cast<const int*>(num_members),                                  \
      static_cast<const int*>(member_rows), static_cast<float*>(num),        \
      static_cast<float*>(den), static_cast<float*>(stat), B, HK, G, M,      \
      addr, scale, phi)
  REPRO_GA_DISPATCH(REPRO_GA_PREFIX)
#undef REPRO_GA_PREFIX
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tail(const void* q, const void* k, const void* v, Steps st,
         const void* bt, const void* lengths, const void* gid,
         const void* member, const void* prefix_len, const void* num,
         const void* den, const void* stat, void* out, void* stat_out, int B,
         int HK, int G, int NB, int PS, int NP, int NG, int MG, int D,
         long long sp, long long ss, long long sh, float scale, float phi,
         void* stream) {
  if (G < 1 || G > kRows) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B, HK);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Pages addr = pages(bt, NB, PS, NP, sp, ss, sh);
#define REPRO_GA_TAIL(DD)                                                    \
  group_tail_kernel<DD, T><<<grid, kWarps * 32, 0, cs>>>(                    \
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),        \
      static_cast<const T*>(v), st, static_cast<const int*>(lengths),        \
      static_cast<const int*>(gid), static_cast<const int*>(member),         \
      static_cast<const int*>(prefix_len), static_cast<const float*>(num),   \
      static_cast<const float*>(den), static_cast<const float*>(stat),       \
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(stat_out), HK, G, \
      NG, MG, addr, scale, phi)
  REPRO_GA_DISPATCH(REPRO_GA_TAIL)
#undef REPRO_GA_TAIL
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stage 1. q (B, HQ, D) contiguous; pools (NP, PS, HK, D) with element
// (p, r, h, d) at p*sp + r*ss + h*sh + d; tables (NG, LP), g_prefix_len /
// num_members (NG,), member_rows (NG, M) int32; outputs as the kernel's.
REPRO_EXPORT int group_prefix_bf16(
    const void* q, const void* k, const void* v, const void* tables,
    const void* g_prefix_len, const void* num_members,
    const void* member_rows, void* num, void* den, void* stat, int B,
    int HK, int G, int NG, int LP, int M, int PS, int NP, int D,
    long long sp, long long ss, long long sh, float scale, float phi,
    void* stream) {
  return prefix<__nv_bfloat16>(q, k, v, Steps{nullptr, nullptr, HK}, tables,
                               g_prefix_len, num_members, member_rows, num,
                               den, stat, B, HK, G, NG, LP, M, PS, NP, D, sp,
                               ss, sh, scale, phi, stream);
}

// Stage 2. bt (B, NB), lengths / gid / member / prefix_len (B,) int32;
// num / den / stat stage 1's outputs (NG groups of MG rows); out (B, HQ,
// D) bf16, stat_out (B, HK) f32.
REPRO_EXPORT int group_tail_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, const void* gid, const void* member,
    const void* prefix_len, const void* num, const void* den,
    const void* stat, void* out, void* stat_out, int B, int HK, int G,
    int NB, int PS, int NP, int NG, int MG, int D, long long sp,
    long long ss, long long sh, float scale, float phi, void* stream) {
  return tail<__nv_bfloat16>(q, k, v, Steps{nullptr, nullptr, HK}, bt,
                             lengths, gid, member, prefix_len, num, den, stat,
                             out, stat_out, B, HK, G, NB, PS, NP, NG, MG, D,
                             sp, ss, sh, scale, phi, stream);
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous. Otherwise as the bf16 entries.
REPRO_EXPORT int group_prefix_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* tables, const void* g_prefix_len,
    const void* num_members, const void* member_rows, void* num, void* den,
    void* stat, int B, int HK, int G, int NG, int LP, int M, int PS, int NP,
    int D, long long sp, long long ss, long long sh, float scale, float phi,
    int fp8, void* stream) {
  const Steps st{static_cast<const float*>(k_step),
                 static_cast<const float*>(v_step), HK};
  auto run = fp8 ? &prefix<__nv_fp8_e4m3> : &prefix<int8_t>;
  return run(q, k, v, st, tables, g_prefix_len, num_members, member_rows,
             num, den, stat, B, HK, G, NG, LP, M, PS, NP, D, sp, ss, sh,
             scale, phi, stream);
}

REPRO_EXPORT int group_tail_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, const void* gid,
    const void* member, const void* prefix_len, const void* num,
    const void* den, const void* stat, void* out, void* stat_out, int B,
    int HK, int G, int NB, int PS, int NP, int NG, int MG, int D,
    long long sp, long long ss, long long sh, float scale, float phi, int fp8,
    void* stream) {
  const Steps st{static_cast<const float*>(k_step),
                 static_cast<const float*>(v_step), HK};
  auto run = fp8 ? &tail<__nv_fp8_e4m3> : &tail<int8_t>;
  return run(q, k, v, st, bt, lengths, gid, member, prefix_len, num, den,
             stat, out, stat_out, B, HK, G, NB, PS, NP, NG, MG, D, sp, ss, sh,
             scale, phi, stream);
}
