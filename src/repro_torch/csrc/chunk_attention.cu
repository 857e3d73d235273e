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
// The keys are split across blocks, so the longest block walks at most 4
// tiles, each waiting in turn on its copy, its MMA chain and its softmax;
// that walk, the second launch, the partials' round trip through device
// memory (L2-resident at these sizes) and the pipeline's fill set the
// time, some 40-50x the bound at the smoke's shapes.
//
// Design, two launches counted as one call of the wrapper:
//   1. split_kernel, grid (ceil(C / 64), HQ, B * NSPLIT): one block of 128
//      threads (4 warps of 16 rows) per (64-query tile, query head, split),
//      kv_head = h / G. Split s covers the absolute key positions [s L,
//      (s + 1) L) with L = kSplit = 256 keys (4 tiles), a compile-time
//      constant; NSPLIT = ceil(NB * PS / L) follows the block table's
//      width, so the host reads nothing of `lengths`. The block walks its
//      split's 64-key tiles up to its tile's causal limit with the shared
//      tile body of attn_tile.cuh (bf16 mma.sync into f32, cp.async ring),
//      each K/V row fetched through the block table (page bt[b, key /
//      PS], clamped to the pool: unassigned entries hold the sentinel NP).
//      Query row i sits at absolute position lengths[b] + i and sees keys
//      at positions <= it. Keys at or past the sequence's last valid
//      position, lengths[b] + chunk_lens[b] (C without chunk_lens), are
//      zero-filled by the copy, never read: in serving the pool rows
//      past a ragged chunk are stale or never written, and a zero weight
//      times a NaN there would still be NaN in an MMA. A block whose
//      split starts at or past its tile's limit only marks its stat empty.
//      It writes per (b, split, row, head) f32 partials to scratch the
//      wrapper allocates: acc[D] and den, and for sync the running max m.
//   2. combine_kernel, grid (ceil(C / R), HQ, B) with R = 256 / D rows per
//      block: each row reduces only its own splits, s = 0 .. its last key
//      / L, in ascending order. Unified-max partials add (T1's point: the
//      JAX package's merge_unified); sync partials merge by the LSE rule
//      (merge_lse), guarded so that a split with no valid key adds
//      nothing (the reference's merge_lse makes NaN there). Then out =
//      acc / den in bf16 (a row with no valid key: zeros), and, unified,
//      stat (B, HK): the max of s − φ over the tiles, the splits and the
//      G query heads of each kv head, as the TPU kernel's max over all
//      C·G rows of a kv head (no reduction is left to the host).
// A row's bits depend only on its q row, its absolute position and its
// keys: the split boundaries are absolute and fixed, the combine order is
// fixed and reads no split past the row's own last key, and a tile key
// past a row's position adds an exact zero. So they do not depend on the
// batch, on B, on the chunk's other rows or on NSPLIT.
//   * unified-max (T1): weights exp(s − φ), no running max, no rescale.
//   * sync: the online-max update with masked logits at -1e30; given a
//     device flag both launches return at entry unless it is set (the
//     overflow recompute).
//
// Quantized pools (int8 / fp8 e4m3 codes; the quantized=True bodies of
// src/repro/kernels/chunk_attention.py's _paged_chunk_kernel and
// _paged_chunk_kernel_sync) run the same body templated on the element
// type: the ring carries codes, each tile is converted once into exact
// bf16 values beside its K and V steps (one per page and kv head), the K
// step scales each key's f32 score and the V step P's column before P is
// rounded to bf16. The JAX bodies dequantize to f32 first; the two differ
// by rounding.
#include "attn_tile.cuh"

using namespace repro;

namespace {

using attn::kBK;
using attn::kBQ;
using attn::kNegBig;
using attn::kThreads;

constexpr int kSplit = 256;   // keys per split (4 tiles); fixed: see above

struct Args {
  const void *q, *k, *v, *k_step, *v_step, *bt, *lengths, *chunk_lens;
  void *out, *stat, *acc_part, *den_part, *aux_part;
  const void* flag;
  int B, C, HQ, HK, NB, PS, NP, NSPLIT;
  long long qsb, qss, qsh, sp, ss, sh;
  float scale, phi;
};

// The sequence's key range: positions before the chunk, and one past its
// last valid position within the table (keys from there on are not read).
struct Extent {
  int len0, kend;
  __device__ __forceinline__ Extent(const int* lengths,
                                    const int* chunk_lens, int b, int C,
                                    int NB, int PS) {
    len0 = max(lengths[b], 0);
    const int cl = chunk_lens ? min(max(chunk_lens[b], 0), C) : C;
    kend = min(NB * PS, len0 + cl);
  }
};

// aux: unified, the block's max of s − φ at ((b HQ + h) nqt + qt) NSPLIT
// + s; sync, the running max m of each partial row.
template <int D, bool UNIFIED, typename T>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ k_step,
             const float* __restrict__ v_step, const int* __restrict__ bt,
             const int* __restrict__ lengths,
             const int* __restrict__ chunk_lens, float* __restrict__ acc_part,
             float* __restrict__ den_part, float* __restrict__ aux_part,
             const bool* __restrict__ flag, int C, int HQ, int G, int NB,
             int PS, int NP, int NSPLIT, long long qsb, long long qss,
             long long qsh, long long sp, long long ss, long long sh,
             float scale, float phi) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / NSPLIT, split = blockIdx.z % NSPLIT;
  const int kvh = h / G;
  const int q0 = qt * kBQ;
  const Extent ext(lengths, chunk_lens, b, C, NB, PS);
  // keys this tile can see: up to its last row's position, before kend
  const int q_last = min(q0 + kBQ, C) - 1;
  const int hi = min(ext.kend, ext.len0 + q_last + 1);
  const int s_lo = split * kSplit;
  const long long stat_at =
      ((static_cast<long long>(b) * HQ + h) * gridDim.x + qt) * NSPLIT +
      split;
  if (s_lo >= hi) {                 // nothing of this split is visible
    if (UNIFIED && threadIdx.x == 0) aux_part[stat_at] = -INFINITY;
    return;
  }

  attn::load_q<D>(smem, q + b * qsb + h * qsh, qss, q0, C);
  const attn::PagedRows rows{bt + static_cast<long long>(b) * NB,
                             PS, NP, HQ / G, kvh, sp, ss, sh,
                             k_step, v_step};
  const int len0 = ext.len0;
  auto valid = [&](int r, int key) {
    const int qi = q0 + r;
    return qi < C && key < hi && key <= len0 + qi;
  };
  attn::Acc<D> a;
  a.init();
  attn::walk<D, UNIFIED, T>(smem, k, v, rows, s_lo,
                            min(s_lo + kSplit, hi), scale, phi, valid, a);
  a.reduce_den();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + 8 * i;
    if (qi >= C) continue;
    const long long row =
        ((static_cast<long long>(b) * NSPLIT + split) * C + qi) * HQ + h;
    float* acc = acc_part + row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(acc + 8 * j) =
          make_float2(a.o[j][2 * i], a.o[j][2 * i + 1]);
    if (t == 0) {
      den_part[row] = a.den[i];
      if (!UNIFIED) aux_part[row] = a.m[i];
    }
  }
  if (UNIFIED) {
    const float m = attn::block_max(a.msc_max());
    if (threadIdx.x == 0) aux_part[stat_at] = m;
  }
}

template <int D, bool UNIFIED>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ acc_part,
               const float* __restrict__ den_part,
               const float* __restrict__ aux_part,
               const int* __restrict__ lengths,
               const int* __restrict__ chunk_lens,
               __nv_bfloat16* __restrict__ out, float* __restrict__ stat,
               const bool* __restrict__ flag, int C, int HQ, int G, int NB,
               int PS, int NSPLIT) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  constexpr int kLanes = D / 2;              // threads per row, 2 columns each
  constexpr int kRows = kThreads / kLanes;   // rows per block
  const int h = blockIdx.y, b = blockIdx.z;
  if (UNIFIED && blockIdx.x == 0 && h % G == 0) {
    // stat[b, kv head]: the max over its G query heads, tiles and splits
    // (the G heads' entries are contiguous)
    const int n = G * ((C + kBQ - 1) / kBQ) * NSPLIT;
    const float* part =
        aux_part + (static_cast<long long>(b) * HQ + h) * (n / G);
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, part[i]);
    m = attn::block_max(m);
    if (threadIdx.x == 0) stat[b * (HQ / G) + h / G] = m;
  }
  const int qi = blockIdx.x * kRows + threadIdx.x / kLanes;
  if (qi >= C) return;
  const int dp = (threadIdx.x % kLanes) * 2;
  const Extent ext(lengths, chunk_lens, b, C, NB, PS);
  const int last = min(ext.len0 + qi, ext.kend - 1);   // the row's last key
  const int n = last >= 0 ? last / kSplit + 1 : 0;
  const long long split_rows = static_cast<long long>(C) * HQ;
  const long long row0 =
      (static_cast<long long>(b) * NSPLIT * C + qi) * HQ + h;

  float2 acc = make_float2(0.f, 0.f);
  float den = 0.f;
  if (UNIFIED) {
    for (int s = 0; s < n; ++s) {
      const long long row = row0 + s * split_rows;
      const float2 a = *reinterpret_cast<const float2*>(acc_part + row * D +
                                                        dp);
      acc.x += a.x;
      acc.y += a.y;
      den += den_part[row];
    }
  } else {
    float m = kNegBig;
    bool any = false;
    for (int s = 0; s < n; ++s) {
      const long long row = row0 + s * split_rows;
      const float ms = aux_part[row];
      if (ms <= kNegBig) continue;       // saw no valid key: adds nothing
      const float2 a = *reinterpret_cast<const float2*>(acc_part + row * D +
                                                        dp);
      const float ds = den_part[row];
      if (!any) {
        acc = a;
        den = ds;
        m = ms;
        any = true;
        continue;
      }
      const float mn = fmaxf(m, ms);
      const float r1 = exp2f((m - mn) * attn::kLog2e);
      const float r2 = exp2f((ms - mn) * attn::kLog2e);
      acc.x = acc.x * r1 + a.x * r2;
      acc.y = acc.y * r1 + a.y * r2;
      den = den * r1 + ds * r2;
      m = mn;
    }
  }
  const float inv = den != 0.f ? 1.f / den : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(
      out + ((static_cast<long long>(b) * C + qi) * HQ + h) * D + dp) =
      __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
}

template <int D, bool UNIFIED, typename T>
int launch_d(const Args& a, cudaStream_t st) {
  constexpr size_t smem = attn::Smem<D, T>::kBytes;
  cudaError_t e = allow_smem(split_kernel<D, UNIFIED, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nqt = (a.C + kBQ - 1) / kBQ;
  split_kernel<D, UNIFIED, T><<<dim3(nqt, a.HQ, a.B * a.NSPLIT), kThreads,
                                smem, st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.k_step),
      static_cast<const float*>(a.v_step), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lengths),
      static_cast<const int*>(a.chunk_lens),
      static_cast<float*>(a.acc_part), static_cast<float*>(a.den_part),
      static_cast<float*>(a.aux_part), static_cast<const bool*>(a.flag), a.C,
      a.HQ, a.HQ / a.HK, a.NB, a.PS, a.NP, a.NSPLIT, a.qsb, a.qss, a.qsh,
      a.sp, a.ss, a.sh, a.scale, a.phi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kRows = kThreads / (D / 2);
  combine_kernel<D, UNIFIED><<<dim3((a.C + kRows - 1) / kRows, a.HQ, a.B),
                               kThreads, 0, st>>>(
      static_cast<const float*>(a.acc_part),
      static_cast<const float*>(a.den_part),
      static_cast<const float*>(a.aux_part),
      static_cast<const int*>(a.lengths),
      static_cast<const int*>(a.chunk_lens), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.stat), static_cast<const bool*>(a.flag), a.C,
      a.HQ, a.HQ / a.HK, a.NB, a.PS, a.NSPLIT);
  return static_cast<int>(cudaGetLastError());
}

template <bool UNIFIED, typename T = __nv_bfloat16>
int launch(const Args& a, int D, cudaStream_t st) {
  const long long keys = static_cast<long long>(a.NB) * a.PS;
  if (a.HK < 1 || a.HQ % a.HK || a.C < 1 || a.NB < 1 || a.PS < 1 ||
      a.NP < 1 || a.NSPLIT < 1 ||
      static_cast<long long>(a.NSPLIT) * kSplit < keys ||
      static_cast<long long>(a.NSPLIT - 1) * kSplit >= keys ||
      static_cast<long long>(a.B) * a.NSPLIT > 65535)
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
// contiguous; 16-byte aligned rows); k/v pools (NP, PS, HK, D), element
// (p, r, h, d) at p*sp + r*ss + h*sh + d; bt (B, NB) int32 contiguous;
// lengths (B,) int32, the positions before the chunk; chunk_lens (B,)
// int32 or null (every row valid); out (B, C, HQ, D) contiguous;
// stat (B, HK) f32, the max of (s − φ) over each kv head's rows. Scratch,
// f32: acc_part (B * NSPLIT, C, HQ, D), den_part (B * NSPLIT, C, HQ),
// aux_part (B, HQ, ceil(C/64), NSPLIT); NSPLIT = ceil(NB * PS / 256).
REPRO_EXPORT int paged_chunk_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, const void* chunk_lens, void* out, void* stat,
    void* acc_part, void* den_part, void* aux_part, int B, int C, int HQ,
    int HK, int NB, int PS, int NP, int D, int NSPLIT, long long qsb,
    long long qss, long long qsh, long long sp, long long ss, long long sh,
    float scale, float phi, void* stream) {
  const Args a{q,        k,        v,        nullptr, nullptr, bt,
               lengths,  chunk_lens, out,    stat,    acc_part, den_part,
               aux_part, nullptr,  B,        C,       HQ,      HK,
               NB,       PS,       NP,       NSPLIT,  qsb,     qss,
               qsh,      sp,       ss,       sh,      scale,   phi};
  return launch<true>(a, D, static_cast<cudaStream_t>(stream));
}

// Online-max scheme; with a non-null device `flag` (one bool) both
// launches return at entry unless *flag is true — the overflow recompute.
// aux_part is (B * NSPLIT, C, HQ): each partial row's running max.
REPRO_EXPORT int paged_chunk_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, const void* chunk_lens, void* out, const void* flag,
    void* acc_part, void* den_part, void* aux_part, int B, int C, int HQ,
    int HK, int NB, int PS, int NP, int D, int NSPLIT, long long qsb,
    long long qss, long long qsh, long long sp, long long ss, long long sh,
    float scale, void* stream) {
  const Args a{q,        k,        v,        nullptr, nullptr, bt,
               lengths,  chunk_lens, out,    nullptr, acc_part, den_part,
               aux_part, flag,     B,        C,       HQ,      HK,
               NB,       PS,       NP,       NSPLIT,  qsb,     qss,
               qsh,      sp,       ss,       sh,      scale,   0.f};
  return launch<false>(a, D, static_cast<cudaStream_t>(stream));
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous, one step per (page, kv head). Otherwise as the bf16 entries.
REPRO_EXPORT int paged_chunk_attention_unified_max_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths,
    const void* chunk_lens, void* out, void* stat, void* acc_part,
    void* den_part, void* aux_part, int B, int C, int HQ, int HK, int NB,
    int PS, int NP, int D, int NSPLIT, long long qsb, long long qss,
    long long qsh, long long sp, long long ss, long long sh, float scale,
    float phi, int fp8, void* stream) {
  const Args a{q,        k,        v,        k_step,  v_step,  bt,
               lengths,  chunk_lens, out,    stat,    acc_part, den_part,
               aux_part, nullptr,  B,        C,       HQ,      HK,
               NB,       PS,       NP,       NSPLIT,  qsb,     qss,
               qsh,      sp,       ss,       sh,      scale,   phi};
  return launch_q8<true>(a, D, fp8, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_chunk_attention_sync_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths,
    const void* chunk_lens, void* out, const void* flag, void* acc_part,
    void* den_part, void* aux_part, int B, int C, int HQ, int HK, int NB,
    int PS, int NP, int D, int NSPLIT, long long qsb, long long qss,
    long long qsh, long long sp, long long ss, long long sh, float scale,
    int fp8, void* stream) {
  const Args a{q,        k,        v,        k_step,  v_step,  bt,
               lengths,  chunk_lens, out,    nullptr, acc_part, den_part,
               aux_part, flag,     B,        C,       HQ,      HK,
               NB,       PS,       NP,       NSPLIT,  qsb,     qss,
               qsh,      sp,       ss,       sh,      scale,   0.f};
  return launch_q8<false>(a, D, fp8, static_cast<cudaStream_t>(stream));
}
