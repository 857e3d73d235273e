// Grouped prefix-shared decode attention (T1, unified max): stage 1 and
// stage 2 (split + combine), three launches per call of the pair.
//
// Replaces: src/repro/kernels/group_attention.py::
//   grouped_paged_decode_attention_unified_max (stage 1
//   _group_prefix_kernel, stage 2 _tail_merge_kernel).
//
// Requests whose block tables lead with the same run of shared pages form
// a group; stage 1 reads that run once per (group, kv head) for every
// member's query rows, stage 2 reads each row's private rest and merges.
// Under the unified max (static φ) two partials merge by addition, so the
// stages meet with no rescale.
//
// Bound on H100: device-memory bytes. Decode reads each K/V row once
// (about G = HQ/HK FLOP per byte); grouping cuts the bytes from every
// member's prefix to one prefix per group plus the rest of each row.
//
// Design: row 5's split-KV body (decode_split.cuh) on the same absolute
// 64-key splits.
//   * Stage 1, group_prefix_kernel, grid (NWS, HK, NG): a block takes the
//     group's whole prefix split s = blockIdx.x (keys 64 s .. 64 s + 63,
//     all below g_prefix_len) from the group's table and reads its K/V
//     tile once into shared memory; its warps (one per m16 fragment of the
//     group's M·G member rows, at most 4) each run one tile_step per
//     fragment they take (member m's head g is row m G + g; rows past
//     num_members · G load as zeros and keep the empty partial). It
//     writes each row's partial to group scratch (NG, NWS, HK, M·G) —
//     acc[D], den, max(s − φ) — with NWS = LP·PS / 64 from the static
//     table width. Splits at or past the prefix's whole-split end are not
//     written: nothing reads them.
//   * Stage 2 is row 5's split kernel over each row's own table from the
//     first split at or past the prefix's whole-split end (solo rows: from
//     0), then row 5's combine kernel, which folds each row's splits in
//     ascending order, taking splits below that start from the group's
//     scratch at the row's member slot. Where the prefix ends inside a
//     split (PS < 64), stage 2 re-reads at most 63 prefix keys per row.
// A split's partial of a row depends only on its q row and its keys (an
// mma.sync output row depends only on its A row), so the member rows of
// stage 1 get row 5's partial bits, and the combine folds the same values
// in the same order: out and stat are row 5's bit for bit, for every
// prefix length, with no state carried between the launches. The stat is
// per row, the max over the row's prefix and rest (the JAX kernel reports
// the group-wide max; the overflow flag is the same). Table entries are
// clamped to the pool (sentinel NP), member rows to the batch (sentinel B).
//
// Quantized pools (int8 / fp8 e4m3 codes; the quantized=True bodies of
// src/repro/kernels/group_attention.py's _group_prefix_kernel and
// _tail_merge_kernel): both stages are templated on the element type and
// run row 5's quantized tile step (codes converted to exact bf16, the K
// step on the score, the V step on P's column), so the pair stays bitwise
// quantized row 5 on the same pool.
#include "decode_split.cuh"

using namespace repro;

namespace {

using dsplit::kSplit;
using dsplit::kWarps;

// Stage 1. Scratch rows (NG, NWS, HK, MG) of gacc[D], gden, gaux. One
// block per whole prefix split; its warps share the split's tile and take
// the member rows' fragments f = warp, warp + nwarps, ...
template <int D, typename T>
__global__ void __launch_bounds__(dsplit::kThreads)
group_prefix_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ k_step,
                    const float* __restrict__ v_step,
                    const int* __restrict__ tables,
                    const int* __restrict__ g_prefix_len,
                    const int* __restrict__ num_members,
                    const int* __restrict__ member_rows,
                    float* __restrict__ gacc, float* __restrict__ gden,
                    float* __restrict__ gaux, int B, int HK, int G, int M,
                    int LP, int PS, int NP, int NWS, long long sp,
                    long long ss, long long sh, float scale, float phi) {
  extern __shared__ __align__(16) unsigned char smem[];
  using A = attn::Smem<D, T>;
  const int split = blockIdx.x, h = blockIdx.y, grp = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32, kv0 = split * kSplit;
  const int plen = min(max(g_prefix_len[grp], 0), LP * PS);
  if (split >= min(plen / kSplit, NWS)) return;   // not a whole prefix split

  // the block's copies of the tile (as row 5's warp makes them alone)
  const attn::PagedRows rows{tables + static_cast<long long>(grp) * LP,
                             PS, NP, HK, h, sp, ss, sh, k_step, v_step};
  unsigned char* stage = smem + dsplit::WarpSmem<D, T>::kTiles;
  attn::load_kv<D, T>(stage, k, v, rows, kv0, plen, threadIdx.x, blockDim.x);
  cp_async_commit();

  const int HQ = HK * G, MG = M * G, g = lane / 4;
  const int live = min(max(num_members[grp], 0), M) * G;
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    if (r >= live) return nullptr;
    int b = member_rows[grp * M + r / G];
    b = b < 0 ? 0 : (b >= B ? B - 1 : b);
    return q + (static_cast<long long>(b) * HQ + h * G + r % G) * D;
  };
  uint32_t qf[D / 16][4];
  dsplit::load_qf<D>(qf, q_row(warp * 16 + g), q_row(warp * 16 + g + 8));
  cp_async_wait0();
  __syncthreads();
  dsplit::Tile t{reinterpret_cast<const __nv_bfloat16*>(stage),
                 reinterpret_cast<const __nv_bfloat16*>(stage + A::kRingTile),
                 nullptr};
  if constexpr (attn::kCodes<T>) {
    attn::convert_codes<D, T>(smem, stage, rows, kv0, plen, threadIdx.x,
                              blockDim.x);
    __syncthreads();
    t = {reinterpret_cast<const __nv_bfloat16*>(smem),
         reinterpret_cast<const __nv_bfloat16*>(smem + A::kTileBytes),
         reinterpret_cast<const float*>(smem + 2 * A::kTileBytes)};
  }

  auto valid = [&](int r, int key) { return r < live && key < plen; };
  const long long row0 =
      ((static_cast<long long>(grp) * NWS + split) * HK + h) * MG;
  for (int f = warp; f * 16 < MG; f += nwarps) {
    if (f != warp)
      dsplit::load_qf<D>(qf, q_row(f * 16 + g), q_row(f * 16 + g + 8));
    attn::Acc<D> a;
    a.init();
    attn::tile_step<D, true, T>(qf, t.k, t.v, t.steps, kv0, scale, phi,
                                valid, a, f * 16);
    dsplit::store_partials<D, true>(
        a,
        [&](int r) {
          r += f * 16;
          return r < MG ? row0 + r : -1LL;
        },
        gacc, gden, gaux);
  }
}

// Stage 2's view of stage 1: a seeded row (its group and member slot in
// range, prefix_len > 0) takes its splits below min(prefix_len, S) / 64
// from the group's scratch at its member slot (stride HK * MG rows from
// one split to the next).
struct GroupPrefix {
  const float* acc;
  const float* den;
  const float* aux;
  long long stride;
  const int* gid;
  const int* member;
  const int* prefix_len;
  int NG, MG, G, HK, NWS, S;
  __device__ __forceinline__ int first(int b) const {
    const int grp = gid[b], mem = member[b], plen = prefix_len[b];
    const bool seeded = plen > 0 && grp >= 0 && grp < NG && mem >= 0 &&
                        (mem + 1) * G <= MG;
    return seeded ? min(min(plen, S) / kSplit, NWS) : 0;
  }
  __device__ __forceinline__ long long row0(int b, int h, int g) const {
    return (static_cast<long long>(gid[b]) * NWS * HK + h) * MG +
           member[b] * G + g;
  }
};

template <typename T>
int prefix(const void* q, const void* k, const void* v, const void* k_step,
           const void* v_step, const void* tables, const void* g_prefix_len,
           const void* num_members, const void* member_rows, void* gacc,
           void* gden, void* gaux, int B, int HK, int G, int NG, int LP,
           int M, int PS, int NP, int D, int NWS, long long sp, long long ss,
           long long sh, float scale, float phi, void* stream) {
  if (NG < 1 || M < 1 || G < 1 || HK < 1 || LP < 1 || PS < 1 ||
      NG > 65535 || HK > 65535 ||
      NWS != (LP * PS >= kSplit ? LP * PS / kSplit : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // one warp per m16 fragment of the M·G member rows, at most 4
  const int frags = (M * G + 15) / 16;
  const int threads = 32 * (frags < kWarps ? frags : kWarps);
  const dim3 grid(NWS, HK, NG);
#define REPRO_GA_PREFIX(DD)                                                   \
  {                                                                           \
    constexpr size_t smem = dsplit::WarpSmem<DD, T>::kBytes;                  \
    cudaError_t e = allow_smem(group_prefix_kernel<DD, T>, smem);             \
    if (e != cudaSuccess) return static_cast<int>(e);                         \
    group_prefix_kernel<DD, T><<<grid, threads, smem, cs>>>(                  \
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),       \
        static_cast<const T*>(v), static_cast<const float*>(k_step),          \
        static_cast<const float*>(v_step), static_cast<const int*>(tables),   \
        static_cast<const int*>(g_prefix_len),                                \
        static_cast<const int*>(num_members),                                 \
        static_cast<const int*>(member_rows), static_cast<float*>(gacc),      \
        static_cast<float*>(gden), static_cast<float*>(gaux), B, HK, G, M,    \
        LP, PS, NP, NWS, sp, ss, sh, scale, phi);                             \
  }
  switch (D) {
    case 32: REPRO_GA_PREFIX(32) break;
    case 64: REPRO_GA_PREFIX(64) break;
    case 128: REPRO_GA_PREFIX(128) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_GA_PREFIX
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tail(const void* q, const void* k, const void* v, const void* k_step,
         const void* v_step, const void* bt, const void* lengths,
         const void* gid, const void* member, const void* prefix_len,
         const void* gacc, const void* gden, const void* gaux, void* out,
         void* stat_out, void* acc, void* den, void* aux, int B, int HK,
         int G, int NB, int PS, int NP, int NG, int MG, int D, int NWS,
         int NSPLIT, long long sp, long long ss, long long sh, float scale,
         float phi, void* stream) {
  if (NWS < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dsplit::Launch L{q,   k,   v, lengths, nullptr, out,     stat_out,
                         acc, den, aux, B,     HK,      G,       NB * PS,
                         NSPLIT, scale, phi};
  const dsplit::PagedSeq seq{static_cast<const int*>(bt), NB, PS, NP, HK,
                             sp, ss, sh, static_cast<const float*>(k_step),
                             static_cast<const float*>(v_step)};
  const GroupPrefix pre{static_cast<const float*>(gacc),
                        static_cast<const float*>(gden),
                        static_cast<const float*>(gaux),
                        static_cast<long long>(HK) * MG,
                        static_cast<const int*>(gid),
                        static_cast<const int*>(member),
                        static_cast<const int*>(prefix_len),
                        NG, MG, G, HK, NWS, NB * PS};
  return dsplit::run<true, T>(L, D, seq, pre,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

REPRO_ERROR_STRING_FN

// Stage 1. q (B, HQ, D) contiguous; pools (NP, PS, HK, D) with element
// (p, r, h, d) at p*sp + r*ss + h*sh + d; tables (NG, LP), g_prefix_len /
// num_members (NG,), member_rows (NG, M) int32; gacc (NG, NWS, HK, M*G, D),
// gden / gaux (NG, NWS, HK, M*G) f32 with NWS = max(1, LP * PS / 64).
REPRO_EXPORT int group_prefix_bf16(
    const void* q, const void* k, const void* v, const void* tables,
    const void* g_prefix_len, const void* num_members,
    const void* member_rows, void* gacc, void* gden, void* gaux, int B,
    int HK, int G, int NG, int LP, int M, int PS, int NP, int D, int NWS,
    long long sp, long long ss, long long sh, float scale, float phi,
    void* stream) {
  return prefix<__nv_bfloat16>(q, k, v, nullptr, nullptr, tables,
                               g_prefix_len, num_members, member_rows, gacc,
                               gden, gaux, B, HK, G, NG, LP, M, PS, NP, D,
                               NWS, sp, ss, sh, scale, phi, stream);
}

// Stage 2. bt (B, NB), lengths / gid / member / prefix_len (B,) int32;
// gacc / gden / gaux stage 1's scratch (NG groups of MG rows, NWS splits);
// out (B, HQ, D) bf16, stat_out (B, HK) f32; scratch acc (B, NSPLIT, HQ,
// D), den / aux (B, NSPLIT, HQ) f32 with NSPLIT = ceil(NB * PS / 64).
REPRO_EXPORT int group_tail_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, const void* gid, const void* member,
    const void* prefix_len, const void* gacc, const void* gden,
    const void* gaux, void* out, void* stat_out, void* acc, void* den,
    void* aux, int B, int HK, int G, int NB, int PS, int NP, int NG, int MG,
    int D, int NWS, int NSPLIT, long long sp, long long ss, long long sh,
    float scale, float phi, void* stream) {
  return tail<__nv_bfloat16>(q, k, v, nullptr, nullptr, bt, lengths, gid,
                             member, prefix_len, gacc, gden, gaux, out,
                             stat_out, acc, den, aux, B, HK, G, NB, PS, NP,
                             NG, MG, D, NWS, NSPLIT, sp, ss, sh, scale, phi,
                             stream);
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous. Otherwise as the bf16 entries.
REPRO_EXPORT int group_prefix_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* tables, const void* g_prefix_len,
    const void* num_members, const void* member_rows, void* gacc,
    void* gden, void* gaux, int B, int HK, int G, int NG, int LP, int M,
    int PS, int NP, int D, int NWS, long long sp, long long ss, long long sh,
    float scale, float phi, int fp8, void* stream) {
  auto run = fp8 ? &prefix<__nv_fp8_e4m3> : &prefix<int8_t>;
  return run(q, k, v, k_step, v_step, tables, g_prefix_len, num_members,
             member_rows, gacc, gden, gaux, B, HK, G, NG, LP, M, PS, NP, D,
             NWS, sp, ss, sh, scale, phi, stream);
}

REPRO_EXPORT int group_tail_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, const void* gid,
    const void* member, const void* prefix_len, const void* gacc,
    const void* gden, const void* gaux, void* out, void* stat_out, void* acc,
    void* den, void* aux, int B, int HK, int G, int NB, int PS, int NP,
    int NG, int MG, int D, int NWS, int NSPLIT, long long sp, long long ss,
    long long sh, float scale, float phi, int fp8, void* stream) {
  auto run = fp8 ? &tail<__nv_fp8_e4m3> : &tail<int8_t>;
  return run(q, k, v, k_step, v_step, bt, lengths, gid, member, prefix_len,
             gacc, gden, gaux, out, stat_out, acc, den, aux, B, HK, G, NB, PS,
             NP, NG, MG, D, NWS, NSPLIT, sp, ss, sh, scale, phi, stream);
}
