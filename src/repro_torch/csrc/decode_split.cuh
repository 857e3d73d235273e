// Split-KV decode attention on the tensor-core tile body of attn_tile.cuh:
// the split kernel and the combine kernel behind rows 3-6 of PERF.md's
// kernel table (decode_attention.cu, every body) and the grouped pair of
// row 11 (group_attention.cu, whose stage 1 uses the helpers below).
//
// One new token per sequence: its G = HQ/HK query heads of a kv head are
// the rows of one m16 mma.sync fragment (rows >= G load as zeros; G <= 16),
// so each K/V row is read once for all G heads.
//
//   * Splits. Key positions are cut at fixed absolute multiples of kSplit
//     = 64, one attn_tile.cuh tile each. NSPLIT = ceil(S / 64) comes from
//     the cache's (or the block table's) static width, so the host reads
//     nothing of `lengths` and a CUDA graph can capture the launches.
//   * split_kernel, grid (ceil(NSPLIT / 4), HK, B), 4 warps per block.
//     Warp w takes split 4 blockIdx.x + w alone: it issues the cp.async
//     copies of its own K and V tile (keys at or past the row's length
//     zero-filled, never read), loads its Q fragment straight from device
//     memory meanwhile, waits, and runs one tile_step (S = Q Kᵀ, the
//     softmax step, O = P V, all on the tensor cores). No warp waits on
//     another, and a warp whose split starts at or past the length
//     returns at once. It writes its split's f32 partial of each live row
//     to scratch: acc[D], den, and aux = the row's max of s − φ (unified
//     max, for `stat`) or its running max m (online max).
//   * combine_kernel, grid (G, HK, B), one block per output row, one
//     thread per column pair: each folds its row's splits 0 .. (len − 1) /
//     64 in ascending order, loading kBatch splits at once and adding them
//     in order (the fold is a chain of dependent steps, so the rows are
//     spread over as many SMs as possible). Unified-max partials add (no
//     rescale: T1's point); online-max partials merge by the LSE rule,
//     guarded so that a split with no valid key adds nothing. It writes
//     out (bf16; a row with no valid key gives zeros)
//     and, unified, stat (B, HK): the max over splits and over the G heads,
//     each row's block raising it by an atomic max from the -inf the split
//     kernel left there (a max does not depend on the order of updates).
//   * Both launches of the online-max scheme return at entry unless the
//     device flag is set (the overflow recompute); with no flag they run.
//   * Shard partials (PARTIAL): the cache is one rank's slice of the
//     sequence, keys start .. start + S - 1 of each row, and `lengths`
//     stay global; both kernels read the row's local length as
//     clamp(lengths[b] - start, 0, S). The combine folds the row's splits
//     exactly as above but writes the un-normalised f32 partial instead
//     of out: num[D], den and aux (unified: the row's max of s − φ;
//     online max: its max m), a row with no key on the slice giving 0, 0
//     and -inf. Ranks join these by core/softmax.py's collective combines.
//
// A split's partial of a row is a function of its q row and its keys
// alone: mma.sync computes each output row from its own A row, and every
// per-row statistic stays in that row's quad. So the dense and the paged
// kernels agree bit for bit on the same KV (they differ only in the row
// functor), and the grouped pair, which forms the prefix's whole splits
// once per group with the member rows packed into other fragment rows,
// agrees bit for bit with the paged kernel: its combine folds the same
// partials in the same order.
//
// Why 64-key splits and one tile per warp: a decode call moves well under
// a megabyte at the serving shapes, so its time is load latency, not
// bytes; a walk over a (sequence, kv head) puts every load on one warp's
// critical path. A split is the unit the tile body already computes, it
// lets the whole cache be requested at once (one wave of blocks at the
// serving shapes), and its partials cost 4 (D + 2) bytes per head per 64
// keys.
#pragma once

#include "attn_tile.cuh"

namespace repro {
namespace dsplit {

using attn::kBK;
using attn::kLog2e;
using attn::kNegBig;

constexpr int kSplit = kBK;              // keys per split: one tile
constexpr int kWarps = 4;                // splits per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 16;                // query rows of one fragment
// Splits a combine thread loads at once before folding them in order:
// 16 under the unified max, 8 under the online max, whose fold is a chain
// of exponentials (the fastest of 8, 16, 32 for each on the card).
template <bool UNIFIED>
constexpr int kBatch = UNIFIED ? 16 : 8;

// One warp's shared memory: (codes only) its converted bf16 K / V tiles
// and their steps, then its stage of K and V rows as stored.
template <int D, typename T>
struct WarpSmem {
  using A = attn::Smem<D, T>;
  static constexpr int kTiles = A::kKVBytes;          // 0 for bf16
  static constexpr int kBytes = A::kKVBytes + A::kStageBytes;
  static constexpr size_t kBlockBytes = static_cast<size_t>(kWarps) * kBytes;
};

// The bf16 K and V tiles a warp's tile_step reads, and (codes) the steps.
struct Tile {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* steps;
};

// Issue the warp's copies of keys kv0 .. kv0 + 63 into its stage (keys at
// or past `end` zero-filled) as one cp.async group.
template <int D, typename T, typename Rows>
__device__ __forceinline__ void issue_tile(unsigned char* region,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const Rows& rows, int kv0,
                                           int end) {
  attn::load_kv<D, T>(region + WarpSmem<D, T>::kTiles, k, v, rows, kv0, end,
                      threadIdx.x % 32, 32);
  cp_async_commit();
}

// Wait for the warp's copies; codes are converted to exact bf16 values
// beside their steps.
template <int D, typename T, typename Rows>
__device__ __forceinline__ Tile finish_tile(unsigned char* region,
                                            const Rows& rows, int kv0,
                                            int end) {
  using A = attn::Smem<D, T>;
  unsigned char* stage = region + WarpSmem<D, T>::kTiles;
  cp_async_wait0();
  __syncwarp();
  if constexpr (attn::kCodes<T>) {
    attn::convert_codes<D, T>(region, stage, rows, kv0, end,
                              threadIdx.x % 32, 32);
    __syncwarp();
    return {reinterpret_cast<const __nv_bfloat16*>(region),
            reinterpret_cast<const __nv_bfloat16*>(region + A::kTileBytes),
            reinterpret_cast<const float*>(region + 2 * A::kTileBytes)};
  }
  return {reinterpret_cast<const __nv_bfloat16*>(stage),
          reinterpret_cast<const __nv_bfloat16*>(stage + A::kRingTile),
          nullptr};
}

// The A fragments of query rows g and g + 8 (g = lane / 4) of a fragment,
// straight from device memory: `lo` / `hi` point at those rows (head_dim
// contiguous), null for a row that loads as zeros. These are the registers
// ldmatrix gives from a shared copy (attn_tile.cuh's walk).
template <int D>
__device__ __forceinline__ void load_qf(uint32_t (&qf)[D / 16][4],
                                        const __nv_bfloat16* lo,
                                        const __nv_bfloat16* hi) {
  const int t = threadIdx.x % 4;
  auto word = [](const __nv_bfloat16* p, int c) {
    return p ? __ldg(reinterpret_cast<const unsigned int*>(p + c)) : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = word(lo, c);
    qf[kk][1] = word(hi, c);
    qf[kk][2] = word(lo, c + 8);
    qf[kk][3] = word(hi, c + 8);
  }
}

// A fragment's partials after its tile_step: fragment row r goes to
// scratch row row_at(r), or nowhere when that is negative.
template <int D, bool UNIFIED, typename RowAt>
__device__ __forceinline__ void store_partials(attn::Acc<D>& a,
                                               const RowAt& row_at,
                                               float* __restrict__ acc_part,
                                               float* __restrict__ den_part,
                                               float* __restrict__ aux_part) {
  a.reduce_den();
  if (UNIFIED) a.reduce_msc();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row_at(g + 8 * i);
    if (row < 0) continue;
    float* acc = acc_part + row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(acc + 8 * j) =
          make_float2(a.o[j][2 * i], a.o[j][2 * i + 1]);
    if (t == 0) {
      den_part[row] = a.den[i];
      aux_part[row] = UNIFIED ? a.msc[i] : a.m[i];
    }
  }
}

// Key rows of sequence b, kv head h in a dense (B, S, HK, D) cache.
struct DenseSeq {
  long long sb, ss, sh;
  __device__ __forceinline__ attn::DenseRows rows(int b, int h) const {
    const long long base = b * sb + h * sh;
    return {base, ss, base, ss};
  }
};

// Key rows of sequence b, kv head h in an (NP, PS, HK, D) page pool
// through its block-table row; codes carry one step per (page, kv head).
struct PagedSeq {
  const int* bt;
  int NB, PS, NP, HK;
  long long sp, ss, sh;
  const float* k_step;
  const float* v_step;
  __device__ __forceinline__ attn::PagedRows rows(int b, int h) const {
    return {bt + static_cast<long long>(b) * NB, PS, NP, HK, h, sp, ss, sh,
            k_step, v_step};
  }
};

// Where a row's first splits come from: nowhere else (every split is the
// row's own). group_attention.cu's GroupPrefix takes splits 0 .. first(b)
// - 1 from its group's stage-1 scratch instead: split s of row (b, h, g)
// at scratch row row0(b, h, g) + s * stride.
struct NoPrefix {
  const float* acc = nullptr;
  const float* den = nullptr;
  const float* aux = nullptr;
  long long stride = 0;
  __device__ __forceinline__ int first(int) const { return 0; }
  __device__ __forceinline__ long long row0(int, int, int) const {
    return 0;
  }
};

// Scratch rows: (B, NSPLIT, HQ) of acc[D], den, aux.
template <int D, bool UNIFIED, typename T, typename Seq, typename Prefix>
__global__ void __launch_bounds__(kThreads)
split_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, Seq seq, Prefix pre,
             const int* __restrict__ lengths, float* __restrict__ acc_part,
             float* __restrict__ den_part, float* __restrict__ aux_part,
             float* __restrict__ stat, const bool* __restrict__ flag, int HK,
             int G, int S, int NSPLIT, float scale, float phi, int start) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the combine raises stat[b, h] from here (atomic_max_float)
  if (UNIFIED && stat != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stat[b * HK + h] = -INFINITY;
  const int split = blockIdx.x * kWarps + warp, kv0 = split * kSplit;
  const int len = min(max(lengths[b] - start, 0), S);
  if (kv0 >= len || split < pre.first(b)) return;

  const auto rows = seq.rows(b, h);
  unsigned char* region = smem + warp * WarpSmem<D, T>::kBytes;
  issue_tile<D, T>(region, k, v, rows, kv0, len);
  const int HQ = HK * G, g = lane / 4;
  const __nv_bfloat16* qb = q + (static_cast<long long>(b) * HQ + h * G) * D;
  uint32_t qf[D / 16][4];
  load_qf<D>(qf, g < G ? qb + g * D : nullptr,
             g + 8 < G ? qb + (g + 8) * D : nullptr);
  const Tile t = finish_tile<D, T>(region, rows, kv0, len);

  attn::Acc<D> a;
  a.init();
  auto valid = [&](int r, int key) { return r < G && key < len; };
  attn::tile_step<D, UNIFIED, T>(qf, t.k, t.v, t.steps, kv0, scale, phi,
                                 valid, a, 0);
  const long long row0 =
      (static_cast<long long>(b) * NSPLIT + split) * HQ + h * G;
  store_partials<D, UNIFIED>(
      a, [&](int r) { return r < G ? row0 + r : -1LL; }, acc_part, den_part,
      aux_part);
}

// The combine's threads per block: one per column pair of a row (at
// least a warp).
template <int D>
constexpr int kCombineThreads = D / 2 < 32 ? 32 : D / 2;

// *addr = max(*addr, v) for floats, ordered through their bit patterns: a
// non-negative float orders as a signed int, a negative one in reverse as
// an unsigned int. The max does not depend on the order of the updates.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Where a shard partial goes (PARTIAL): (B, HQ) rows of num[D] f32, den
// and aux.
struct PartialOut {
  float* num;
  float* den;
  float* aux;
};

template <int D, bool UNIFIED, typename Prefix, bool PARTIAL>
__global__ void __launch_bounds__(kCombineThreads<D>)
combine_kernel(const float* __restrict__ acc_part,
               const float* __restrict__ den_part,
               const float* __restrict__ aux_part, Prefix pre,
               const int* __restrict__ lengths,
               __nv_bfloat16* __restrict__ out, float* __restrict__ stat,
               PartialOut part, const bool* __restrict__ flag, int HK, int G,
               int S, int NSPLIT, int start) {
  if (!UNIFIED && flag != nullptr && !*flag) return;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, HQ = HK * G;
  const int dp = threadIdx.x * 2;
  if (dp >= D) return;
  const int len = min(max(lengths[b] - start, 0), S);
  const int n = (len + kSplit - 1) / kSplit;      // the row's splits
  const int s0 = min(pre.first(b), n);            // ... of them the group's
  const long long own0 = static_cast<long long>(b) * NSPLIT * HQ + h * G + g;
  const long long pre0 = s0 > 0 ? pre.row0(b, h, g) : 0;
  float2 acc = make_float2(0.f, 0.f);
  float den = 0.f, m = kNegBig, smax = -INFINITY;
  bool any = false;
  constexpr int kB = kBatch<UNIFIED>;
  for (int sb = 0; sb < n; sb += kB) {
    float2 pa[kB];
    float pd[kB], px[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int s = sb + j;
      if (s < n) {
        const bool grp = s < s0;
        const long long row = grp ? pre0 + s * pre.stride
                                  : own0 + static_cast<long long>(s) * HQ;
        pa[j] = *reinterpret_cast<const float2*>(
            (grp ? pre.acc : acc_part) + row * D + dp);
        pd[j] = (grp ? pre.den : den_part)[row];
        px[j] = (grp ? pre.aux : aux_part)[row];
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (sb + j >= n) break;
      if (UNIFIED) {
        acc.x += pa[j].x;
        acc.y += pa[j].y;
        den += pd[j];
        smax = fmaxf(smax, px[j]);
      } else {
        if (px[j] <= kNegBig) continue;     // saw no valid key
        if (!any) {
          acc = pa[j];
          den = pd[j];
          m = px[j];
          any = true;
          continue;
        }
        const float mn = fmaxf(m, px[j]);
        const float r1 = exp2f((m - mn) * kLog2e);
        const float r2 = exp2f((px[j] - mn) * kLog2e);
        acc.x = acc.x * r1 + pa[j].x * r2;
        acc.y = acc.y * r1 + pa[j].y * r2;
        den = den * r1 + pd[j] * r2;
        m = mn;
      }
    }
  }
  const long long orow = static_cast<long long>(b) * HQ + h * G + g;
  if constexpr (PARTIAL) {
    *reinterpret_cast<float2*>(part.num + orow * D + dp) = acc;
    if (threadIdx.x == 0) {
      part.den[orow] = den;
      part.aux[orow] = UNIFIED ? smax : (any ? m : -INFINITY);
    }
    return;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  *reinterpret_cast<__nv_bfloat162*>(
      out + orow * D + dp) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  // unified: stat[b, h], -inf from the split kernel, rises to the max over
  // the G rows and their splits
  if (UNIFIED && threadIdx.x == 0 && n > 0)
    atomic_max_float(stat + b * HK + h, smax);
}

// One call's operands: scratch (B, NSPLIT, HQ) f32 rows of acc[D], den
// and aux; out (B, HQ, D) bf16; stat (B, HK) f32 (unified) or null; flag
// one device bool (online max) or null. A shard partial sets `part` (out
// and stat null) and its slice's first key position `start`.
struct Launch {
  const void *q, *k, *v, *lengths, *flag;
  void *out, *stat, *acc, *den, *aux;
  int B, HK, G, S, NSPLIT;
  float scale, phi;
  PartialOut part = {nullptr, nullptr, nullptr};
  int start = 0;
};

template <int D, bool UNIFIED, typename Prefix, bool PARTIAL>
void launch_combine(const Launch& L, const Prefix& pre, cudaStream_t st) {
  combine_kernel<D, UNIFIED, Prefix, PARTIAL>
      <<<dim3(L.G, L.HK, L.B), kCombineThreads<D>, 0, st>>>(
          static_cast<const float*>(L.acc), static_cast<const float*>(L.den),
          static_cast<const float*>(L.aux), pre,
          static_cast<const int*>(L.lengths),
          static_cast<__nv_bfloat16*>(L.out), static_cast<float*>(L.stat),
          L.part, static_cast<const bool*>(L.flag), L.HK, L.G, L.S, L.NSPLIT,
          L.start);
}

template <int D, bool UNIFIED, typename T, typename Seq, typename Prefix>
int run_d(const Launch& L, const Seq& seq, const Prefix& pre,
          cudaStream_t st) {
  constexpr size_t smem = WarpSmem<D, T>::kBlockBytes;
  cudaError_t e = allow_smem(split_kernel<D, UNIFIED, T, Seq, Prefix>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* flag = static_cast<const bool*>(L.flag);
  split_kernel<D, UNIFIED, T, Seq, Prefix>
      <<<dim3((L.NSPLIT + kWarps - 1) / kWarps, L.HK, L.B), kThreads, smem,
          st>>>(static_cast<const __nv_bfloat16*>(L.q),
               static_cast<const T*>(L.k), static_cast<const T*>(L.v), seq,
               pre, static_cast<const int*>(L.lengths),
               static_cast<float*>(L.acc), static_cast<float*>(L.den),
               static_cast<float*>(L.aux), static_cast<float*>(L.stat), flag,
               L.HK, L.G, L.S, L.NSPLIT, L.scale, L.phi, L.start);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L.part.num != nullptr)
    launch_combine<D, UNIFIED, Prefix, true>(L, pre, st);
  else
    launch_combine<D, UNIFIED, Prefix, false>(L, pre, st);
  return static_cast<int>(cudaGetLastError());
}

// Both launches for head_dim D in {32, 64, 128}; refuses a G past one
// fragment and an NSPLIT that does not cover S in 64-key splits exactly.
template <bool UNIFIED, typename T, typename Seq, typename Prefix>
int run(const Launch& L, int D, const Seq& seq, const Prefix& pre,
        cudaStream_t st) {
  if (L.G < 1 || L.G > kMaxG || L.HK < 1 || L.B < 1 || L.S < 1 ||
      L.B > 65535 || L.HK > 65535 ||
      static_cast<long long>(L.NSPLIT) * kSplit < L.S ||
      static_cast<long long>(L.NSPLIT - 1) * kSplit >= L.S)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return run_d<32, UNIFIED, T>(L, seq, pre, st);
    case 64:
      return run_d<64, UNIFIED, T>(L, seq, pre, st);
    case 128:
      return run_d<128, UNIFIED, T>(L, seq, pre, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dsplit
}  // namespace repro
