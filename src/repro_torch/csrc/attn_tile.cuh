// The tensor-core attention tile body shared by flash_prefill.cu (row 7
// of PERF.md's kernel table), chunk_attention.cu (rows 9-10) and
// decode_split.cuh (rows 3-6 and 11), with their int8 / fp8 bodies: one
// FlashAttention-2 block step for bf16 operands with f32 accumulation.
// The walk below is the prefill and chunk kernels'; the decode kernels
// run tile_step on one tile per warp (decode_split.cuh).
//
//   * A block is 4 warps over a 64-row query tile. Q lands in shared
//     memory as bf16 once; each warp keeps the A fragments of its 16 rows
//     in registers for the whole walk.
//   * K and V arrive in 64-key tiles through a two-stage shared-memory
//     ring filled by cp.async: tile j + 1 is in flight while tile j is
//     consumed. Keys at or past the walk's end are zero-filled by the copy
//     (src-size 0), never read from device memory. Rows are padded by 16
//     bytes, so the 8 rows one ldmatrix phase reads start in 8 distinct
//     4-bank groups: no bank conflicts.
//   * S = Q Kᵀ with mma.sync m16n8k16 (K fragments by ldmatrix), then
//     `scale` on the f32 scores. Row statistics stay in registers: each
//     row of an m16n8 fragment lives in the 4 threads of a quad, which
//     combine by two shuffles.
//       - unified max (T1): p = exp(s − φ), no running max, no rescale;
//         the thread keeps the max of its valid s − φ in each of its two
//         rows for `stat`.
//       - sync: the online max, masked logits at -1e30, so no partial
//         starts from exp(-inf - -inf).
//   * O += P V: P is rounded to bf16 in registers and fed as the A operand
//     (the S fragment of two n8 tiles is the A fragment of one k16 step),
//     V fragments by ldmatrix.trans. The row sum `den` is taken from the
//     f32 P. A masked entry gets weight 0, and every key it could meet in
//     V is either a written position or a zero-filled one, never NaN.
//   * Quantized pools (int8 / fp8 e4m3 codes): the ring carries the codes
//     at their stored width; each tile is converted once into the bf16
//     K / V tiles (exact: |int8| <= 127 and every e4m3 value are bf16
//     values) beside the tile's K and V steps, so the same MMAs run. The K
//     step scales the f32 score column of its key, s = scale * k_step *
//     (q . code); the V step scales P's column before P is rounded.
//
// Why mma.sync and not wgmma: wgmma issues a 64-row tile from a whole
// warpgroup, asynchronously, with K and V described to it as swizzled
// shared-memory matrices; it pays off when a block streams many tiles
// back to back. Here a block walks 1 to 8 tiles (the causal limit, or one
// 256-key split), and each tile waits on its copy, its MMA chain and the
// softmax in turn: the time is that serial latency and the launches, not
// the MMA issue rate (PERF.md). At D = 128 the O accumulator (64
// registers), the Q fragments (32) and S (32) already take most of a
// thread's registers under the 128-thread block's 255 cap.
#pragma once

#include "common.cuh"

namespace repro {
namespace attn {

constexpr int kBQ = 64;        // query rows per block: 4 warps x 16
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kCodes = sizeof(T) == 1;

// Shared memory of one block: the Q tile, (codes only) the converted bf16
// K and V tiles with the tile's steps, then the two ring stages of K and
// V tiles (bf16 rows, or code rows).
template <int D, typename T>
struct Smem {
  static constexpr int kPitch = D + 8;                  // bf16 row pitch
  static constexpr int kTileBytes = kBK * kPitch * 2;   // one bf16 tile
  static constexpr int kQBytes = kBQ * kPitch * 2;
  static constexpr int kCodePitch = D + 16;             // code row pitch
  static constexpr int kRowBytes = kCodes<T> ? kCodePitch : kPitch * 2;
  static constexpr int kRingTile = kBK * kRowBytes;
  static constexpr int kStageBytes = 2 * kRingTile;     // K, V
  static constexpr int kKVBytes =
      kCodes<T> ? 2 * kTileBytes + 2 * kBK * 4 : 0;    // + K, V steps
  static constexpr size_t kBytes = kQBytes + kKVBytes + 2 * kStageBytes;
};

// Key rows of a dense (B, S, HK, D) k / v pair through element strides.
struct DenseRows {
  long long kbase, kstride, vbase, vstride;
  __device__ __forceinline__ long long krow(int key) const {
    return kbase + key * kstride;
  }
  __device__ __forceinline__ long long vrow(int key) const {
    return vbase + key * vstride;
  }
};

// Key rows of one sequence in an (NP, PS, HK, D) page pool, through its
// block-table row (entries clamped to the pool: unassigned ones hold the
// sentinel NP); codes carry one step per (page, kv head).
struct PagedRows {
  const int* bt;
  int PS, NP, HK, kvh;
  long long sp, ss, sh;
  const float* k_step;
  const float* v_step;
  __device__ __forceinline__ long long page(int key) const {
    int p = __ldg(bt + key / PS);
    return p < 0 ? 0 : (p >= NP ? NP - 1 : p);
  }
  __device__ __forceinline__ long long krow(int key) const {
    return page(key) * sp + (key % PS) * ss + kvh * sh;
  }
  __device__ __forceinline__ long long vrow(int key) const {
    return krow(key);
  }
  __device__ __forceinline__ float kstep(int key) const {
    return __ldg(k_step + page(key) * HK + kvh);
  }
  __device__ __forceinline__ float vstep(int key) const {
    return __ldg(v_step + page(key) * HK + kvh);
  }
};

// Rows q0 .. q0 + 63 of a query head (row r at q + r * row_stride, head
// dim contiguous) into the Q tile, zero past `rows`. The copies are left
// uncommitted: walk() commits them as its first group.
template <int D>
__device__ __forceinline__ void load_q(unsigned char* smem,
                                       const __nv_bfloat16* __restrict__ q,
                                       long long row_stride, int q0,
                                       int rows) {
  constexpr int kCpr = D / 8;
  constexpr int kPitchBytes = (D + 8) * 2;
  for (int c = threadIdx.x; c < kBQ * kCpr; c += kThreads) {
    const int r = c / kCpr, cc = c % kCpr;
    const bool ok = q0 + r < rows;
    cp_async16(smem + r * kPitchBytes + cc * 16,
               ok ? q + (q0 + r) * row_stride + cc * 8 : q, ok);
  }
}

// The K and V rows of keys kv0 .. kv0 + 63 into one ring stage; keys at
// or past `end` are zero-filled and their rows never read. The copies are
// shared by `nthr` threads, `tid` being this thread's rank among them: the
// block (walk() below), or one warp that owns its stage (decode_split.cuh).
template <int D, typename T, typename Rows>
__device__ __forceinline__ void load_kv(unsigned char* stage,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const Rows& rows, int kv0, int end,
                                        int tid, int nthr) {
  using S = Smem<D, T>;
  constexpr int kCpr = D * static_cast<int>(sizeof(T)) / 16;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  for (int c = tid; c < kBK * kCpr; c += nthr) {
    const int r = c / kCpr, cc = c % kCpr, key = kv0 + r;
    const bool ok = key < end;
    const unsigned char* ks = kb;
    const unsigned char* vs = vb;
    if (ok) {
      ks += rows.krow(key) * static_cast<long long>(sizeof(T)) + cc * 16;
      vs += rows.vrow(key) * static_cast<long long>(sizeof(T)) + cc * 16;
    }
    cp_async16(stage + r * S::kRowBytes + cc * 16, ks, ok);
    cp_async16(stage + S::kRingTile + r * S::kRowBytes + cc * 16, vs, ok);
  }
}

// One stage of codes into the bf16 K / V tiles (exact values), and the
// tile's K and V steps (0 past `end`, whose pages are never read); shared
// by `nthr` threads as load_kv.
template <int D, typename T, typename Rows>
__device__ __forceinline__ void convert_codes(unsigned char* kv_s,
                                              const unsigned char* stage,
                                              const Rows& rows, int kv0,
                                              int end, int tid, int nthr) {
  using S = Smem<D, T>;
  constexpr int kVpr = D / 16;          // 16-code vectors per row
  for (int c = tid; c < 2 * kBK * kVpr; c += nthr) {
    const int which = c / (kBK * kVpr), rem = c % (kBK * kVpr);
    const int r = rem / kVpr, cc = rem % kVpr;
    const uint4 u = *reinterpret_cast<const uint4*>(
        stage + which * S::kRingTile + r * S::kCodePitch + cc * 16);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&u);
    uint4 o[2];
    uint32_t* w = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = pack2(code_bits<T>(b[2 * i]), code_bits<T>(b[2 * i + 1]));
    uint4* dst = reinterpret_cast<uint4*>(
        kv_s + which * S::kTileBytes + r * S::kPitch * 2 + cc * 32);
    dst[0] = o[0];
    dst[1] = o[1];
  }
  float* steps = reinterpret_cast<float*>(kv_s + 2 * S::kTileBytes);
  for (int c = tid; c < 2 * kBK; c += nthr) {     // K steps, then V steps
    const int key = kv0 + c % kBK;
    const bool kside = c < kBK;
    steps[c] = key < end ? (kside ? rows.kstep(key) : rows.vstep(key)) : 0.f;
  }
}

// A thread's share of the block's accumulators: rows g and g + 8 of its
// warp's 16 (g = lane / 4), columns 8 j + 2 (lane % 4), + 1 of O.
template <int D>
struct Acc {
  float o[D / 8][4];
  float den[2];     // this thread's share of the row sums
  float m[2];       // sync: running row max (kNegBig: no valid key yet)
  float msc[2];     // unified: max valid s − φ this thread saw in each row

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    den[0] = den[1] = 0.f;
    m[0] = m[1] = kNegBig;
    msc[0] = msc[1] = -INFINITY;
  }

  // The max of msc over this thread's two rows.
  __device__ __forceinline__ float msc_max() const {
    return fmaxf(msc[0], msc[1]);
  }

  // Each row's msc over the quad that shares it.
  __device__ __forceinline__ void reduce_msc() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      msc[i] = fmaxf(msc[i], __shfl_xor_sync(0xffffffffu, msc[i], 1));
      msc[i] = fmaxf(msc[i], __shfl_xor_sync(0xffffffffu, msc[i], 2));
    }
  }

  // The row sums over the quad that shares each row.
  __device__ __forceinline__ void reduce_den() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
      den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
    }
  }
};

// One 64-key tile: S, the softmax step, O += P V for the 16 query rows
// row_base .. row_base + 15 held in `qf`. `ks` / `vs` are the bf16 K / V
// tiles, `steps` (codes only) their K then V steps, `valid` the mask of
// (query row, absolute key). A row's results depend only on its own q
// row and the tile: mma.sync computes each output row from its A row
// alone, and every per-row statistic stays in that row's quad.
template <int D, bool UNIFIED, typename T, typename Valid>
__device__ __forceinline__ void tile_step(
    const uint32_t (&qf)[D / 16][4], const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const float* steps, int kv0, float scale,
    float phi, const Valid& valid, Acc<D>& a, int row_base) {
  constexpr int P = D + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = row_base + g;

  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * P +
                      kk * 16 + (((lane >> 3) & 1) << 3));
      mma_bf16(s[2 * jj], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], kb[0],
               kb[1]);
      mma_bf16(s[2 * jj + 1], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
               kb[2], kb[3]);
    }
  }

  bool ok[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = j * 8 + 2 * t + (e & 1);
      float sc = scale;
      if constexpr (kCodes<T>) sc *= steps[c];
      s[j][e] *= sc;
      ok[j][e] = valid(r0 + (e >> 1) * 8, kv0 + c);
    }

  // s becomes P in place
  if constexpr (UNIFIED) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cen = s[j][e] - phi;
        float p = 0.f;
        if (ok[j][e]) {
          a.msc[e >> 1] = fmaxf(a.msc[e >> 1], cen);
          p = exp2f(cen * kLog2e);
        }
        a.den[e >> 1] += p;
        s[j][e] = p;
      }
  } else {
    float mt[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (ok[j][e]) mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
    float resc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(a.m[i], mt[i]);
      resc[i] = exp2f((a.m[i] - m_new) * kLog2e);
      a.m[i] = m_new;
      a.den[i] *= resc[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      a.o[j][0] *= resc[0];
      a.o[j][1] *= resc[0];
      a.o[j][2] *= resc[1];
      a.o[j][3] *= resc[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            ok[j][e] ? exp2f((s[j][e] - a.m[e >> 1]) * kLog2e) : 0.f;
        a.den[e >> 1] += p;
        s[j][e] = p;
      }
  }
  if constexpr (kCodes<T>) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= steps[kBK + j * 8 + 2 * t + (e & 1)];
  }

#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
    const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
    const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + (16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                 P + dp * 16 + ((lane >> 4) << 3));
      mma_bf16(a.o[2 * dp], a0, a1, a2, a3, vb[0], vb[1]);
      mma_bf16(a.o[2 * dp + 1], a0, a1, a2, a3, vb[2], vb[3]);
    }
  }
}

// The block's walk over keys kv_begin .. kv_end - 1 in 64-key tiles
// (kv_begin a tile multiple; keys at or past kv_end zero-filled). The
// caller has issued load_q(); walk() commits it, keeps tile j + 1 in
// flight while tile j is consumed, and returns with the shared memory
// free for reuse.
template <int D, bool UNIFIED, typename T, typename Rows, typename Valid>
__device__ __forceinline__ void walk(unsigned char* smem,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const Rows& rows, int kv_begin,
                                     int kv_end, float scale, float phi,
                                     const Valid& valid, Acc<D>& a) {
  using S = Smem<D, T>;
  constexpr int P = D + 8;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK
                                        : 0;
  if (n_tiles == 0) {
    cp_async_wait0();
    return;
  }
  unsigned char* kv_s = smem + S::kQBytes;
  unsigned char* ring = kv_s + S::kKVBytes;
  cp_async_commit();                                  // group: Q
  load_kv<D, T>(ring, k, v, rows, kv_begin, kv_end, threadIdx.x, kThreads);
  cp_async_commit();                                  // group: tile 0
  cp_async_wait1();                                   // Q has landed
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const __nv_bfloat16* q_s = reinterpret_cast<const __nv_bfloat16*>(smem);
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * P + kk * 16 +
                        ((lane >> 4) << 3));

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * kBK;
    if (it + 1 < n_tiles)
      load_kv<D, T>(ring + ((it + 1) & 1) * S::kStageBytes, k, v, rows,
                    kv0 + kBK, kv_end, threadIdx.x, kThreads);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait1();    // tile it has landed
    __syncthreads();
    unsigned char* stage = ring + (it & 1) * S::kStageBytes;
    const float* steps = nullptr;
    const unsigned char* tiles = stage;
    if constexpr (kCodes<T>) {
      convert_codes<D, T>(kv_s, stage, rows, kv0, kv_end, threadIdx.x,
                          kThreads);
      __syncthreads();
      tiles = kv_s;
      steps = reinterpret_cast<const float*>(kv_s + 2 * S::kTileBytes);
    }
    const int vofs = kCodes<T> ? S::kTileBytes : S::kRingTile;
    tile_step<D, UNIFIED, T>(
        qf, reinterpret_cast<const __nv_bfloat16*>(tiles),
        reinterpret_cast<const __nv_bfloat16*>(tiles + vofs), steps, kv0,
        scale, phi, valid, a, warp * 16);
    __syncthreads();     // the stage (and the converted tiles) may refill
  }
}

// The block's max of the threads' `msc`, for thread 0 (others: garbage).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float wmax[kThreads / 32];
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) wmax[threadIdx.x / 32] = v;
  __syncthreads();
  float m = wmax[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, wmax[w]);
  return m;
}

}  // namespace attn
}  // namespace repro
