// Causal / sliding-window flash attention for the prefill phase, in both
// softmax schemes (paper §3 applied to prefill).
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill
//   (_prefill_kernel_async for unified_max=True, _prefill_kernel_sync).
//
// Bound on H100: at the main path's prompt lengths (64..512 tokens,
// head_dim 64) the causal work is 4 * Sq * Sk / 2 * D FLOPs per head
// against (Sq + 2 Sk) * D * 2 bytes: tens of FLOP per byte, under the
// card's ~295 bf16 ridge, so device-memory bytes bound it on paper. The
// block's walk is at most 8 64-key tiles on the tensor cores
// (attn_tile.cuh), each waiting in turn on its copy, its MMA chain and
// its softmax: that serial walk of the longest (last) query tile, the
// pipeline's fill and the launch set the time, some 20-30x the bound.
//
// Design: grid (ceil(Sq / 64), HQ, B); one block of 128 threads (4 warps
// of 16 query rows) per (64-query tile, query head), with kv_head = h / G
// (GQA by index, no repeated KV). The block walks 64-key tiles from the
// window's first tile (lo) to the causal limit of its last row (hi) with
// the shared tile body of attn_tile.cuh: bf16 mma.sync into f32, K/V
// tiles double-buffered through cp.async, keys past hi zero-filled.
// Masks are per (row, key) from absolute positions: causal, sliding
// window, key < Sk, row < Sq.
//   * unified-max (T1): weights exp(s − φ), no running max, no rescale;
//     each block writes the max of (s − φ) over its valid entries into a
//     (B, HQ, n_q_tiles) buffer, and the wrapper takes one amax over the
//     tiles, so `stat` is the true per-(b, h) max over every query row.
//   * sync: the online-max FlashAttention-2 update, masked logits at
//     -1e30 as in the reference; given a device flag it returns at entry
//     unless the flag is set (the overflow recompute).
// No split of the keys: at B = 2, Sq = 512 the grid is already 8 x 14 x 2
// = 224 blocks on 132 SMs. Rows with no valid key come out as zeros.
// q, k and v are strided views: every row start must be 16-byte aligned
// for cp.async (the wrapper checks the base pointers and strides).
#include "attn_tile.cuh"

using namespace repro;

namespace {

using attn::kBK;
using attn::kBQ;
using attn::kThreads;

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
  extern __shared__ __align__(16) unsigned char smem[];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = qt * kBQ;
  const int delta = Sk - Sq;       // query i sits at key position i + delta

  // key range this tile can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int hi = Sk;
  if (causal) hi = min(Sk, q_last + delta + 1);
  int lo = 0;
  if (window) lo = max(0, q0 + delta - window + 1);

  attn::load_q<D>(smem, q + b * qsb + h * qsh, qss, q0, Sq);
  const attn::DenseRows rows{b * ksb + kvh * ksh, kss, b * vsb + kvh * vsh,
                             vss};
  auto valid = [&](int r, int key) {
    const int qi = q0 + r, qpos = qi + delta;
    bool ok = qi < Sq && key < hi;
    if (causal) ok = ok && key <= qpos;
    if (window) ok = ok && qpos - key < window;
    return ok;
  };
  attn::Acc<D> a;
  a.init();
  attn::walk<D, UNIFIED, __nv_bfloat16>(smem, k, v, rows, lo / kBK * kBK,
                                        hi, scale, phi, valid, a);
  a.reduce_den();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + 8 * i;
    if (qi >= Sq) continue;
    const float inv = a.den[i] != 0.f ? 1.f / a.den[i] : 0.f;
    __nv_bfloat16* o =
        out + ((static_cast<long long>(b) * Sq + qi) * HQ + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          a.o[j][2 * i] * inv, a.o[j][2 * i + 1] * inv);
  }

  if (UNIFIED) {
    const float m = attn::block_max(a.msc_max());
    if (threadIdx.x == 0)
      stat_part[(static_cast<long long>(b) * HQ + h) * gridDim.x + qt] = m;
  }
}

template <int D, bool UNIFIED>
int launch_d(dim3 grid, const void* q, const void* k, const void* v,
             void* out, void* stat_part, const void* flag, int Sq, int Sk,
             int HQ, int G, const long long* qs, const long long* ks,
             const long long* vs, int causal, int window, float scale,
             float phi, cudaStream_t st) {
  constexpr size_t smem = attn::Smem<D, __nv_bfloat16>::kBytes;
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
// (batch, seq, head; head_dim contiguous; 16-byte aligned rows); out
// (B, Sq, HQ, D) contiguous; stat_part (B, HQ, ceil(Sq/64)) f32 per-tile
// max of (s − φ).
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
