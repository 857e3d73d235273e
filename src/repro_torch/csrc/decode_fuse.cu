// Fused decode-layer stages: the three seams of DecodeFusionPlan.
//
// Replaces: src/repro/kernels/decode_fuse.py
//   * decode_ingest_fused (_ingest_kernel): rmsnorm -> x @ [Wq Wk Wv] ->
//     bias -> rope, the normed x resident in VMEM across the K grid;
//   * oproj_residual_fused (_oproj_kernel): resid + o @ Wo, serving both
//     the o_proj and the FFN down projection;
//   * ffn_norm_fused (_ffn_norm_kernel): rmsnorm -> x @ Wg, x @ Wu ->
//     act(g) * u on the f32 accumulators.
//
// Bound on H100: device-memory bytes. At decode M (the slot count) every
// seam is a flat GEMM: 2 * M * K * N FLOPs per K * N * 2 weight bytes,
// at most 64 FLOP per byte against the ~295 FLOP/byte ridge of the bf16
// tensor cores, so the weight stream sets the time. Fusing moves no
// fewer weight bytes; it removes the normed x, the pre-rope q/k, the
// attention output's residual add and the gate/up activations as round
// trips through device memory, and most of the launches: four per layer
// in place of seven GEMM launches and about twenty elementwise ops.
//
// Design: the TPU kernels walk one sequential grid with a normed-x
// scratch in VMEM; here every block is independent, so every block that
// needs the normed rows computes them itself (flat_stream.cuh's
// norm_rows_range: each row's rms over all of K in one fixed order, so
// the same bits in every block, whatever K range it then writes).
//   * decode_ingest: a block owns one head, a head_dim-column tile of one
//     of the q, k or v streams (three weight pointers, no concatenated
//     copy), and one K split. A head per block gave 18 blocks at qwen2-
//     0.5b (14 + 2 + 2 heads) for 132 SMs, each walking all of K, so the
//     launch's z axis holds S fixed ranges of ceil(n_kt / S) whole 64-row
//     K tiles from K = 0 (S from kernels/decode_fuse.py::ingest_splits:
//     K, the head count and the card, never M; 7 there, 126 blocks), and
//     the S blocks of a head form a thread-block cluster along z. A block
//     normalises its rows over its range only into shared memory, streams
//     its range's weight tiles through a 4-stage cp.async ring (mma.sync
//     m16n8k16, operands swapped: the head's columns fill m16, tokens n8)
//     and leaves its f32 partial in shared memory; after cluster.sync()
//     each block folds a slice of the (column i, column i + head_dim / 2)
//     pairs over the splits in split order through distributed shared
//     memory, so the epilogue runs in place on the sums, at the split
//     chain's rounding points: (the step,) the bf16 rounding, the bf16
//     bias (rounded again), rope on the pair in f32 with the angle pos *
//     theta^(-i/half), rounded once. v gets no rope; absent biases read
//     as zero.
//   * oproj_residual: flat_gemm.cu's bodies themselves (flat_stream.cuh's
//     split gemm_split_kernel at narrow N, gemm_wgmma.cuh's wgmma body
//     otherwise) with their residual epilogue: the accumulator rounds to
//     bf16 and the kernel writes resid + acc, rounded once, as `resid +
//     matmul(o, wo)` does.
//   * ffn_norm: ffn_norm_wgmma.cuh's wgmma + TMA body for bf16 weights and
//     codes alike, split K over a cluster, the rmsnorm applied as the
//     consumer stages x (its header has the design), M tiled in 64-row
//     tiles over blockIdx.y.
// None uses atomics: a replayed step gives the same bits.
//
// Quantized weights (the quantized branches of the three TPU kernels): each
// kernel is templated on the weight element type, and the *_q8 entries take
// (K, N) int8 or e4m3 codes, streamed at 1 byte, with one f32 step per
// output channel. The steps multiply the f32 accumulators at the JAX
// kernels' points: before the bf16 rounding, the bias and rope (ingest),
// before the rounding and the residual add (oproj_residual), before the
// activation (ffn_norm).
#include "ffn_norm_wgmma.cuh"
#include "gemm_wgmma.cuh"

using namespace repro;

namespace {

constexpr int kIngestBK = 64;      // K rows per tile and per split chunk
constexpr int kIngestStages = 4;   // the weight ring
constexpr int kIngestPerSM = 2;    // blocks a SM the split count counts on
                                   // (kernels/decode_fuse.py: INGEST_PER_SM)

// sin and cos of rope's angle pos * theta^(-i / half) for column pair i.
__device__ __forceinline__ void rope_factors(float theta, int i, int half,
                                             int pos, float& sn, float& cs) {
  const float freq =
      powf(theta, -static_cast<float>(i) / static_cast<float>(half));
  sincosf(static_cast<float>(pos) * freq, &sn, &cs);
}

// One head of one stream over one K split; the gridDim.z = S splits of a
// head form a cluster along z (block rank = split).
template <int BN, typename WT>
__global__ void __launch_bounds__(BN / 16 * 32, kIngestPerSM)
ingest_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ scale,
              const WT* __restrict__ wq, const WT* __restrict__ wk,
              const WT* __restrict__ wv, const float* __restrict__ sq,
              const float* __restrict__ sk, const float* __restrict__ sv,
              const __nv_bfloat16* __restrict__ bq,
              const __nv_bfloat16* __restrict__ bk,
              const __nv_bfloat16* __restrict__ bv,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ oq,
              __nv_bfloat16* __restrict__ ok, __nv_bfloat16* __restrict__ ov,
              int M, int K, int NQ, int NK, long long ldx, int mt, int rope,
              float theta, float eps) {
  constexpr int BK = kIngestBK, NST = kIngestStages;
  using T = flat::Tile<BN, BK, true, WT>;
  constexpr int NT = T::kThreads;
  constexpr int kRing = NST * T::kWBytes;  // weight tiles only
  static_assert(sizeof(float) * flat::kMT * BN <= kRing,
                "the partials reuse the ring");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem[];

  // which stream and which head of it this block owns
  const int q_blocks = NQ / BN, k_blocks = NK / BN;
  const int bx = blockIdx.x;
  int stream = 0, n0 = bx * BN;
  if (bx >= q_blocks + k_blocks) {
    stream = 2;
    n0 = (bx - q_blocks - k_blocks) * BN;
  } else if (bx >= q_blocks) {
    stream = 1;
    n0 = (bx - q_blocks) * BN;
  }
  const WT* w = stream == 0 ? wq : stream == 1 ? wk : wv;
  const float* step = stream == 0 ? sq : stream == 1 ? sk : sv;
  const __nv_bfloat16* bias = stream == 0 ? bq : stream == 1 ? bk : bv;
  __nv_bfloat16* out = stream == 0 ? oq : stream == 1 ? ok : ov;
  const int N = stream == 0 ? NQ : NK;

  // this split's K tiles: ceil(n_kt / S) whole chunks each from K = 0
  const int n_kt = (K + BK - 1) / BK;
  const int per = (n_kt + S - 1) / S;
  const int kt_lo = min(n_kt, z * per);
  const int n = min(n_kt, kt_lo + per) - kt_lo;
  const int m0 = blockIdx.y * mt;
  const int nt = min(mt / 8, (M - m0 + 7) / 8);  // live n8 token tiles

  // the normed rows of this range, after the ring (every block's row rms
  // is over all of K, in one order); while their first loads fly, the
  // ring's first weight tiles go out and the epilogue's operands head for
  // L1
  auto load = [&](int i) {
    flat::load_w<BN, BK, NT, true, WT>(smem + i % NST * T::kWBytes, w,
                                       K, N, N, n0, (kt_lo + i) * BK);
  };
  const int xp = per * BK + 8;
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem + kRing);
  flat::norm_rows_range(
      [=](int r, int c) { return reinterpret_cast<uint4*>(xn + r * xp + c); },
      [&](int live) {
        for (int i = 0; i < NST - 1; ++i) {
          if (i < n) load(i);
          cp_async_commit();
        }
        prefetch_l1(pos + m0, min(mt, M - m0) * 4, threadIdx.x, NT);
        if (bias != nullptr) prefetch_l1(bias + n0, BN * 2, threadIdx.x, NT);
        if constexpr (flat::kIsCode<WT>)
          prefetch_l1(step + n0, BN * 4, threadIdx.x, NT);
        flat::zero_rows(xn, xp, live, nt * 8, NT);
      },
      x, ldx, scale, M, K, m0, nt * 8, kt_lo * BK, per * BK, eps,
      threadIdx.x / 32, NT / 32);

  // acc (this warp's 16 columns x nt n8 row tiles) = the normed rows' K
  // tiles @ W's, flat::split_mainloop's arithmetic on one K range
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int i = 0; i < n; ++i) {
    if (i + NST - 1 < n) load(i + NST - 1);
    cp_async_commit();         // possibly empty: keeps the group count uniform
    cp_async_wait<NST - 1>();  // tile i has landed
    __syncthreads();           // (the first: the normed rows are written)
    const unsigned char* wsb = smem + i % NST * T::kWBytes;
    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(xn) + i * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      flat::w_frag<BN, BK, true, WT>(wsb, kk, warp * 16, g, t, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const uint16_t* xr = xs16 + (j * 8 + g) * xp + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
          mma_bf16(acc[j], a[0], a[1], a[2], a[3], b0, b1);
        }
      }
    }
    __syncthreads();  // stage i may be refilled next iteration
  }

  // this split's f32 partial, part[r][c] (c < BN), over the dead ring:
  // the same offset in every block of the cluster
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(j * 8 + 2 * t + (i & 1)) * BN + warp * 16 + g + (i >> 1) * 8] =
            acc[j][i];
    }
  }
  // the rope factors of this thread's first element of the fold below,
  // while the other splits finish
  constexpr int kHalf = BN / 2;
  const int E = min(mt, M - m0) * kHalf;
  const int e0 = E * z / S + threadIdx.x;
  float sn0 = 0.f, cs0 = 1.f;
  if (rope && stream < 2 && e0 < E * (z + 1) / S)
    rope_factors(theta, e0 % kHalf, kHalf, pos[m0 + e0 / kHalf], sn0, cs0);
  cluster.sync();  // every split's partial is written and visible

  // each block folds one slice of the live rows' column pairs (i, i +
  // half) over the splits in split order (distributed shared memory, every
  // split's value requested before the sums), then runs the epilogue in
  // place at the split chain's rounding points: (the step,) round, add the
  // bias, round, and rope on the pair in f32 with one rounding (__fmul_rn /
  // __fadd_rn: no contraction into fma); v gets no rope; absent biases
  // read as zero
  for (int e = e0; e < E * (z + 1) / S; e += NT) {
    const int r = e / kHalf, i = e % kHalf;
    const int gm = m0 + r;
    float* p1 = part + r * BN + i;
    float v1[flat::kMaxSplits], v2[flat::kMaxSplits];
#pragma unroll
    for (int q = 0; q < flat::kMaxSplits; ++q) {
      if (q < S) {
        v1[q] = *cluster.map_shared_rank(p1, q);
        v2[q] = *cluster.map_shared_rank(p1 + kHalf, q);
      }
    }
    float a1 = v1[0], a2 = v2[0];
#pragma unroll
    for (int q = 1; q < flat::kMaxSplits; ++q) {
      if (q < S) {
        a1 += v1[q];
        a2 += v2[q];
      }
    }
    if constexpr (flat::kIsCode<WT>) {
      a1 *= step[n0 + i];
      a2 *= step[n0 + i + kHalf];
    }
    const float b1 = bias != nullptr ? bf2f(bias[n0 + i]) : 0.f;
    const float b2 = bias != nullptr ? bf2f(bias[n0 + i + kHalf]) : 0.f;
    const float x1 = bf2f(f2bf(bf2f(f2bf(a1)) + b1));
    const float x2 = bf2f(f2bf(bf2f(f2bf(a2)) + b2));
    float o1 = x1, o2 = x2;
    if (rope && stream < 2) {
      float sn = sn0, cs = cs0;
      if (e != e0) rope_factors(theta, i, kHalf, pos[gm], sn, cs);
      o1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
      o2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
    }
    __nv_bfloat16* row = out + static_cast<long long>(gm) * N + n0;
    row[i] = f2bf(o1);
    row[i + kHalf] = f2bf(o2);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int BN, typename WT>
int launch_ingest(int splits, const void* x, const void* scale,
                  const void* wq, const void* wk, const void* wv,
                  const void* sq, const void* sk, const void* sv,
                  const void* bq, const void* bk, const void* bv,
                  const int* pos, void* oq, void* ok, void* ov, int M, int K,
                  int NQ, int NK, long long ldx, int mt, int rope,
                  float theta, float eps, cudaStream_t st) {
  using T = flat::Tile<BN, kIngestBK, true, WT>;
  const int per = ((K + kIngestBK - 1) / kIngestBK + splits - 1) / splits;
  const size_t smem = kIngestStages * T::kWBytes +
                      static_cast<size_t>(mt) * (per * kIngestBK + 8) * 2;
  auto kernel = ingest_kernel<BN, WT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NQ / BN + 2 * (NK / BN), (M + mt - 1) / mt, splits);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using B = __nv_bfloat16;
  using F = float;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const B*>(x), static_cast<const B*>(scale),
      static_cast<const WT*>(wq), static_cast<const WT*>(wk),
      static_cast<const WT*>(wv), static_cast<const F*>(sq),
      static_cast<const F*>(sk), static_cast<const F*>(sv),
      static_cast<const B*>(bq), static_cast<const B*>(bk),
      static_cast<const B*>(bv), pos, static_cast<B*>(oq),
      static_cast<B*>(ok), static_cast<B*>(ov), M, K, NQ, NK, ldx, mt, rope,
      theta, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT>
int dispatch_ingest(int head_dim, int splits, const void* x,
                    const void* scale, const void* wq, const void* wk,
                    const void* wv, const void* sq, const void* sk,
                    const void* sv, const void* bq, const void* bk,
                    const void* bv, const void* pos, void* oq, void* ok,
                    void* ov, int M, int K, int NQ, int NK, long long ldx,
                    int mt, int rope, float theta, float eps,
                    cudaStream_t st) {
  if (splits < 1 || splits > flat::kMaxSplits || mt < 8 || mt > flat::kMT ||
      mt % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
#define REPRO_IN_CASE(BN_)                                                  \
  if (head_dim == BN_)                                                      \
    return launch_ingest<BN_, WT>(splits, x, scale, wq, wk, wv, sq, sk, sv, \
                                  bq, bk, bv, p, oq, ok, ov, M, K, NQ, NK,  \
                                  ldx, mt, rope, theta, eps, st);
  REPRO_IN_CASE(32)
  REPRO_IN_CASE(64)
  REPRO_IN_CASE(128)
#undef REPRO_IN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (M, NQ), k / v (M, NK) row-major bf16 = rope(rmsnorm(x) @ W + b) for
// q and k, rmsnorm(x) @ Wv + bv for v; x (M, K; row stride ldx), scale
// (K,), W row-major (K, N), biases (N,) or null (zero), pos (M,) int32.
// head_dim (32, 64 or 128) is the block's column tile and must divide NQ
// and NK; mt token rows a block (a multiple of 8, at most 64); K in
// `splits` (1 .. 8) ranges of whole 64-row tiles folded in order. Needs
// K % 8 == 0 with 16-byte aligned rows.
REPRO_EXPORT int decode_ingest_bf16(const void* x, const void* scale,
                                    const void* wq, const void* wk,
                                    const void* wv, const void* bq,
                                    const void* bk, const void* bv,
                                    const void* pos, void* oq, void* ok,
                                    void* ov, int M, int K, int NQ, int NK,
                                    long long ldx, int head_dim, int mt,
                                    int splits, int rope, float theta,
                                    float eps, void* stream) {
  return dispatch_ingest<__nv_bfloat16>(
      head_dim, splits, x, scale, wq, wk, wv, nullptr, nullptr, nullptr, bq,
      bk, bv, pos, oq, ok, ov, M, K, NQ, NK, ldx, mt, rope, theta, eps,
      static_cast<cudaStream_t>(stream));
}

// decode_ingest_bf16 with quantized weights: wq / wk / wv (K, N) row-major
// codes, int8 (fp8 = 0) or e4m3 (fp8 = 1), and their (N,) f32 steps sq /
// sk / sv; q, k, v = rope(bf16(acc * step) + b). Needs N % 16 == 0 too.
REPRO_EXPORT int decode_ingest_q8(const void* x, const void* scale,
                                  const void* wq, const void* wk,
                                  const void* wv, const void* sq,
                                  const void* sk, const void* sv,
                                  const void* bq, const void* bk,
                                  const void* bv, const void* pos, void* oq,
                                  void* ok, void* ov, int M, int K, int NQ,
                                  int NK, long long ldx, int head_dim,
                                  int mt, int splits, int rope, float theta,
                                  float eps, int fp8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return dispatch_ingest<__nv_fp8_e4m3>(
        head_dim, splits, x, scale, wq, wk, wv, sq, sk, sv, bq, bk, bv, pos,
        oq, ok, ov, M, K, NQ, NK, ldx, mt, rope, theta, eps, st);
  return dispatch_ingest<int8_t>(head_dim, splits, x, scale, wq, wk, wv, sq, sk,
                                 sv, bq, bk, bv, pos, oq, ok, ov, M, K, NQ,
                                 NK, ldx, mt, rope, theta, eps, st);
}

// out (M, N) row-major bf16 = resid + bf16(o @ W); o (M, K; row stride
// ldo), W row-major (K, N), resid (M, N; row stride ldr); split = 1 runs
// the narrow-N split body at BK = bkt, 0 the wgmma body (bkt = 64), K in
// `splits` ranges summed in order (flat_gemm.cu's bodies).
// Needs K % 8 == 0 and N % 8 == 0 with 16-byte aligned rows.
REPRO_EXPORT int oproj_residual_bf16(const void* o, const void* w,
                                     const void* resid, void* out, int M,
                                     int K, int N, long long ldo,
                                     long long ldr, int split, int bkt,
                                     int splits, void* stream) {
  return gw::dispatch<true, __nv_bfloat16>(split, bkt, splits, o, w, nullptr,
                                           resid, out, M, K, N, ldo, N, ldr,
                                           static_cast<cudaStream_t>(stream));
}

// oproj_residual_bf16 with quantized weights: W (K, N) row-major codes,
// int8 (fp8 = 0) or e4m3 (fp8 = 1), steps (N,) f32; out = resid +
// bf16(acc * step). Needs N % 16 == 0.
REPRO_EXPORT int oproj_residual_q8(const void* o, const void* w,
                                   const void* wscale, const void* resid,
                                   void* out, int M, int K, int N,
                                   long long ldo, long long ldr, int split,
                                   int bkt, int splits, int fp8,
                                   void* stream) {
  return gw::dispatch_q8(fp8, split, bkt, splits, o, w, wscale, resid, out,
                         M, K, N, ldo, N, ldr,
                         static_cast<cudaStream_t>(stream));
}

// out (M, N) row-major bf16 = act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu);
// x (M, K; row stride ldx), scale (K,), Wg / Wu contiguous row-major
// (K, N); act = silu (gelu = 0) or the tanh gelu (gelu = 1); K in
// `splits` (1 .. 8) ranges of whole 64-row tiles folded in order (the
// wgmma body, ffn_norm_wgmma.cuh). Needs K % 8 == 0 and N % 8 == 0 with
// 16-byte aligned rows and bases.
REPRO_EXPORT int ffn_norm_bf16(const void* x, const void* scale,
                               const void* wg, const void* wu, void* out,
                               int M, int K, int N, long long ldx, int gelu,
                               int splits, float eps, void* stream) {
  return tcn::launch_ffn_norm_wgmma<__nv_bfloat16>(
      x, scale, wg, wu, nullptr, nullptr, out, M, K, N, ldx, gelu, splits,
      eps, static_cast<cudaStream_t>(stream));
}

// ffn_norm_bf16 with quantized weights: Wg / Wu (K, N) row-major codes,
// int8 (fp8 = 0) or e4m3 (fp8 = 1), steps sg / su (N,) f32 applied to the
// folded sums before the activation. Needs N % 16 == 0.
REPRO_EXPORT int ffn_norm_q8(const void* x, const void* scale,
                             const void* wg, const void* wu, const void* sg,
                             const void* su, void* out, int M, int K, int N,
                             long long ldx, int gelu, int splits, float eps,
                             int fp8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8)
    return tcn::launch_ffn_norm_wgmma<__nv_fp8_e4m3>(
        x, scale, wg, wu, sg, su, out, M, K, N, ldx, gelu, splits, eps, st);
  return tcn::launch_ffn_norm_wgmma<int8_t>(x, scale, wg, wu, sg, su, out, M,
                                            K, N, ldx, gelu, splits, eps, st);
}
