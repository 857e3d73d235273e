// T1 — GQA decode attention over the dense KV cache or the block-paged
// pool, in both softmax schemes (paper §3).
//
// Replaces: src/repro/kernels/decode_attention.py::
//   decode_attention_unified_max (_decode_kernel),
//   decode_attention_sync (_decode_kernel_sync),
//   paged_decode_attention_unified_max (_paged_decode_kernel) and
//   paged_decode_attention_sync (_paged_decode_kernel_sync); the dense
//   pair also as shard partials, the per-shard math of
//   src/repro/core/attention.py::decode_attention_sharded.
//
// Bound on H100: device-memory bytes. One new token per sequence reads
// every valid K and V row once (2 * len * HK * D * 2 bytes) for only
// 4 * len * HQ * D FLOPs — about G = HQ/HK FLOP per byte.
//
// Design: split-KV on the tensor cores, two launches per call
// (decode_split.cuh). The keys are cut at fixed absolute 64-key splits,
// one warp per split computes its partial with attn_tile.cuh's tile step
// (the kv head's G query rows as one m16 fragment), and a combine kernel
// folds each row's splits in ascending order: by addition under the
// unified max (T1: a static φ, no running max, no rescale), by the guarded
// LSE rule under the online max. The unified scheme also reports stat =
// max(s − φ) over the valid positions and the G heads. The online-max
// scheme is the overflow recompute: given a device flag, both launches
// return at entry unless it is set, so the decision never leaves the
// device. Positions >= lengths[b] (clamped to the cache) are zero-filled
// by the copies, never read, and masked.
//
// Dense and paged run one body, templated on how it addresses key j of
// (sequence b, kv head h): DenseSeq reads b*sb + j*ss + h*sh; PagedSeq
// reads page bt[b, j / PS] (clamped to the pool: unassigned table entries
// hold the sentinel NP) at row j % PS. Both cut the same splits and do the
// same arithmetic in the same order, so the paged kernel is bitwise equal
// to the dense one on the same KV laid into any pages. The TPU kernel's
// per-page grid steps become per-key table lookups in the copies: a page
// is never read past lengths[b], so a fully masked page costs nothing.
//
// Quantized pools (int8 / fp8 e4m3 codes, src/repro/kernels/
// decode_attention.py's quantized=True bodies of _paged_decode_kernel and
// _paged_decode_kernel_sync) run the same body templated on the element
// type: each warp converts its tile's codes once into exact bf16 values
// beside the tile's K and V steps (one per page and kv head); the K step
// scales each key's f32 score, the V step P's column before P is rounded
// to bf16. The JAX bodies dequantize to f32 first; the two differ by
// rounding. Bound: the same bytes argument at half the K/V bytes, plus 4
// bytes per (page, kv head) of steps.
#include "decode_split.cuh"

using namespace repro;

namespace {

using dsplit::DenseSeq;
using dsplit::Launch;
using dsplit::NoPrefix;
using dsplit::PagedSeq;

PagedSeq paged(const void* bt, int NB, int PS, int NP, int HK, long long sp,
               long long ss, long long sh, const void* k_step,
               const void* v_step) {
  return PagedSeq{static_cast<const int*>(bt), NB, PS, NP, HK, sp, ss, sh,
                  static_cast<const float*>(k_step),
                  static_cast<const float*>(v_step)};
}

// The quantized entries' code type: int8 (fp8 == 0) or fp8 e4m3.
template <bool UNIFIED>
int run_q8(const Launch& L, int D, const PagedSeq& seq, int fp8,
           cudaStream_t st) {
  if (fp8)
    return dsplit::run<UNIFIED, __nv_fp8_e4m3>(L, D, seq, NoPrefix{}, st);
  return dsplit::run<UNIFIED, int8_t>(L, D, seq, NoPrefix{}, st);
}

}  // namespace

REPRO_ERROR_STRING_FN

// q (B, HQ, D) contiguous; k/v element (b, s, h, d) at b*sb + s*ss + h*sh + d
// (any cache layout whose head_dim is contiguous, 16-byte aligned rows);
// lengths (B,) int32; out (B, HQ, D) contiguous; stat (B, HK) f32 = max
// over valid s of (s − φ). Scratch, f32: acc (B, NSPLIT, HQ, D), den and
// aux (B, NSPLIT, HQ); NSPLIT = ceil(S / 64).
REPRO_EXPORT int decode_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* stat, void* acc, void* den, void* aux, int B, int HK,
    int G, int S, int D, int NSPLIT, long long sb, long long ss, long long sh,
    float scale, float phi, void* stream) {
  const Launch L{q,  k,   v,   lengths, nullptr, out, stat,   acc,
                 den, aux, B,  HK,      G,       S,   NSPLIT, scale, phi};
  return dsplit::run<true, __nv_bfloat16>(L, D, DenseSeq{sb, ss, sh},
                                          NoPrefix{},
                                          static_cast<cudaStream_t>(stream));
}

// Online-max scheme. With a non-null device `flag` (one bool) both
// launches return at entry unless *flag is true — the overflow recompute.
REPRO_EXPORT int decode_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, const void* flag, void* acc, void* den, void* aux, int B,
    int HK, int G, int S, int D, int NSPLIT, long long sb, long long ss,
    long long sh, float scale, void* stream) {
  const Launch L{q,   k,   v, lengths, flag, out, nullptr, acc,
                 den, aux, B, HK,      G,    S,   NSPLIT,  scale, 0.f};
  return dsplit::run<false, __nv_bfloat16>(L, D, DenseSeq{sb, ss, sh},
                                           NoPrefix{},
                                           static_cast<cudaStream_t>(stream));
}

// Shard partials (slice 8a, T1's sequence-split decode): k / v are this
// rank's slice of the dense cache, key positions start .. start + S - 1;
// lengths (B,) are global, each row's local length clamp(lengths[b] -
// start, 0, S) is formed on the device. The same split kernel and fold as
// the entries above, but the combine writes the un-normalised f32 partial:
// num (B, HQ, D), den (B, HQ) and aux (B, HQ) = the row's max of s − φ
// (unified) or its max s (online max; this entry takes no flag and always
// runs), 0 / 0 / -inf for a row with no key on the slice.
REPRO_EXPORT int decode_attention_partial_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* num, void* den_out, void* aux_out, void* acc, void* den, void* aux,
    int B, int HK, int G, int S, int D, int NSPLIT, long long sb, long long ss,
    long long sh, int start, float scale, float phi, void* stream) {
  dsplit::Launch L{q,   k,   v, lengths, nullptr, nullptr, nullptr, acc,
                   den, aux, B, HK,      G,       S,       NSPLIT,  scale,
                   phi};
  L.part = {static_cast<float*>(num), static_cast<float*>(den_out),
            static_cast<float*>(aux_out)};
  L.start = start;
  return dsplit::run<true, __nv_bfloat16>(L, D, DenseSeq{sb, ss, sh},
                                          NoPrefix{},
                                          static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int decode_attention_partial_sync_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* num, void* den_out, void* aux_out, void* acc, void* den, void* aux,
    int B, int HK, int G, int S, int D, int NSPLIT, long long sb, long long ss,
    long long sh, int start, float scale, void* stream) {
  dsplit::Launch L{q,   k,   v, lengths, nullptr, nullptr, nullptr, acc,
                   den, aux, B, HK,      G,       S,       NSPLIT,  scale,
                   0.f};
  L.part = {static_cast<float*>(num), static_cast<float*>(den_out),
            static_cast<float*>(aux_out)};
  L.start = start;
  return dsplit::run<false, __nv_bfloat16>(L, D, DenseSeq{sb, ss, sh},
                                           NoPrefix{},
                                           static_cast<cudaStream_t>(stream));
}

// Paged: k/v pools (NP, PS, HK, D), element (p, r, h, d) at
// p*sp + r*ss + h*sh + d; bt (B, NB) int32 contiguous; lengths (B,) are
// clamped to NB * PS; NSPLIT = ceil(NB * PS / 64). Otherwise as the dense
// entries.
REPRO_EXPORT int paged_decode_attention_unified_max_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, void* stat, void* acc, void* den,
    void* aux, int B, int HK, int G, int NB, int PS, int NP, int D,
    int NSPLIT, long long sp, long long ss, long long sh, float scale,
    float phi, void* stream) {
  const Launch L{q,   k,   v, lengths, nullptr, out,     stat,   acc,
                 den, aux, B, HK,      G,       NB * PS, NSPLIT, scale, phi};
  return dsplit::run<true, __nv_bfloat16>(
      L, D, paged(bt, NB, PS, NP, HK, sp, ss, sh, nullptr, nullptr),
      NoPrefix{}, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_decode_attention_sync_bf16(
    const void* q, const void* k, const void* v, const void* bt,
    const void* lengths, void* out, const void* flag, void* acc, void* den,
    void* aux, int B, int HK, int G, int NB, int PS, int NP, int D,
    int NSPLIT, long long sp, long long ss, long long sh, float scale,
    void* stream) {
  const Launch L{q,   k,   v, lengths, flag, out,     nullptr, acc,
                 den, aux, B, HK,      G,    NB * PS, NSPLIT,  scale, 0.f};
  return dsplit::run<false, __nv_bfloat16>(
      L, D, paged(bt, NB, PS, NP, HK, sp, ss, sh, nullptr, nullptr),
      NoPrefix{}, static_cast<cudaStream_t>(stream));
}

// Quantized pools: k/v hold 1-byte codes (int8, or fp8 e4m3 when fp8 != 0)
// with the same element strides; k_step / v_step are (NP, HK) f32
// contiguous, one step per (page, kv head). Otherwise as the bf16 entries.
REPRO_EXPORT int paged_decode_attention_unified_max_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    void* stat, void* acc, void* den, void* aux, int B, int HK, int G,
    int NB, int PS, int NP, int D, int NSPLIT, long long sp, long long ss,
    long long sh, float scale, float phi, int fp8, void* stream) {
  const Launch L{q,   k,   v, lengths, nullptr, out,     stat,   acc,
                 den, aux, B, HK,      G,       NB * PS, NSPLIT, scale, phi};
  return run_q8<true>(
      L, D, paged(bt, NB, PS, NP, HK, sp, ss, sh, k_step, v_step), fp8,
      static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int paged_decode_attention_sync_q8(
    const void* q, const void* k, const void* v, const void* k_step,
    const void* v_step, const void* bt, const void* lengths, void* out,
    const void* flag, void* acc, void* den, void* aux, int B, int HK, int G,
    int NB, int PS, int NP, int D, int NSPLIT, long long sp, long long ss,
    long long sh, float scale, int fp8, void* stream) {
  const Launch L{q,   k,   v, lengths, flag, out,     nullptr, acc,
                 den, aux, B, HK,      G,    NB * PS, NSPLIT,  scale, 0.f};
  return run_q8<false>(
      L, D, paged(bt, NB, PS, NP, HK, sp, ss, sh, k_step, v_step), fp8,
      static_cast<cudaStream_t>(stream));
}
