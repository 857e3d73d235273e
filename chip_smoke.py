#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profiles-only   # build, then only the decode-tick
                                            # and chunk-step profiles (A, B,
                                            # N, E, H, P, J, K, O, P, S)
    python3 chip_smoke.py --plan-only       # build, then only the cost phase
                                            # and the wallclock tune (the
                                            # plan lands in chiprun_out/)
    python3 chip_smoke.py --slice9a-only    # build, then only phases 7
                                            # and 8
    python3 chip_smoke.py --decode32k-only  # build, then only phases 9
                                            # and 10
    python3 chip_smoke.py --slice8a-only    # build, then only phase 10
    python3 chip_smoke.py --slice8b1-only   # build, then only phase 11
    python3 chip_smoke.py --slice8b2-only   # build, then only phase 12
    python3 chip_smoke.py --slice8b3-only   # build, then only phase 13
    python3 chip_smoke.py --slice8b3b-only  # build, then only phase 14

1. Builds every kernel under ``src/repro_torch/csrc`` with nvcc (sm_90a).
2. Holds each kernel against its plain PyTorch version on the card at the
   full-width qwen2-0.5b shapes of the serving path, both softmax schemes,
   plus inputs scaled so that some s − φ > 40 (forcing the overflow
   recompute); times kernel, plain version and one library call with CUDA
   events (median of 25, L2 flushed before each launch) beside the
   card's least possible time (``bound_ms``). The paged kernels read the
   same KV laid into shuffled pages of a larger pool: paged decode must be
   bitwise the dense decode kernel, and neither paged kernel may change
   its output when every pool row it must not read holds NaN. The
   grouped decode kernels read one shared prefix for four rows: bitwise
   the paged decode kernel on the same pool, and NaN-clean likewise. The
   quantized variants of the GEMM kernels (rows 1, 2, 8 and 12-14 with
   int8 and fp8 codes and f32 per-output-channel steps) are held to their
   plain versions at the layer GEMMs' shapes, timed beside the library
   chain (codes cast to bf16, the GEMM, the step) and the bf16 kernel on
   the same shape; a full-width weight quantized on the card must match
   the CPU's codes and steps bitwise. The quantized KV bodies (rows 5,
   6, 9, 10 and both stages of 11 on int8 and fp8 pages, one f32 step per
   page and kv head) are held to their plain versions on the bf16 rows'
   inputs quantized page by page, timed beside their bf16 twins and the
   library chain (dequantize to bf16, then SDPA); the grouped pair must be
   bitwise quantized row 5, NaN steps on unread pages (and, fp8, NaN codes
   in unread rows) must change nothing, and the KV scatter run on the card
   must give the CPU's codes and steps bitwise. The tensor-core prefill
   and split-KV chunk kernels (rows 7, 9, 10) must give each batch row run
   alone the bits of its rows in the batch; a long chunk (4,032 positions
   before it, 16 splits) is timed beside SDPA, and with a table twice as
   wide and NaN in every unread pool row gives the tight table's bits; a
   ragged chunk (``chunk_lens``) gives its valid rows the clean pool's
   bits with dirty pool rows past each sequence's last valid position.
   The split-KV decode kernels (rows 3-6 and 11) get a second, long line:
   four rows of 8,192 positions (128 splits each), timed beside SDPA,
   paged bitwise dense and, with a 4,096-token prefix shared by the four
   rows, grouped bitwise paged; and a grouped case whose prefix is not a
   multiple of a 64-key split (32-row pages, a 160-token prefix), bf16 and
   int8, bitwise row 5 and unchanged with NaN where it must not read.
   The split-K flat GEMM (rows 2 and 13) is held to its split plain
   version at the q, k / v, o_proj and down shapes, M in {1, 4, 8, 13,
   64}, bf16, int8 and fp8, with and without a residual; a row alone must
   give its row's bits in the batch, a second launch the first's, and a
   CUDA graph's replay the eager call's. Rows 1, 2 and 13 get a second
   line at N = 896 (gemv and flat_gemm on the down projection,
   oproj_residual on the o_proj), timed beside matmul / addmm. Row 2's
   wgmma body (every flat_gemm launch whose N is not narrow) gets the
   same checks at gate / up, the tied heads' (N, K) views and an
   o_proj-sized (K, N) shape (with and without a residual), at
   qwen2-0.5b's and llama2-7b's widths, M in {1, 4, 8, 13, 64, 127, 300},
   bf16, int8 and fp8, and lines at gate / up (M = 4, both widths). The
   split-K GEMV (row 1) is held to its split plain version at the q,
   k / v, o_proj, gate / up and down shapes and the tied head, M in {1,
   2, 4, 5, 8, 15} (past four rows, one launch a 4-row slice), bf16, int8
   and fp8, and the wgmma fused FFN-up (row 8, bf16, int8 and fp8, at
   both widths) at M in {1, 4, 13, 64, 256, 1024}, swiglu and geglu: a
   row alone must give its row's bits in the batch, a second launch the
   first's, and a CUDA graph's replay the eager call's; row 1 gets lines
   at N = 128 and 4,864, row 8 at M = 256 and 1,024 (its codes at M =
   256 and llama2-7b's widths). The split-K decode ingest (row 12) and the
   rmsnorm-fused FFN-up (row 14, bf16 and codes on its wgmma body) get
   the same four checks at M in {1, 4, 8, 13, 64}, bf16, int8 and fp8
   (row 14 swiglu and geglu), at qwen2-0.5b's and at llama2-7b's widths
   (random weights, head_dim 128), and llama2-7b lines timed at M = 4.
   At dbrx-132b's widths (head_dim 128, 48 query / 8 KV heads, d_model
   6,144, random inputs) rows 3-7 and 9-11 (paged bitwise dense, grouped
   bitwise paged) and the GEMM rows 1 and 2 (q / o_proj, k / v, the
   untied 100,352-column head), 12 and 13 are held to their plain
   versions and timed (the kernel table's "dbrx" lines).
3. Serves full-width qwen2-0.5b (SERVE_LAYERS = 4 of its 24 layers, in
   phases 3-5; random weights from --seed), greedy, with every kernel's launch counter set to 0 just before and
   read just after each run: A 4 slots with chunked prefill, B 1 slot,
   C ``prefill_chunk=0`` (flash prefill) on the dense cache; on the paged
   pool D (dense gather, tokens equal to A's), E (fused chunk kernel,
   prefix sharing over a 128-token header), E′ (E without sharing, tokens
   equal to E's), F (E on an overcommitted pool: preemptions, every
   request finishing, the pool empty after), G (E with grouped decode:
   tokens equal to E's) and H (G with the fused FFN-up: the JAX
   package's tuned serving plan; tokens counted against E's); then the
   decode-fusion runs: I (A with the fused stage kernels), J (A looped:
   the decode step replayed as one CUDA graph per tick, tokens equal to
   I's), K (H looped, the tuned plan in full; tokens counted against
   H's), K′ (K's plan with the fused stages, eager: tokens equal to K's)
   and L / L′ (K / K′ on traffic with two headers and varied lengths,
   whose group bucket changes back and forth: L captures several graphs
   in one pool and replays them in turn, not in capture order; tokens
   equal to L′'s), with the graphs' replays credited to the launch
   counters; then quantized weights, with fewer new tokens: M (A with
   int8 weights), N (B with int8), O (J with fp8), O′ (its eager fused
   twin, tokens equal to O's) and P (K's plan with int8); then quantized
   KV pages: Q (E with int8 pages), Q′ (E′ with int8, tokens equal to
   Q's), R (G with int8, tokens equal to Q's), S (K with fp8 pages) and S′
   (its eager fused twin, tokens equal to S's). Every run's decode ticks
   must read exactly the stored GEMM weight bytes of its precision, and a
   paged run exactly its resident pages' stored KV bytes; a quantized run
   must launch the quantized variants and no bf16 layer-GEMM kernel (KV:
   no bf16 attention body), and a bf16 run no quantized variant.
   Then the tiered KV hierarchy: W (E with a 64-page host tier, two
   rounds with every retained page flushed to the host between them:
   round 1's tokens equal E's, round 2's round 1's, pages demoted,
   promoted and session hits above 0, and every promoted page holding
   the bytes it was demoted with), Wc (every W request returns as
   prompt + reply + 32 new tokens: session hits above 0, agreement with
   a tier-less engine counted), W′ (W on S's looped fp8 plan: tokens
   equal to S's, round 2 captures no graph), W″ (W with an 8-page host
   tier and a 64-page disk tier: pages reach the disk, tokens equal E's)
   and Wp (F's pool with the host tier, shortest job first: preemptions,
   demotions and promotions above 0, slots.check(), an empty pool after
   the flush); the tier copies' gather and upload times for 1-128 pages,
   bf16 and fp8, beside ``dispatch.predict_swap_time``, the re-prefill
   they replace and the plans' ``swap_threshold``.
4. Checks the logits of the first prefill and decode step (and, on the
   paged pool, of a chunk that reads resident pages, and of runs H's and
   K's plans over a shared prefix with grouped decode) against the
   ``"torch"`` plan (plain reference math) on the card, and counts the
   greedy tokens on which the two plans agree; checks that a looped
   step's graph replay gives bitwise the eager fused step's logits and
   KV writes, on the dense cache and on the paged pool with grouped
   decode (bf16 pages and int8 ones); checks int8 and fp8 weights' logits
   against the "torch" plan with the same quantized params (default plan,
   fused stages, H's plan) and, on the "torch" plan, against the bf16
   logits within the JAX package's guard (``quant.logits_guard_tol``);
   does the same for int8 and fp8 KV pages on the paged cases; profiles
   the decode tick of A, H, J, K, M, O, P and S, the 1-slot ticks of B and N
   (with the GEMV's share), and the chunk steps of runs E and H (with the
   fused FFN-up's share).
5. T3 on the card: measures the fixed costs ``hardware.H100_SXM`` carries
   for the cost models (a launch in a CUDA graph and eager, the library
   GEMM's edge, a pinned host copy, a decode KV split step, run E's chunk
   step and run J's looped tick beyond their device work, both at the
   full 24 layers), printing each
   beside its committed value; tunes qwen2-0.5b with the wallclock
   measure (``gemv``, ``flat_gemm`` and ``torch.matmul`` timed on the
   card), printing every entry and the three impls' times at M = 1, 4, 8
   and 16, saves the plan under chiprun_out/ and reloads it strictly; fails
   if a shape the layers call has no entry or if the committed
   ``plans_torch/`` plan does not load strictly or differs in an
   analytical knob; serves T (A's traffic and plan with the tuned GEMM
   route) and U (B's, 1 slot), every GEMM's launches checked against the
   plan's pick, tokens counted against A's and B's, their first prefill
   and decode logits within 0.25 of the "torch" plan; profiles T beside A
   and U beside B in turns (busy, wall, the shares of gate / up, k / v
   and the head); and runs V, the serving CLI with ``--plan`` on the
   committed plan, in a subprocess.
6. The MoE family: dbrx-132b at its published widths cut to 4 of its 40
   layers (random bf16 weights from --seed, 28.6 GB), A's prompt lengths,
   16 new tokens, 4 slots: X (paged, the fused chunk kernel, the fused
   stages), X′ (X looped, tokens equal to X's), X″ (the dense cache on
   D's plan) and X‴ (paged on D's plan, tokens equal to X″'s); every
   ``ops.matmul`` of X at a ``called_gemm_shapes`` shape; X's first
   prefill and decode logits within 5 % of the "torch" plan's range on
   the "torch" run's expert choices, and free on every row whose token
   chose the same experts (rows that chose otherwise are counted); busy
   and wall a tick of X and X′, the MoE tail's share of X's busy
   tick, and the tick's bytes against its bound.
7. The recurrent and encoder-decoder families at their published widths
   (``slice7b_phase``; rwkv6 and hymba cut to FAMILY_LAYERS' 4 layers): Y (rwkv6-1.6b), Z and Z′ (hymba-1.5b,
   Z′ with long prompts and the fused FFN-up) and AA (whisper-tiny),
   each served split and then looped (``looped_family_phase``: one CUDA
   graph a tick, tokens bit for bit the split run's), busy and wall a
   tick of each granularity.
8. The trainer (``train_phase``, the "torch" plan): qwen2-0.5b at its
   published widths and depth trains TRAIN_STEPS steps (loss finite and
   falling; ms a step, tokens/s, peak memory); 2 layers on the card
   against the CPU; a resumed run bit for bit the uninterrupted one;
   the training CLI under SIGTERM, then resumed; one step of every other
   family's smoke config against the CPU's loss.
9. The cell qwen2-0.5b x decode_32k (``decode32k_phase``): its dry run
   (``repro_torch.launch.dryrun``, in process, on the meta device) must
   say it fits one card; full-width, full-depth params from --seed and a
   dense (128, 32,768) cache filled layer by layer from the same
   generator must come to the dry run's argument bytes exactly; one
   split decode tick on the "cuda" plan is timed (median of 5
   CUDA-event walls) and profiled, and fails if busy or wall falls below
   the floor (argument bytes over the datasheet memory rate) or the
   card's peak memory exceeds the dry run's per_device_bytes; row 3 at
   B 128 x S 32,768 on layer 0's cache against its plain version, timed
   beside SDPA (the kernel table's "s32k" line); the tick's logits
   against the "torch" plan's.
10. Slice 8a, T1's sequence-split decode (``slice8a_phase``): rows 3 and
   4 as shard partials at qwen2-0.5b's width, B 4 x S 32,768 (lengths
   31,000 / 16,380 / 9,000 / 40) cut into W = 2 and 4 slices, each
   slice's partial against its plain version (timed beside SDPA and the
   slice's bound) and the slices joined by ``core/softmax.py`` against
   the unsharded kernel; a full-width tick through
   ``decode_attention_sharded`` on an NCCL group of one rank against the
   unsharded tick; then two gloo ranks on this card (subprocesses; NCCL
   refuses two ranks on one card), qwen2-0.5b at full width and depth
   with the 32k cache split in two, 16 greedy ticks per scheme: logits
   against the same ticks unsharded, the crossing row's KV on the right
   rank, 24 / 48 all-reduces a tick (CostCounter), each rank's wall and
   busy (gloo's host trip included: not a multi-card number).
11. Slice 8b-1, the sharded trainer (``slice8b1_phase``, the "torch"
   plan, set up as ``launch/train.py`` sets it up): a full-width
   gradient leaf (qwen2-0.5b's stacked w_gate) through the int8-EF
   quantizer on the card bitwise the CPU's; 3 steps of qwen2-0.5b at
   full width and depth (8 x 512) through the sharded step on an NCCL
   world of one rank against the unsharded step; then two gloo ranks on
   this card (subprocesses) at meshes (1, 2), (2, 1) and, with int8-EF,
   (2, 1, 1): losses, grad norms and final params against the unsharded
   run, the collectives of a step (CostCounter) against the count
   derived from the code, each rank's wall, busy and peak memory (gloo's
   host trip included: not a multi-card number); then the CLI itself
   (``python -m repro_torch.launch.train --devices 2 --backend gloo``)
   preempted by SIGTERM at ``--mesh 1x2`` and resumed from its
   checkpoint at ``--mesh 2x1``, its losses against the unsharded run.
12. Slice 8b-2 (``slice8b2_phase``, the "torch" plan): AM, GPipe over
   ``pod`` (``distributed/pipeline.py``) with qwen2-0.5b's 24 layers as
   two stages of 12 on two gloo ranks sharing this card, 4 microbatches of
   2 x 512, the LM loss's backward pass: outputs, loss and every
   gradient leaf bit for bit the unpipelined stack's; AN / AN′ / AO,
   one dbrx-132b layer at its published widths at (data, model) = (2, 1)
   with each rank routing its own group (the JAX package's
   ``_moe_block_manual``) and one group over both ranks (its fallback),
   and (1, 2) with the experts' F over ``model``: loss and each leaf's
   gradient against the one-rank run, the routing choices that differ
   counted; AP / AQ, whisper-tiny's 3 steps at (1, 2) and (2, 1, 1) with
   int8-EF against the one-rank run; the collectives of each run
   (CostCounter) against the count derived from the code, each rank's
   wall, busy and peak memory.
13. Slice 8b-3a (``slice8b3_phase``, the "torch" plan): the recurrent
   families on a mesh, rwkv6-1.6b and hymba-1.5b at their published
   widths and FAMILY_LAYERS' depth in f32, 2 steps of 8 x 512 on two
   gloo ranks sharing this card: AR / AT at (data, model) = (1, 2), tensor-parallel
   (RWKV6's WKV heads, Hymba's SSM heads each rank's own; Hymba's 25 / 5
   attention heads gathered), AS / AU at (pod, data, model) = (2, 1, 1)
   with int8-EF: losses, grad norms and final params against the
   one-card run under phase 11's bounds, AR / AT's first gradients of
   the replicated leaves each rank cuts to its heads (and Hymba's w_bc)
   against the one-card run's, the collectives of a step against the
   count derived from the code, each rank's wall, busy and peak memory.
14. Slice 8b-3b (``slice8b3b_phase``): the mesh dry run's CLI in process
   (``--mesh single``, qwen2-0.5b x decode_32k on the CPU: this torch has
   the fake process group); then tensor parallelism in the decode tick,
   two gloo ranks sharing this card at (data, model) = (1, 2) through
   ``serving/sharded.py`` on the "cuda" plan: AV qwen2-0.5b (published
   widths, 4 layers) and AW dbrx-132b (1 of 40 layers, the experts' F
   cut), AH's 4 rows of a 32,768-position cache, 16 greedy ticks a
   scheme: rows 3-4's shard partials and rows 1-2 on the cut weights;
   logits against the same ticks unsharded (AW with rank 0's expert
   choices forced), tokens equal or near ties, the collectives of a tick
   against the count derived from the code, each rank's wall, busy and
   peak memory.
15. The examples (``examples/*_torch.py``) at full width in three
   subprocesses at once; fails if any exits non-zero.
16. Prints the card's name and power limit, one JSON line describing every
   kernel, and as its last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.
Exits non-zero, printing no result line, without CUDA, outside the repo,
or when any check fails. Long output goes to ``chiprun_out/``; each
phase's end, with the seconds since the start, also goes to stderr.
"""
import argparse
import gc
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"
# compiled bytecode of what the run imports, in the checkout's build dir
PYCACHE = SRC / "repro_torch" / "build" / "pycache"

ARCH = "qwen2-0.5b"
MOE_ARCH = "dbrx-132b"                # runs X to X‴ and the D = 128 lines
MOE_LAYERS = 4                        # of its 40: 28.6 GB of bf16 weights
TOL = dict(atol=3e-2, rtol=3e-2)      # GEMMs: outputs ~1, bf16 ~2^-8 relative
# attention: per output row (one head's D values), max |error| must stay
# under ATTN_REL x the row's RMS. bf16 output rounding is 2^-8 of an element
# (about 0.01 x RMS at the row's largest element); dropping one 32-key chunk
# of a 1024-long decode row moves the row by several times the limit.
ATTN_REL = 0.1
LOGITS_TOL = 0.25                     # max |Δlogits|, bf16 through 24 layers
REPS = 25

REPLACES = {
    "gemv": "src/repro/kernels/gemv.py:61",
    "flat_gemm": "src/repro/kernels/flat_gemm.py:117",
    "decode_attention_unified_max":
        "src/repro/kernels/decode_attention.py:91",
    "decode_attention_sync": "src/repro/kernels/decode_attention.py:487",
    "flash_prefill_unified_max": "src/repro/kernels/flash_prefill.py:134",
    "flash_prefill_sync": "src/repro/kernels/flash_prefill.py:134",
    "paged_decode_attention_unified_max":
        "src/repro/kernels/decode_attention.py:289",
    "paged_decode_attention_sync": "src/repro/kernels/decode_attention.py:422",
    "paged_chunk_attention_unified_max":
        "src/repro/kernels/chunk_attention.py:235",
    "paged_chunk_attention_sync": "src/repro/kernels/chunk_attention.py:294",
    "fused_ffn_up": "src/repro/kernels/fused_ffn.py:78",
    "grouped_paged_decode_attention_unified_max":
        "src/repro/kernels/group_attention.py:199",
    "decode_ingest_fused": "src/repro/kernels/decode_fuse.py:138",
    "oproj_residual_fused": "src/repro/kernels/decode_fuse.py:299",
    "ffn_norm_fused": "src/repro/kernels/decode_fuse.py:412",
    # the quantized bodies (int8 / fp8 weights, one counter each)
    "gemv_quant": "src/repro/kernels/gemv.py:41",
    "flat_gemm_quant": "src/repro/kernels/flat_gemm.py:94",
    "fused_ffn_up_quant": "src/repro/kernels/fused_ffn.py:37",
    "decode_ingest_fused_quant": "src/repro/kernels/decode_fuse.py:67",
    "oproj_residual_fused_quant": "src/repro/kernels/decode_fuse.py:267",
    "ffn_norm_fused_quant": "src/repro/kernels/decode_fuse.py:362",
    # the quantized KV bodies (int8 / fp8 pages, one counter each)
    "paged_decode_attention_unified_max_quant":
        "src/repro/kernels/decode_attention.py:226",
    "paged_decode_attention_sync_quant":
        "src/repro/kernels/decode_attention.py:369",
    "paged_chunk_attention_unified_max_quant":
        "src/repro/kernels/chunk_attention.py:57",
    "paged_chunk_attention_sync_quant":
        "src/repro/kernels/chunk_attention.py:119",
    "grouped_paged_decode_attention_unified_max_quant":
        "src/repro/kernels/group_attention.py:60",
    "grouped_decode_stage2_quant": "src/repro/kernels/group_attention.py:129",
    # rows 3 and 4 as shard partials (slice 8a's sequence split)
    "decode_attention_partial_unified_max":
        "src/repro/kernels/decode_attention.py:91",
    "decode_attention_partial_sync": "src/repro/kernels/decode_attention.py:487",
}
SOURCES = {
    "gemv": "src/repro_torch/csrc/gemv.cu",
    "flat_gemm": "src/repro_torch/csrc/flat_gemm.cu",
    "decode_attention_unified_max": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_sync": "src/repro_torch/csrc/decode_attention.cu",
    "flash_prefill_unified_max": "src/repro_torch/csrc/flash_prefill.cu",
    "flash_prefill_sync": "src/repro_torch/csrc/flash_prefill.cu",
    "paged_decode_attention_unified_max":
        "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention_sync": "src/repro_torch/csrc/decode_attention.cu",
    "paged_chunk_attention_unified_max":
        "src/repro_torch/csrc/chunk_attention.cu",
    "paged_chunk_attention_sync": "src/repro_torch/csrc/chunk_attention.cu",
    "fused_ffn_up": "src/repro_torch/csrc/fused_ffn.cu",
    "grouped_paged_decode_attention_unified_max":
        "src/repro_torch/csrc/group_attention.cu",
    "decode_ingest_fused": "src/repro_torch/csrc/decode_fuse.cu",
    "oproj_residual_fused": "src/repro_torch/csrc/decode_fuse.cu",
    "ffn_norm_fused": "src/repro_torch/csrc/decode_fuse.cu",
    "gemv_quant": "src/repro_torch/csrc/gemv.cu",
    "flat_gemm_quant": "src/repro_torch/csrc/flat_gemm.cu",
    "fused_ffn_up_quant": "src/repro_torch/csrc/fused_ffn.cu",
    "decode_ingest_fused_quant": "src/repro_torch/csrc/decode_fuse.cu",
    "oproj_residual_fused_quant": "src/repro_torch/csrc/decode_fuse.cu",
    "ffn_norm_fused_quant": "src/repro_torch/csrc/decode_fuse.cu",
    "paged_decode_attention_unified_max_quant":
        "src/repro_torch/csrc/decode_attention.cu",
    "paged_decode_attention_sync_quant":
        "src/repro_torch/csrc/decode_attention.cu",
    "paged_chunk_attention_unified_max_quant":
        "src/repro_torch/csrc/chunk_attention.cu",
    "paged_chunk_attention_sync_quant":
        "src/repro_torch/csrc/chunk_attention.cu",
    "grouped_paged_decode_attention_unified_max_quant":
        "src/repro_torch/csrc/group_attention.cu",
    "grouped_decode_stage2_quant": "src/repro_torch/csrc/group_attention.cu",
    "decode_attention_partial_unified_max":
        "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_partial_sync": "src/repro_torch/csrc/decode_attention.cu",
}
PAGE = 64                             # page size of every paged run
# phases 3-5 serve qwen2-0.5b at its full width and SERVE_LAYERS of its 24
# layers: the eager tick is host bound, about 2 ms a layer, and at full
# depth the smoke came too close to its time limit (8 layers once slice
# 8b-1's phase 11 came, 4 once slice 8b-2's phase 12 came; the trainer,
# decode_32k, slices 8a and 8b-1 and the pipeline keep the full depth; so
# do the cost phase's fixed costs and the tune, which the committed
# constants and plan come from)
SERVE_LAYERS = 4
# a layer's stored GEMM weights of qwen2-0.5b, wq, wk, wv, wo, w_gate, w_up,
# w_down: 14,909,440 weights at 2 bytes (bf16), or at 1 byte plus 12,672 f32
# steps (int8, fp8); one decode tick reads every layer's once
WEIGHT_BYTES_PER_LAYER = {"bf16": 29_818_880, "int8": 14_960_128,
                          "fp8": 14_960_128}
# a 64-row page's K+V slab of qwen2-0.5b in one layer: 2 x 64 x 2 kv heads x
# 64 dims at 2 bytes (bf16), or at 1 byte plus 2 x 2 f32 steps (int8, fp8)
KV_PAGE_BYTES_PER_LAYER = {"bf16": 32_768, "int8": 16_400, "fp8": 16_400}
# the recurrent families' depth in phase 7 (whisper-tiny keeps its 4 + 4)
FAMILY_LAYERS = {"rwkv6-1.6b": 4, "hymba-1.5b": 4}


def serve_config():
    """qwen2-0.5b at its published widths and SERVE_LAYERS layers."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(ARCH), num_layers=SERVE_LAYERS)
# the attention kernels of the bf16 and of the quantized KV bodies, by
# counter name: a quantized-KV run must launch none of the first
BF16_ATTENTION = ("decode_attention_unified_max", "decode_attention_sync",
                  "paged_decode_attention_unified_max",
                  "paged_decode_attention_sync",
                  "paged_chunk_attention_unified_max",
                  "paged_chunk_attention_sync",
                  "grouped_paged_decode_attention_unified_max",
                  "grouped_decode_stage2", "flash_prefill_unified_max",
                  "flash_prefill_sync")
KV_QUANT = ("paged_decode_attention_unified_max_quant",
            "paged_decode_attention_sync_quant",
            "paged_chunk_attention_unified_max_quant",
            "paged_chunk_attention_sync_quant",
            "grouped_paged_decode_attention_unified_max_quant",
            "grouped_decode_stage2_quant")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    every timed launch (the serving path finds weights and KV cold). A
    device-side sleep queued first lets the host enqueue every repetition
    before the card reaches them, so host launch overhead stays outside
    the events and the numbers are device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8,
                                 device="cuda")

    def ms(self, fn, reps=REPS):
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        torch.cuda._sleep(100_000_000)      # ~50 ms of device cycles
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in times)


def bound_ms(nbytes, flops, spec):
    """The least time, in ms, the card takes to move ``nbytes`` and do
    ``flops``, and which of the two bounds it: ``roofline.bound``, the
    dry run's definition of the compute and memory terms."""
    from repro_torch.analysis import roofline
    s, by = roofline.bound(nbytes, flops, spec)
    return 1e3 * s, by


def attn_close(got, want):
    """Per output row (one head's D values): max |error| under ATTN_REL x
    the row's RMS."""
    err = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().pow(2).mean(-1).sqrt()
    ratio = (err / rms.clamp_min(1e-30)).max().item()
    return (bool((err <= ATTN_REL * rms).all()),
            f"tol per row {ATTN_REL} x RMS(row); worst {ratio:.4f} x RMS")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def paged_layout(torch, gen, caches, n_valid, spare=8):
    """Lay dense (B, S, HK, D) caches into pools of shuffled PAGE-row
    pages, ``spare`` more than the rows need; every pool row that holds
    no valid position keeps random data. Returns the pools, the (B, S //
    PAGE) int32 block tables (sentinel NP past each row's pages) and the
    (NP, PAGE) mask of rows that hold a position below ``n_valid[b]``."""
    b, s = caches[0].shape[:2]
    dev = caches[0].device
    need = [-(-int(n) // PAGE) for n in n_valid.tolist()]
    num_pages = sum(need) + spare
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    bt = torch.full((b, s // PAGE), num_pages, dtype=torch.int32, device=dev)
    pools = [torch.randn((num_pages, PAGE) + tuple(c.shape[2:]),
                         generator=gen, device=dev).to(c.dtype)
             for c in caches]
    live = torch.zeros((num_pages, PAGE), dtype=torch.bool, device=dev)
    lo = 0
    for i, n in enumerate(need):
        pages = perm[lo:lo + n]
        lo += n
        bt[i, :n] = pages.int()
        for pool, cache in zip(pools, caches):
            pool[pages] = cache[i, :n * PAGE].reshape(n, PAGE,
                                                      *cache.shape[2:])
        live[pages] = (torch.arange(n * PAGE, device=dev)
                       < int(n_valid[i])).reshape(n, PAGE)
    return pools, bt, live


def same_bits(torch, *pairs):
    """Every (a, b) pair holds the same bits (NaN and inf included, which
    an overflowing unified-max output may legitimately hold)."""
    return all(a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
        for a, b in pairs)


def poisoned(torch, pools, live):
    """The pools with NaN in every row that holds no valid position: a
    kernel that reads only what holds data gives the same bits on both."""
    keep = live[:, :, None, None]
    return [torch.where(keep, p, torch.full_like(p, float("nan")))
            for p in pools]


def kernel_phase(torch, timer, rows, log, slice7b_only=False):
    import torch.nn.functional as F

    from repro_torch import hardware
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_fuse as dfu
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import group_attention as ga
    from repro_torch.kernels import ops
    from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_plain
    from repro_torch.kernels.gemv import gemv, gemv_plain
    from repro_torch.kernels import quant
    from repro_torch.kernels.ref import gather_paged_kv
    from repro_torch.models import wquant
    from repro_torch import configs

    spec = hardware.DEFAULT
    cfg = configs.get(ARCH)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    vp = -(-cfg.vocab_size // 256) * 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    def gemm_close(got, want):
        return (torch.allclose(got.float(), want.float(), **TOL),
                f"tol atol={TOL['atol']} rtol={TOL['rtol']}")

    def record(name, case, got, want, kern, plain, lib, nbytes, flops,
               primary, close, twin=None, slot=None):
        """Check and time one kernel case; ``twin`` times the bf16 kernel
        on the same shape beside a quantized variant, and ``slot`` keeps
        a primary case under that key of the row (the fp8 codes beside
        the int8 ones)."""
        err = (got.float() - want.float()).abs().max().item()
        ok, tol = close(got, want)
        b_ms, b_by = bound_ms(nbytes, flops, spec)
        k_ms, p_ms = timer.ms(kern), timer.ms(plain)
        l_ms = timer.ms(lib) if lib is not None else None
        t_ms = timer.ms(twin) if twin is not None else None
        line = (f"kernel {name:30s} {case:34s} max_abs_err={err:.3e} "
                f"({tol}) "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms={'n/a' if l_ms is None else f'{l_ms:.4f}'} "
                f"bound_ms={b_ms:.4f} ({b_by}) "
                + ("" if t_ms is None else f"bf16_kernel_ms={t_ms:.4f} ")
                + f"{'ok' if ok else 'MISMATCH'}")
        log(line)
        check(ok, f"{name} {case}: kernel disagrees with its plain version")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if primary:
            target = row if slot is None else row.setdefault(slot, {})
            target.update(case=case, ms=k_ms, plain_ms=p_ms,
                          library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
            if t_ms is not None:
                target["bf16_ms"] = t_ms

    if slice7b_only:
        slice7b_kernel_checks(torch, randn, record, gemm_close, attn_close,
                              log)
        return

    # -- GEMMs at the decode path's [K, N] shapes --------------------------
    shapes = [(d, d), (d, hk * hd), (d, f), (f, d)]
    embedding = randn(vp, d, scale=d ** -0.5)
    for m, name, fn, plain in ((1, "gemv", gemv, gemv_plain),
                               (4, "flat_gemm", flat_gemm, flat_gemm_plain),
                               (64, "flat_gemm", flat_gemm,
                                flat_gemm_plain)):
        x = randn(m, max(d, f))
        cases = [(f"M={m} K={k} N={n} (K,N)", x[:, :k].contiguous(),
                  randn(k, n, scale=k ** -0.5)) for k, n in shapes]
        cases.append((f"M={m} K={d} N={vp} tied head (N,K)",
                      x[:, :d].contiguous(), embedding.T))
        for case, xx, w in cases:
            k, n = w.shape
            # row 1's lines: the tied head, and (K, N) at N = 128, 4,864;
            # row 2's: the tied head, and gate / up at M = 4
            slot = None
            if m == 1 and "tied" not in case:
                slot = {(d, hk * hd): "n128", (d, f): "n4864"}.get((k, n))
            elif m == 4 and (k, n) == (d, f):
                slot = "n4864"
            primary = "tied head" in case and m <= 4 or slot is not None
            record(name, case, fn(xx, w), plain(xx, w),
                   lambda: fn(xx, w), lambda: plain(xx, w),
                   lambda: torch.matmul(xx, w),
                   2 * (m * k + k * n + m * n), 2 * m * k * n, primary,
                   gemm_close, slot=slot)

    # -- fused FFN-up (row 8) at a decode tick's, a chunk step's and a
    # one-shot prefill's M (4 slots; 4 rows x 64-token chunks; 4 x 256) ----
    for m in (4, 256, 1024):
        x = randn(m, d)
        wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
        record("fused_ffn_up", f"M={m} K={d} N={f} swiglu",
               ff.fused_ffn_up(x, wg, wu), ff.fused_ffn_up_plain(x, wg, wu),
               lambda: ff.fused_ffn_up(x, wg, wu),
               lambda: ff.fused_ffn_up_plain(x, wg, wu),
               lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu),
               2 * (m * d + 2 * d * f + m * f), 4 * m * d * f, True,
               gemm_close, slot=None if m == 4 else f"m{m}")
        got = ff.fused_ffn_up(x, wg, wu, activation="geglu")
        ok, tol = gemm_close(got, ff.fused_ffn_up_plain(
            x, wg, wu, activation="geglu"))
        log(f"kernel fused_ffn_up M={m} geglu: {'ok' if ok else 'MISMATCH'}"
            f" ({tol})")
        check(ok, f"fused_ffn_up M={m} geglu disagrees")

    # -- fused decode stages (rows 12-14) at a decode tick's M (4 slots)
    # and at 1 slot ---------------------------------------------------------
    nq, nk = hq * hd, hk * hd
    wq, wk, wv = (randn(d, n, scale=d ** -0.5) for n in (nq, nk, nk))
    bq, bkb, bv = (randn(n) for n in (nq, nk, nk))
    nscale = (torch.rand(d, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    wo, wd = randn(nq, d, scale=nq ** -0.5), randn(f, d, scale=f ** -0.5)
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    # library yardsticks: one GEMM over the concatenated QKV weight (the
    # copy made once, outside the timing), rope as torch ops
    wqkv, bqkv = torch.cat([wq, wk, wv], 1), torch.cat([bq, bkb, bv])
    half = hd // 2
    inv_freq = cfg.rope_theta ** (
        -torch.arange(half, device=dev, dtype=torch.float32) / half)
    ikw = dict(num_heads=hq, num_kv_heads=hk, head_dim=hd,
               rope_theta=cfg.rope_theta, bq=bq, bk=bkb, bv=bv)

    def lib_ingest(x, pos):
        h = F.rms_norm(x, (d,), nscale, eps=1e-6)
        qkv = torch.addmm(bqkv, h, wqkv).view(x.shape[0], -1, hd)
        ang = pos.float()[:, None, None] * inv_freq
        c, s = ang.cos(), ang.sin()
        x1, x2 = qkv[:, :hq + hk, :half], qkv[:, :hq + hk, half:]
        rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
        return rot.to(qkv.dtype), qkv[:, hq + hk:]

    def lib_ffn(x):
        h = F.rms_norm(x, (d,), nscale, eps=1e-6)
        return F.silu(torch.matmul(h, wg)) * torch.matmul(h, wu)

    for m in (4, 1):
        x = randn(m, d)
        pos = torch.randint(0, 1024, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        n_all = nq + 2 * nk
        record("decode_ingest_fused",
               f"M={m} K={d} N={nq}+{nk}+{nk} bias rope",
               torch.cat(dfu.decode_ingest_fused(x, nscale, wq, wk, wv, pos,
                                                 **ikw), 1),
               torch.cat(dfu.decode_ingest_plain(x, nscale, wq, wk, wv, pos,
                                                 **ikw), 1),
               lambda: dfu.decode_ingest_fused(x, nscale, wq, wk, wv, pos,
                                               **ikw),
               lambda: dfu.decode_ingest_plain(x, nscale, wq, wk, wv, pos,
                                               **ikw),
               lambda: lib_ingest(x, pos),
               2 * (m * d + d + d * n_all + n_all + m * n_all) + 4 * m,
               2 * m * d * n_all, m == 4, gemm_close)
        for k, w, tag in ((nq, wo, "o_proj"), (f, wd, "down")):
            o, res = randn(m, k), randn(m, d)
            record("oproj_residual_fused", f"M={m} K={k} N={d} {tag}",
                   dfu.oproj_residual_fused(o, w, res),
                   dfu.oproj_residual_plain(o, w, res),
                   lambda: dfu.oproj_residual_fused(o, w, res),
                   lambda: dfu.oproj_residual_plain(o, w, res),
                   lambda: torch.addmm(res, o, w),
                   2 * (m * k + k * d + 2 * m * d), 2 * m * k * d,
                   m == 4 and tag == "down", gemm_close)
        record("ffn_norm_fused", f"M={m} K={d} N={f} swiglu",
               dfu.ffn_norm_fused(x, nscale, wg, wu),
               dfu.ffn_norm_plain(x, nscale, wg, wu),
               lambda: dfu.ffn_norm_fused(x, nscale, wg, wu),
               lambda: dfu.ffn_norm_plain(x, nscale, wg, wu),
               lambda: lib_ffn(x),
               2 * (m * d + d + 2 * d * f + m * f), 4 * m * d * f, m == 4,
               gemm_close)
        got = dfu.ffn_norm_fused(x, nscale, wg, wu, activation="geglu")
        ok, tol = gemm_close(got, dfu.ffn_norm_plain(
            x, nscale, wg, wu, activation="geglu"))
        log(f"kernel ffn_norm_fused M={m} geglu: {'ok' if ok else 'MISMATCH'}"
            f" ({tol})")
        check(ok, f"ffn_norm_fused M={m} geglu disagrees")

    # -- quantized weights: rows 1, 2, 8 and 12-14 with int8 / fp8 codes,
    # at the layer GEMMs' shapes (the tied head never quantizes) ----------
    def q_bytes(m, k, n):
        """x, the codes, the steps and the output, each moved once."""
        return 2 * m * k + k * n + 4 * n + 2 * m * n

    bf = torch.bfloat16
    for qs in (quant.INT8, quant.FP8):
        slot = None if qs.is_int else "fp8"

        def Q(w):
            q = wquant.quantize_weight(w, qs)
            return q["codes"], q["scale"]

        def qrec(name, case, got, want, kern, plain, lib, twin, nbytes,
                 flops, primary, line=None):
            """``line`` keys a second line of the row (fp8's beside
            int8's: "fp8 <line>")."""
            key = slot if line is None else (
                line if qs.is_int else f"fp8 {line}")
            record(name, f"{qs.name} {case}", got, want, kern, plain, lib,
                   nbytes, flops, primary, gemm_close, twin=twin, slot=key)

        for m, name, fn, plain in (
                (1, "gemv_quant", gemv, gemv_plain),
                (4, "flat_gemm_quant", flat_gemm, flat_gemm_plain),
                (64, "flat_gemm_quant", flat_gemm, flat_gemm_plain)):
            x = randn(m, max(d, f))
            for k, n in shapes:
                xx = x[:, :k].contiguous()
                w = randn(k, n, scale=k ** -0.5)
                c, sc = Q(w)
                # row 2's second line: gate / up at M = 4
                gate_up = m == 4 and (k, n) == (d, f)
                qrec(name, f"M={m} K={k} N={n}",
                     fn(xx, c, w_scale=sc), plain(xx, c, w_scale=sc),
                     lambda: fn(xx, c, w_scale=sc),
                     lambda: plain(xx, c, w_scale=sc),
                     lambda: (torch.matmul(xx, c.to(bf)) * sc).to(bf),
                     lambda: fn(xx, w), q_bytes(m, k, n), 2 * m * k * n,
                     m <= 4 and (k, n) == (f, d) or gate_up,
                     line="n4864" if gate_up else None)
        for m in (4, 256):
            x = randn(m, d)
            gw, uw = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
            (cg, sg), (cu, su) = Q(gw), Q(uw)
            kw = dict(wg_scale=sg, wu_scale=su)
            qrec("fused_ffn_up_quant", f"M={m} K={d} N={f} swiglu",
                 ff.fused_ffn_up(x, cg, cu, **kw),
                 ff.fused_ffn_up_plain(x, cg, cu, **kw),
                 lambda: ff.fused_ffn_up(x, cg, cu, **kw),
                 lambda: ff.fused_ffn_up_plain(x, cg, cu, **kw),
                 lambda: (F.silu(torch.matmul(x, cg.to(bf)) * sg)
                          * (torch.matmul(x, cu.to(bf)) * su)).to(bf),
                 lambda: ff.fused_ffn_up(x, gw, uw),
                 2 * m * d + 2 * q_bytes(0, d, f) + 2 * m * f,
                 4 * m * d * f, True, line=None if m == 4 else f"m{m}")
            got = ff.fused_ffn_up(x, cg, cu, activation="geglu", **kw)
            ok, tol = gemm_close(got, ff.fused_ffn_up_plain(
                x, cg, cu, activation="geglu", **kw))
            log(f"kernel fused_ffn_up_quant {qs.name} M={m} geglu: "
                f"{'ok' if ok else 'MISMATCH'} ({tol})")
            check(ok, f"fused_ffn_up_quant {qs.name} M={m} geglu disagrees")
        (cq, sq), (ck, sk), (cv, sv) = Q(wq), Q(wk), Q(wv)
        (cgn, sgn), (cun, sun) = Q(wg), Q(wu)
        (co, so), (cd, sd) = Q(wo), Q(wd)
        qkw = dict(ikw, wq_scale=sq, wk_scale=sk, wv_scale=sv)
        cqkv, sqkv = torch.cat([cq, ck, cv], 1), torch.cat([sq, sk, sv])

        def lib_ingest_q(x, pos):
            h = F.rms_norm(x, (d,), nscale, eps=1e-6)
            qkv = ((torch.matmul(h, cqkv.to(bf)) * sqkv).to(bf) + bqkv).view(
                x.shape[0], -1, hd)
            ang = pos.float()[:, None, None] * inv_freq
            c, s = ang.cos(), ang.sin()
            x1, x2 = qkv[:, :hq + hk, :half], qkv[:, :hq + hk, half:]
            rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
            return rot.to(qkv.dtype), qkv[:, hq + hk:]

        def lib_ffn_q(x):
            h = F.rms_norm(x, (d,), nscale, eps=1e-6)
            return (F.silu(torch.matmul(h, cgn.to(bf)) * sgn)
                    * (torch.matmul(h, cun.to(bf)) * sun)).to(bf)

        for m in (4, 1):
            x = randn(m, d)
            pos = torch.randint(0, 1024, (m,), generator=gen, device=dev,
                                dtype=torch.int32)
            n_all = nq + 2 * nk
            qrec("decode_ingest_fused_quant",
                 f"M={m} K={d} N={nq}+{nk}+{nk} bias rope",
                 torch.cat(dfu.decode_ingest_fused(x, nscale, cq, ck, cv, pos,
                                                   **qkw), 1),
                 torch.cat(dfu.decode_ingest_plain(x, nscale, cq, ck, cv, pos,
                                                   **qkw), 1),
                 lambda: dfu.decode_ingest_fused(x, nscale, cq, ck, cv, pos,
                                                 **qkw),
                 lambda: dfu.decode_ingest_plain(x, nscale, cq, ck, cv, pos,
                                                 **qkw),
                 lambda: lib_ingest_q(x, pos),
                 lambda: dfu.decode_ingest_fused(x, nscale, wq, wk, wv, pos,
                                                 **ikw),
                 q_bytes(m, d, n_all) + 2 * (d + n_all) + 4 * m,
                 2 * m * d * n_all, m == 4)
            for k, c, sc, w, tag in ((nq, co, so, wo, "o_proj"),
                                     (f, cd, sd, wd, "down")):
                o, res = randn(m, k), randn(m, d)
                qrec("oproj_residual_fused_quant", f"M={m} K={k} N={d} {tag}",
                     dfu.oproj_residual_fused(o, c, res, w_scale=sc),
                     dfu.oproj_residual_plain(o, c, res, w_scale=sc),
                     lambda: dfu.oproj_residual_fused(o, c, res, w_scale=sc),
                     lambda: dfu.oproj_residual_plain(o, c, res, w_scale=sc),
                     lambda: res + (torch.matmul(o, c.to(bf)) * sc).to(bf),
                     lambda: dfu.oproj_residual_fused(o, w, res),
                     q_bytes(m, k, d) + 2 * m * d, 2 * m * k * d,
                     m == 4 and tag == "down")
            fkw = dict(wg_scale=sgn, wu_scale=sun)
            qrec("ffn_norm_fused_quant", f"M={m} K={d} N={f} swiglu",
                 dfu.ffn_norm_fused(x, nscale, cgn, cun, **fkw),
                 dfu.ffn_norm_plain(x, nscale, cgn, cun, **fkw),
                 lambda: dfu.ffn_norm_fused(x, nscale, cgn, cun, **fkw),
                 lambda: dfu.ffn_norm_plain(x, nscale, cgn, cun, **fkw),
                 lambda: lib_ffn_q(x),
                 lambda: dfu.ffn_norm_fused(x, nscale, wg, wu),
                 2 * m * d + 2 * d + 2 * q_bytes(0, d, f) + 2 * m * f,
                 4 * m * d * f, m == 4)
            got = dfu.ffn_norm_fused(x, nscale, cgn, cun, activation="geglu",
                                     **fkw)
            ok, tol = gemm_close(got, dfu.ffn_norm_plain(
                x, nscale, cgn, cun, activation="geglu", **fkw))
            log(f"kernel ffn_norm_fused_quant {qs.name} M={m} geglu: "
                f"{'ok' if ok else 'MISMATCH'} ({tol})")
            check(ok, f"ffn_norm_fused_quant {qs.name} M={m} geglu disagrees")
        # quantize-at-load on the card: bitwise the CPU's codes and steps
        on_card = wquant.quantize_weight(wd, qs)
        on_cpu = wquant.quantize_weight(wd.cpu(), qs)
        same = {key: same_bits(torch, (on_card[key].cpu(), on_cpu[key]))
                for key in ("codes", "scale")}
        log(f"wquant {qs.name}: a full-width ({f}, {d}) weight quantized on "
            f"the card bitwise the CPU's: codes {same['codes']}, steps "
            f"{same['scale']}")
        same = all(same.values())
        check(same, f"wquant {qs.name}: the card's codes differ from the "
              "CPU's")

    # -- decode attention (B=4 slots, max_seq 1024, ragged) ----------------
    b, s_max = 4, 1024
    lengths = torch.tensor([1024, 517, 64, 3], dtype=torch.int32,
                           device=dev)
    n_valid = int(lengths.sum())
    kc = randn(b, s_max, hk, hd)
    vc = randn(b, s_max, hk, hd)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    # library yardstick: SDPA over GQA-expanded (B, HQ, S, D) views + mask
    ke = kt.repeat_interleave(hq // hk, dim=1)
    ve = vt.repeat_interleave(hq // hk, dim=1)
    mask = (torch.arange(s_max, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    attn_bytes = 2 * (2 * b * hq * hd + 2 * n_valid * hk * hd) + 4 * b * hk
    attn_flops = 4 * n_valid * hq * hd
    phi = cfg.softmax_phi
    # rows 5-6: the same KV in shuffled pages of a larger pool; the
    # kernel also reads each row's block table once
    (kp, vp), bt, live = paged_layout(torch, gen, (kc, vc), lengths)
    kpn, vpn = poisoned(torch, (kp, vp), live)
    paged_bytes = attn_bytes + 4 * bt.numel()
    log(f"paged decode pool: {kp.shape[0]} pages of {PAGE}, tables "
        f"{tuple(bt.shape)}")
    for scale_q, tag in ((1.0, "B=4 S=1024 ragged"),
                         (20.0, "B=4 S=1024 ragged, s-phi>40")):
        q = randn(b, hq, hd, scale=scale_q)
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(q4, ke, ve,
                                                     attn_mask=mask)
        out, stat = da.decode_attention_unified_max(q, kt, vt, lengths,
                                                    phi=phi.phi)
        want, want_stat = da.decode_attention_unified_max_plain(
            q, kt, vt, lengths, phi=phi.phi)
        serr = (stat - want_stat).abs().max().item()
        log(f"kernel decode_attention_unified_max stat max_abs_err="
            f"{serr:.3e} max_stat={stat.max().item():.2f}")
        check(serr <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              "decode unified-max stat disagrees")
        overflow = scale_q > 1.0
        if not overflow:
            record("decode_attention_unified_max", tag, out, want,
                   lambda: da.decode_attention_unified_max(
                       q, kt, vt, lengths, phi=phi.phi),
                   lambda: da.decode_attention_unified_max_plain(
                       q, kt, vt, lengths, phi=phi.phi),
                   lib, attn_bytes, attn_flops, True, attn_close)
        want_sync = da.decode_attention_sync_plain(q, kt, vt, lengths)
        record("decode_attention_sync", tag,
               da.decode_attention_sync(q, kt, vt, lengths), want_sync,
               lambda: da.decode_attention_sync(q, kt, vt, lengths),
               lambda: da.decode_attention_sync_plain(q, kt, vt, lengths),
               lib, attn_bytes, attn_flops, not overflow, attn_close)
        # the front door: unified-max, then the flag-gated recompute
        got = ops.attention_decode(q, kc, vc, lengths, phi_cfg=phi,
                                   plan=DEFAULT_PLAN)
        check(bool((stat > phi.band[1]).any()) == overflow,
              f"decode overflow flag wrong for {tag}")
        ref = want_sync if overflow else want
        err = (got.float() - ref.float()).abs().max().item()
        ok, tol = attn_close(got, ref)
        log(f"kernel ops.attention_decode {tag}: recompute="
            f"{overflow} max_abs_err={err:.3e} ({tol})")
        check(ok, f"ops.attention_decode {tag} disagrees")

        # paged decode: one kernel body with the dense one, so bitwise
        ptag = tag.replace("ragged", f"PS={PAGE} ragged shuffled")
        pout, pstat = da.paged_decode_attention_unified_max(
            q, kp, vp, bt, lengths, phi=phi.phi)
        psync = da.paged_decode_attention_sync(q, kp, vp, bt, lengths)
        same = same_bits(torch, (pout, out), (pstat, stat), (
            psync, da.decode_attention_sync(q, kt, vt, lengths)))
        clean = same_bits(
            torch, (da.paged_decode_attention_unified_max(
                q, kpn, vpn, bt, lengths, phi=phi.phi)[0], pout),
            (da.paged_decode_attention_sync(q, kpn, vpn, bt, lengths),
             psync))
        log(f"kernel paged_decode_attention {ptag}: bitwise equal to the "
            f"dense kernel {same}; unchanged with NaN in unread pool rows "
            f"{clean}")
        check(same, f"paged decode {ptag}: not bitwise the dense kernel")
        check(clean, f"paged decode {ptag}: reads pool rows past lengths")
        pwant, pwant_stat = da.paged_decode_attention_unified_max_plain(
            q, kp, vp, bt, lengths, phi=phi.phi)
        check((pstat - pwant_stat).abs().max().item()
              <= 1e-2 * max(1.0, pwant_stat.abs().max().item()),
              "paged decode unified-max stat disagrees")
        if not overflow:
            record("paged_decode_attention_unified_max", ptag, pout, pwant,
                   lambda: da.paged_decode_attention_unified_max(
                       q, kp, vp, bt, lengths, phi=phi.phi),
                   lambda: da.paged_decode_attention_unified_max_plain(
                       q, kp, vp, bt, lengths, phi=phi.phi),
                   lib, paged_bytes, attn_flops, True, attn_close)
        pwant_sync = da.paged_decode_attention_sync_plain(q, kp, vp, bt,
                                                          lengths)
        record("paged_decode_attention_sync", ptag, psync, pwant_sync,
               lambda: da.paged_decode_attention_sync(q, kp, vp, bt,
                                                      lengths),
               lambda: da.paged_decode_attention_sync_plain(q, kp, vp, bt,
                                                            lengths),
               lib, paged_bytes, attn_flops, not overflow, attn_close)
        got = ops.attention_decode_paged(q, kp, vp, bt, lengths,
                                         phi_cfg=phi, plan=DEFAULT_PLAN)
        ref = pwant_sync if overflow else pwant
        err = (got.float() - ref.float()).abs().max().item()
        ok, tol = attn_close(got, ref)
        log(f"kernel ops.attention_decode_paged {ptag}: recompute="
            f"{overflow} max_abs_err={err:.3e} ({tol})")
        check(ok, f"ops.attention_decode_paged {ptag} disagrees")

    # -- grouped prefix-shared decode (row 11): four rows share one
    # 512-token (8-page) prefix, tails to 1024/800/600/520 ------------------
    glens = torch.tensor([1024, 800, 600, 520], dtype=torch.int32,
                         device=dev)
    plen = 512
    kp, vp, bt, live, groups = grouped_layout(torch, gen, randn, glens, plen,
                                              s_max, hk, hd)
    num_pages = kp.shape[0]
    kpn, vpn = poisoned(torch, (kp, vp), live)
    kd = gather_paged_kv(kp, bt).transpose(1, 2)
    vd = gather_paged_kv(vp, bt).transpose(1, 2)
    ke = kd.repeat_interleave(hq // hk, dim=1)
    ve = vd.repeat_interleave(hq // hk, dim=1)
    gmask = (torch.arange(s_max, device=dev)[None, :] < glens[:, None])[
        :, None, None, :]
    n_keys = int(glens.sum())
    n_read = plen + int((glens - plen).sum())      # the prefix once
    tables_bytes = 4 * (bt.numel() + sum(t.numel() for t in groups))
    g_bytes = (2 * (2 * b * hq * hd + 2 * n_read * hk * hd) + 4 * b * hk
               + tables_bytes)
    p_bytes = (2 * (2 * b * hq * hd + 2 * n_keys * hk * hd) + 4 * b * hk
               + 4 * bt.numel())
    g_flops = 4 * n_keys * hq * hd
    log(f"grouped decode pool: {num_pages} pages of {PAGE}, one "
        f"{plen}-token prefix shared by {b} rows; bytes to move "
        f"{g_bytes} grouped vs {p_bytes} ungrouped")
    for scale_q, tag in ((1.0, "B=4 PS=64 prefix 512, 1024/800/600/520"),
                         (20.0, "B=4 PS=64 prefix 512, s-phi>40")):
        overflow = scale_q > 1.0
        q = randn(b, hq, hd, scale=scale_q)
        q4 = q[:, :, None, :]
        lib = lambda: F.scaled_dot_product_attention(q4, ke, ve,
                                                     attn_mask=gmask)
        gout, gstat = ga.grouped_paged_decode_attention_unified_max(
            q, kp, vp, bt, glens, groups, phi=phi.phi)
        pout, pstat = da.paged_decode_attention_unified_max(
            q, kp, vp, bt, glens, phi=phi.phi)
        same = same_bits(torch, (gout, pout), (gstat, pstat))
        clean = same_bits(torch, (ga.grouped_paged_decode_attention_unified_max(
            q, kpn, vpn, bt, glens, groups, phi=phi.phi)[0], gout))
        log(f"kernel grouped_paged_decode_attention {tag}: out and stat "
            f"bitwise equal to the paged decode kernel {same}; unchanged "
            f"with NaN in unread pool rows {clean}")
        check(same, f"grouped decode {tag}: not bitwise the paged kernel")
        check(clean, f"grouped decode {tag}: reads pool rows it must not")
        want, want_stat = \
            ga.grouped_paged_decode_attention_unified_max_plain(
                q, kp, vp, bt, glens, groups, phi=phi.phi)
        check((gstat - want_stat).abs().max().item()
              <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              "grouped decode unified-max stat disagrees")
        check(bool((gstat > phi.band[1]).any()) == overflow,
              f"grouped decode overflow flag wrong for {tag}")
        if not overflow:
            # each stage against its plain version on the same inputs:
            # stage 1 on the prefix's whole splits, the ones it writes
            parts = ga.group_prefix_partials(q, kp, vp, groups, phi=phi.phi)
            wparts = ga.group_prefix_plain(q, kp, vp, groups, phi=phi.phi)
            # num is P·V with P rounded to bf16 (the row rule on each
            # split's normalised partial), den the f32 sum of P
            whole = plen // da.SPLIT_KEYS
            (num, den, st), (wnum, wden, wst) = (
                [t[:, :whole] for t in p] for p in (parts, wparts))
            ok1, tol1 = attn_close(num / den[..., None],
                                   wnum / wden[..., None])
            derr = ((den - wden).abs().max() / wden.abs().max()).item()
            serr = (st - wst).abs().max().item()
            tail = ga.group_tail_merge(q, kp, vp, bt, glens, groups, *parts,
                                       phi=phi.phi)[0]
            ok, tol = attn_close(tail, ga.group_tail_plain(
                q, kp, vp, bt, glens, groups, *parts, phi=phi.phi)[0])
            log(f"kernel grouped stages {tag}: stage 1 on the prefix's "
                f"{whole} whole splits: num / den per row "
                f"{'ok' if ok1 else 'MISMATCH'} ({tol1}), den max error "
                f"{derr:.2e} of the largest value, stat {serr:.2e}; stage 2 "
                f"on the same partials {'ok' if ok else 'MISMATCH'} ({tol})")
            check(ok1 and derr <= 1e-4 and serr <= 1e-3,
                  f"grouped stage 1 {tag} disagrees")
            check(ok, f"grouped stage 2 {tag} disagrees")
            record("grouped_paged_decode_attention_unified_max", tag, gout,
                   want, lambda: ga.grouped_paged_decode_attention_unified_max(
                       q, kp, vp, bt, glens, groups, phi=phi.phi),
                   lambda: ga.grouped_paged_decode_attention_unified_max_plain(
                       q, kp, vp, bt, glens, groups, phi=phi.phi),
                   lib, g_bytes, g_flops, True, attn_close)
            p_ms = timer.ms(lambda: da.paged_decode_attention_unified_max(
                q, kp, vp, bt, glens, phi=phi.phi))
            pb_ms, _ = bound_ms(p_bytes, g_flops, spec)
            log(f"kernel paged_decode_attention_unified_max {tag} (the same "
                f"input ungrouped): kernel_ms={p_ms:.4f} "
                f"bound_ms={pb_ms:.4f}")
        got = ops.attention_decode_paged(q, kp, vp, bt, glens, phi_cfg=phi,
                                         plan=DEFAULT_PLAN, groups=groups)
        ref_out = (da.paged_decode_attention_sync_plain(q, kp, vp, bt, glens)
                   if overflow else want)
        err = (got.float() - ref_out.float()).abs().max().item()
        ok, tol = attn_close(got, ref_out)
        log(f"kernel ops.attention_decode_paged grouped {tag}: recompute="
            f"{overflow} max_abs_err={err:.3e} ({tol})")
        check(ok, f"ops.attention_decode_paged grouped {tag} disagrees")

    # -- flash prefill (B=2, causal, Sq=Sk in {64, 512}) ---------------------
    for sq, scale_q in ((64, 1.0), (512, 1.0), (512, 20.0)):
        bp = 2
        q = randn(bp, sq, hq, hd, scale=scale_q)
        k = randn(bp, sq, hk, hd)
        v = randn(bp, sq, hk, hd)
        overflow = scale_q > 1.0
        tag = f"B=2 Sq=Sk={sq} causal" + (", s-phi>40" if overflow else "")
        qe, kx, vx = (q.transpose(1, 2),
                      k.transpose(1, 2).repeat_interleave(hq // hk, dim=1),
                      v.transpose(1, 2).repeat_interleave(hq // hk, dim=1))
        lib = lambda: F.scaled_dot_product_attention(qe, kx, vx,
                                                     is_causal=True)
        pairs = bp * sq * (sq + 1) // 2
        pf_bytes = 2 * (2 * bp * sq * hq * hd + 2 * bp * sq * hk * hd)
        pf_flops = 4 * pairs * hq * hd
        out, stat = fp.flash_prefill_unified_max(q, k, v, phi=phi.phi)
        want, want_stat = fp.flash_prefill_unified_max_plain(q, k, v,
                                                             phi=phi.phi)
        serr = (stat - want_stat).abs().max().item()
        log(f"kernel flash_prefill_unified_max stat max_abs_err={serr:.3e} "
            f"max_stat={stat.max().item():.2f}")
        check(serr <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              "flash prefill unified-max stat disagrees")
        if not overflow:
            record("flash_prefill_unified_max", tag, out, want,
                   lambda: fp.flash_prefill_unified_max(q, k, v,
                                                        phi=phi.phi),
                   lambda: fp.flash_prefill_unified_max_plain(q, k, v,
                                                              phi=phi.phi),
                   lib, pf_bytes, pf_flops, sq == 512, attn_close)
        want_sync = fp.flash_prefill_sync_plain(q, k, v)
        sync = fp.flash_prefill_sync(q, k, v)
        if sq == 512:
            # each batch row run alone gives its rows' bits in the batch
            alone = same_bits(torch, *[
                pair for i in range(bp) for pair in (
                    (fp.flash_prefill_unified_max(
                        q[i:i + 1], k[i:i + 1], v[i:i + 1],
                        phi=phi.phi)[0], out[i:i + 1]),
                    (fp.flash_prefill_sync(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1]), sync[i:i + 1]))])
            log(f"kernel flash_prefill {tag}: each batch row alone (B=1) "
                f"bitwise its rows in the batch {alone}")
            check(alone, f"flash prefill {tag}: a row's bits depend on "
                  "its batch")
        record("flash_prefill_sync", tag, sync,
               want_sync, lambda: fp.flash_prefill_sync(q, k, v),
               lambda: fp.flash_prefill_sync_plain(q, k, v), lib, pf_bytes,
               pf_flops, sq == 512 and not overflow, attn_close)
        got = ops.attention_prefill(q, k, v, phi_cfg=phi, plan=DEFAULT_PLAN)
        check(bool((stat > phi.band[1]).any()) == overflow,
              f"prefill overflow flag wrong for {tag}")
        ref = want_sync if overflow else want
        err = (got.float() - ref.float()).abs().max().item()
        ok, tol = attn_close(got, ref)
        log(f"kernel ops.attention_prefill {tag}: recompute={overflow} "
            f"max_abs_err={err:.3e} ({tol})")
        check(ok, f"ops.attention_prefill {tag} disagrees")

    # -- fused paged chunk attention (rows 9-10): B=4, C=64 ----------------
    c = 64
    before = torch.tensor([960, 453, 0, 128], dtype=torch.int32, device=dev)
    kd, vd = randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)
    (kp, vp), bt, live = paged_layout(torch, gen, (kd, vd), before + c)
    kpn, vpn = poisoned(torch, (kp, vp), live)
    # library yardstick: SDPA over the pre-gathered dense view (the gather
    # itself not timed), GQA-expanded, with the chunk's causal mask
    ke = kd.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    ve = vd.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    qpos = before[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(s_max, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]                   # (B,1,C,S)
    pairs = int(c * before.sum().item() + b * c * (c + 1) // 2)
    ch_bytes = (2 * (2 * b * c * hq * hd + 2 * int((before + c).sum())
                     * hk * hd) + 4 * b * hk + 4 * bt.numel() + 4 * b)
    ch_flops = 4 * pairs * hq * hd
    for scale_q in (1.0, 20.0):
        overflow = scale_q > 1.0
        tag = (f"B=4 C={c} PS={PAGE} lengths 960/453/0/128"
               + (", s-phi>40" if overflow else ""))
        q = randn(b, c, hq, hd, scale=scale_q)
        qe = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qe, ke, ve,
                                                     attn_mask=mask)
        out, stat = ca.paged_chunk_attention_unified_max(q, kp, vp, bt,
                                                         before, phi=phi.phi)
        want, want_stat = ca.paged_chunk_attention_unified_max_plain(
            q, kp, vp, bt, before, phi=phi.phi)
        serr = (stat - want_stat).abs().max().item()
        log(f"kernel paged_chunk_attention_unified_max stat max_abs_err="
            f"{serr:.3e} max_stat={stat.max().item():.2f}")
        check(serr <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              "paged chunk unified-max stat disagrees")
        sync = ca.paged_chunk_attention_sync(q, kp, vp, bt, before)
        clean = same_bits(
            torch, (ca.paged_chunk_attention_unified_max(
                q, kpn, vpn, bt, before, phi=phi.phi)[0], out),
            (ca.paged_chunk_attention_sync(q, kpn, vpn, bt, before), sync))
        log(f"kernel paged_chunk_attention {tag}: unchanged with NaN in "
            f"unread pool rows {clean}")
        check(clean, f"paged chunk {tag}: reads pool rows past the chunk")
        # each sequence run alone gives its rows' bits in the batch
        alone = same_bits(torch, *[
            pair for i in range(b) for pair in (
                (ca.paged_chunk_attention_unified_max(
                    q[i:i + 1], kp, vp, bt[i:i + 1], before[i:i + 1],
                    phi=phi.phi)[0], out[i:i + 1]),
                (ca.paged_chunk_attention_sync(
                    q[i:i + 1], kp, vp, bt[i:i + 1], before[i:i + 1]),
                 sync[i:i + 1]))])
        log(f"kernel paged_chunk_attention {tag}: each sequence alone "
            f"(B=1) bitwise its rows in the batch {alone}")
        check(alone, f"paged chunk {tag}: a row's bits depend on its batch")
        if not overflow:
            record("paged_chunk_attention_unified_max", tag, out, want,
                   lambda: ca.paged_chunk_attention_unified_max(
                       q, kp, vp, bt, before, phi=phi.phi),
                   lambda: ca.paged_chunk_attention_unified_max_plain(
                       q, kp, vp, bt, before, phi=phi.phi),
                   lib, ch_bytes, ch_flops, True, attn_close)
        want_sync = ca.paged_chunk_attention_sync_plain(q, kp, vp, bt,
                                                        before)
        record("paged_chunk_attention_sync", tag, sync, want_sync,
               lambda: ca.paged_chunk_attention_sync(q, kp, vp, bt, before),
               lambda: ca.paged_chunk_attention_sync_plain(q, kp, vp, bt,
                                                           before),
               lib, ch_bytes, ch_flops, not overflow, attn_close)
        got = ops.attention_chunk_paged(q, kp, vp, bt, before, phi_cfg=phi,
                                        plan=DEFAULT_PLAN)
        check(bool((stat > phi.band[1]).any()) == overflow,
              f"chunk overflow flag wrong for {tag}")
        ref = want_sync if overflow else want
        err = (got.float() - ref.float()).abs().max().item()
        ok, tol = attn_close(got, ref)
        log(f"kernel ops.attention_chunk_paged {tag}: recompute={overflow} "
            f"max_abs_err={err:.3e} ({tol})")
        check(ok, f"ops.attention_chunk_paged {tag} disagrees")

    split_k_checks(torch, cfg, randn, record, gemm_close, log)
    wgmma_gemm_checks(torch, randn, record, gemm_close, log)
    gemv_split_checks(torch, cfg, randn, embedding, gemm_close, log)
    ffn_wgmma_checks(torch, randn, record, gemm_close, log)
    ingest_ffn_split_checks(torch, randn, record, gemm_close, log)
    split_kv_checks(torch, cfg, gen, randn, record, attn_close, log)
    decode_split_checks(torch, timer, cfg, gen, randn, record, attn_close,
                        log)
    kv_quant_kernels(torch, cfg, gen, randn, record, attn_close, log)
    dbrx_kernel_checks(torch, randn, record, gemm_close, attn_close, log)
    slice7b_kernel_checks(torch, randn, record, gemm_close, attn_close, log)


# the slice 7b families' GEMM shapes of rows 1 and 2, (K, N, what): the
# widths runs Y, Z, Z′ and AA serve (called_gemm_shapes)
SLICE7B_GEMMS = [
    (2048, 7168, "rwkv6 cm_k"), (7168, 2048, "rwkv6 cm_v"),
    (2048, 2048, "rwkv6 rkvgo"), (2048, 65536, "rwkv6 head"),
    (1600, 1600, "hymba q/o"), (1600, 320, "hymba k/v"),
    (1600, 3200, "hymba ssm in/gate"), (3200, 1600, "hymba ssm out"),
    (1600, 32, "hymba w_bc"), (1600, 50, "hymba w_dt"),
    (1600, 5504, "hymba gate/up"), (5504, 1600, "hymba down"),
    (1600, 32256, "hymba head"),
    (384, 384, "whisper q/k/v/o"), (384, 1536, "whisper up"),
    (1536, 384, "whisper down"), (384, 51968, "whisper head"),
]


def slice7b_kernel_checks(torch, randn, record, gemm_close, attn_close,
                          log):
    """The kernel table's "slice 7b" lines, random inputs at the shapes
    the RWKV6, Hymba and Whisper runs give the kernels, each against its
    plain version within the limits above and timed beside its bound and
    library call: rows 1 (M = 1) and 2 (M = 4) at every SLICE7B_GEMMS
    shape; the odd-N tail (bf16, M 1 / 4 / 7 at 1,600 -> 50 and 1,600 ->
    32: within the GEMM limit of the plain version, each row bitwise the
    same row launched alone); row 7 with Hymba's window (1,024) at its
    heads (25 / 5 x 64) and Sq = Sk = 2,048, and non-causal at Whisper's
    (6 / 6 x 64) for its encoder (Sq = Sk = 1,500) and cross-attention
    (Sq = 64, Sk = 1,500); rows 3-4 at Whisper's heads (G = 1) over 1,500
    keys a row, every row full; row 8 at Hymba's 1,600 -> 5,504."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_plain
    from repro_torch.kernels.gemv import gemv, gemv_plain

    dev = "cuda"
    # -- rows 1 (M = 1) and 2 (M = 4) at the families' widths --------------
    for m, name, fn, plain in ((1, "gemv", gemv, gemv_plain),
                               (4, "flat_gemm", flat_gemm, flat_gemm_plain)):
        for k, n, what in SLICE7B_GEMMS:
            x = randn(m, k)
            w = randn(k, n, scale=k ** -0.5)
            record(name, f"7b M={m} K={k} N={n} (K,N) {what}", fn(x, w),
                   plain(x, w), lambda: fn(x, w), lambda: plain(x, w),
                   lambda: torch.matmul(x, w),
                   2 * (m * k + k * n + m * n), 2 * m * k * n, True,
                   gemm_close, slot=f"7b {what}")
            del w

    # -- the odd-N tail: a row alone bitwise its row in the batch ----------
    for k, n in ((1600, 50), (1600, 32)):
        w = randn(k, n, scale=k ** -0.5)
        for m in (1, 4, 7):
            x = randn(m, k)
            for name, fn, plain in (("gemv", gemv, gemv_plain),
                                    ("flat_gemm", flat_gemm,
                                     flat_gemm_plain)):
                got = fn(x, w)
                ok, tol = gemm_close(got, plain(x, w))
                alone = all(torch.equal(fn(x[i:i + 1], w), got[i:i + 1])
                            for i in range(m))
                log(f"kernel {name} tail M={m} K={k} N={n} (K,N) bf16: "
                    f"{'ok' if ok else 'MISMATCH'} ({tol}); each row alone "
                    f"bitwise its row in the batch {alone}")
                check(ok and alone, f"{name} M={m} K={k} N={n}: disagrees "
                      "with its plain version, or a row's bits depend on "
                      "its batch")

    # -- row 7: Hymba's window, Whisper's encoder and cross-attention ------
    hy, wh = configs.get("hymba-1.5b"), configs.get("whisper-tiny")

    def prefill_case(cfg, b, sq, sk, causal, window, tag):
        hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        phi = cfg.softmax_phi.phi
        q, kk, vv = randn(b, sq, hq, hd), randn(b, sk, hk, hd), \
            randn(b, sk, hk, hd)
        qe = q.transpose(1, 2)
        kx = kk.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
        vx = vv.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
        qi = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=dev)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= ki <= qi
        if window:
            mask &= qi - ki < window
        pairs = int(mask.sum()) * b

        def lib():
            return F.scaled_dot_product_attention(
                qe, kx, vx, attn_mask=None if mask.all() else mask)

        kw = dict(causal=causal, sliding_window=window)
        nbytes = 2 * (2 * b * sq * hq * hd + 2 * b * sk * hk * hd)
        flops = 4 * pairs * hq * hd
        record("flash_prefill_unified_max", tag,
               fp.flash_prefill_unified_max(q, kk, vv, phi=phi, **kw)[0],
               fp.flash_prefill_unified_max_plain(q, kk, vv, phi=phi,
                                                  **kw)[0],
               lambda: fp.flash_prefill_unified_max(q, kk, vv, phi=phi,
                                                    **kw),
               lambda: fp.flash_prefill_unified_max_plain(q, kk, vv,
                                                          phi=phi, **kw),
               lib, nbytes, flops, True, attn_close, slot=tag.split(" ")[0])
        record("flash_prefill_sync", tag,
               fp.flash_prefill_sync(q, kk, vv, **kw),
               fp.flash_prefill_sync_plain(q, kk, vv, **kw),
               lambda: fp.flash_prefill_sync(q, kk, vv, **kw),
               lambda: fp.flash_prefill_sync_plain(q, kk, vv, **kw), lib,
               nbytes, flops, True, attn_close, slot=tag.split(" ")[0])

    prefill_case(hy, 1, 2048, 2048, True, hy.sliding_window,
                 "hymba-window B=1 HQ=25 HK=5 D=64 Sq=Sk=2048 causal "
                 "window 1024")
    prefill_case(wh, 4, 1500, 1500, False, 0,
                 "whisper-encoder B=4 HQ=HK=6 D=64 Sq=Sk=1500 non-causal")
    prefill_case(wh, 4, 64, 1500, False, 0,
                 "whisper-cross B=4 HQ=HK=6 D=64 Sq=64 Sk=1500 non-causal")

    # -- rows 3-4: Whisper's cross-attention decode, 1,500 keys a row ------
    b, s, hq, hk, hd = 4, 1500, wh.num_heads, wh.num_kv_heads, wh.head_dim
    phi = wh.softmax_phi.phi
    kc, vc = randn(b, s, hk, hd), randn(b, s, hk, hd)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    q = randn(b, hq, hd)

    def lib_decode():
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt)

    tag = "whisper-cross B=4 HQ=HK=6 D=64 S=1500 full rows (G=1)"
    nbytes = 2 * (2 * b * hq * hd + 2 * b * s * hk * hd) + 4 * b * hk
    flops = 4 * b * s * hq * hd
    record("decode_attention_unified_max", tag,
           da.decode_attention_unified_max(q, kt, vt, lengths, phi=phi)[0],
           da.decode_attention_unified_max_plain(q, kt, vt, lengths,
                                                 phi=phi)[0],
           lambda: da.decode_attention_unified_max(q, kt, vt, lengths,
                                                   phi=phi),
           lambda: da.decode_attention_unified_max_plain(q, kt, vt, lengths,
                                                         phi=phi),
           lib_decode, nbytes, flops, True, attn_close, slot="whisper-cross")
    record("decode_attention_sync", tag,
           da.decode_attention_sync(q, kt, vt, lengths),
           da.decode_attention_sync_plain(q, kt, vt, lengths),
           lambda: da.decode_attention_sync(q, kt, vt, lengths),
           lambda: da.decode_attention_sync_plain(q, kt, vt, lengths),
           lib_decode, nbytes, flops, True, attn_close, slot="whisper-cross")
    del kc, vc, kt, vt

    # -- row 8: Hymba's MLP, 1,600 -> 5,504 --------------------------------
    d, f = hy.d_model, hy.d_ff
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    for m in (4, 256):
        x = randn(m, d)
        record("fused_ffn_up", f"hymba M={m} K={d} N={f} swiglu",
               ff.fused_ffn_up(x, wg, wu), ff.fused_ffn_up_plain(x, wg, wu),
               lambda: ff.fused_ffn_up(x, wg, wu),
               lambda: ff.fused_ffn_up_plain(x, wg, wu),
               lambda: F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu),
               2 * (m * d + 2 * d * f + m * f), 4 * m * d * f, True,
               gemm_close, slot=f"hymba m{m}")


def dbrx_kernel_checks(torch, randn, record, gemm_close, attn_close, log):
    """Rows 1-7 and 9-13 at dbrx-132b's widths, random inputs: head_dim
    128 with 48 query and 8 KV heads (G = 6), d_model 6,144 and the
    untied head at the padded 100,352 columns in (K, N) layout, the
    shapes runs X to X‴ serve. Each against its plain version within the
    limits above, timed beside its bound and library call (the kernel
    table's "dbrx" lines: rows 1 and 2 at q / o_proj, k / v and the head,
    row 12 at 6,144 -> 6,144 + 2 x 1,024 with rope, row 13 at o_proj,
    the attention rows on the qwen2-0.5b lines' lengths). Paged decode
    must stay bitwise dense decode, and grouped decode bitwise paged."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_fuse as dfu
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import group_attention as ga
    from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_plain
    from repro_torch.kernels.gemv import gemv, gemv_plain
    from repro_torch.kernels.ref import gather_paged_kv

    cfg = configs.get(MOE_ARCH)
    d, hd = cfg.d_model, cfg.head_dim
    hq, hk = cfg.num_heads, cfg.num_kv_heads
    nq, nk = hq * hd, hk * hd
    vp = -(-cfg.vocab_size // 256) * 256
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4)
    phi = cfg.softmax_phi
    tag0 = "dbrx-132b"

    # -- rows 1 (M = 1) and 2 (M = 4): q / o_proj, k / v, the head --------
    for m, name, fn, plain in ((1, "gemv", gemv, gemv_plain),
                               (4, "flat_gemm", flat_gemm, flat_gemm_plain)):
        x = randn(m, d)
        for k, n, what in ((d, nq, "q/o_proj"), (d, nk, "k/v"),
                           (d, vp, "head")):
            w = randn(k, n, scale=k ** -0.5)
            record(name, f"{tag0} M={m} K={k} N={n} (K,N) {what}",
                   fn(x, w), plain(x, w), lambda: fn(x, w),
                   lambda: plain(x, w), lambda: torch.matmul(x, w),
                   2 * (m * k + k * n + m * n), 2 * m * k * n, True,
                   gemm_close,
                   slot="dbrx" if what == "q/o_proj" else f"dbrx {what}")
            del w

    # -- rows 12 and 13 at M = 4 -------------------------------------------
    m = 4
    wq, wk, wv = (randn(d, n, scale=d ** -0.5) for n in (nq, nk, nk))
    nscale = (torch.rand(d, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    wqkv = torch.cat([wq, wk, wv], 1)
    half = hd // 2
    inv_freq = cfg.rope_theta ** (
        -torch.arange(half, device=dev, dtype=torch.float32) / half)
    ikw = dict(num_heads=hq, num_kv_heads=hk, head_dim=hd,
               rope_theta=cfg.rope_theta)
    x = randn(m, d)
    pos = torch.randint(0, 1024, (m,), generator=gen, device=dev,
                        dtype=torch.int32)

    def lib_ingest():
        h = F.rms_norm(x, (d,), nscale, eps=1e-6)
        qkv = torch.matmul(h, wqkv).view(m, -1, hd)
        ang = pos.float()[:, None, None] * inv_freq
        c, s_ = ang.cos(), ang.sin()
        x1, x2 = qkv[:, :hq + hk, :half], qkv[:, :hq + hk, half:]
        rot = torch.cat([x1 * c - x2 * s_, x2 * c + x1 * s_], -1)
        return rot.to(qkv.dtype), qkv[:, hq + hk:]

    n_all = nq + 2 * nk
    record("decode_ingest_fused", f"{tag0} M={m} K={d} N={nq}+{nk}+{nk} rope",
           torch.cat(dfu.decode_ingest_fused(x, nscale, wq, wk, wv, pos,
                                             **ikw), 1),
           torch.cat(dfu.decode_ingest_plain(x, nscale, wq, wk, wv, pos,
                                             **ikw), 1),
           lambda: dfu.decode_ingest_fused(x, nscale, wq, wk, wv, pos, **ikw),
           lambda: dfu.decode_ingest_plain(x, nscale, wq, wk, wv, pos, **ikw),
           lib_ingest, 2 * (m * d + d + d * n_all + m * n_all) + 4 * m,
           2 * m * d * n_all, True, gemm_close, slot="dbrx")
    del wqkv, wk, wv
    o, res = randn(m, nq), randn(m, d)
    record("oproj_residual_fused", f"{tag0} M={m} K={nq} N={d} o_proj",
           dfu.oproj_residual_fused(o, wq, res),
           dfu.oproj_residual_plain(o, wq, res),
           lambda: dfu.oproj_residual_fused(o, wq, res),
           lambda: dfu.oproj_residual_plain(o, wq, res),
           lambda: torch.addmm(res, o, wq), 2 * (m * nq + nq * d + 2 * m * d),
           2 * m * nq * d, True, gemm_close, slot="dbrx")
    del wq

    # -- rows 3-6: B = 4 rows to 1024/517/64/3 positions, dense and paged --
    b, s_max = 4, 1024
    lengths = torch.tensor([1024, 517, 64, 3], dtype=torch.int32,
                           device=dev)
    n_valid = int(lengths.sum())
    kc, vc = randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    ke = kt.repeat_interleave(hq // hk, dim=1)
    ve = vt.repeat_interleave(hq // hk, dim=1)
    mask = (torch.arange(s_max, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    attn_bytes = 2 * (2 * b * hq * hd + 2 * n_valid * hk * hd) + 4 * b * hk
    attn_flops = 4 * n_valid * hq * hd
    (kp, vp_), bt, live = paged_layout(torch, gen, (kc, vc), lengths)
    kpn, vpn = poisoned(torch, (kp, vp_), live)
    q = randn(b, hq, hd)
    q4 = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(q4, ke, ve, attn_mask=mask)

    tag = f"{tag0} B=4 HQ={hq} HK={hk} D={hd} S=1024 ragged"
    out, stat = da.decode_attention_unified_max(q, kt, vt, lengths,
                                                phi=phi.phi)
    record("decode_attention_unified_max", tag, out,
           da.decode_attention_unified_max_plain(q, kt, vt, lengths,
                                                 phi=phi.phi)[0],
           lambda: da.decode_attention_unified_max(q, kt, vt, lengths,
                                                   phi=phi.phi),
           lambda: da.decode_attention_unified_max_plain(q, kt, vt, lengths,
                                                         phi=phi.phi),
           lib, attn_bytes, attn_flops, True, attn_close, slot="dbrx")
    sync = da.decode_attention_sync(q, kt, vt, lengths)
    record("decode_attention_sync", tag, sync,
           da.decode_attention_sync_plain(q, kt, vt, lengths),
           lambda: da.decode_attention_sync(q, kt, vt, lengths),
           lambda: da.decode_attention_sync_plain(q, kt, vt, lengths),
           lib, attn_bytes, attn_flops, True, attn_close, slot="dbrx")
    ptag = tag + f" PS={PAGE} shuffled"
    pout, pstat = da.paged_decode_attention_unified_max(q, kp, vp_, bt,
                                                        lengths, phi=phi.phi)
    psync = da.paged_decode_attention_sync(q, kp, vp_, bt, lengths)
    same = same_bits(torch, (pout, out), (pstat, stat), (psync, sync))
    clean = same_bits(torch, (da.paged_decode_attention_unified_max(
        q, kpn, vpn, bt, lengths, phi=phi.phi)[0], pout), (
        da.paged_decode_attention_sync(q, kpn, vpn, bt, lengths), psync))
    log(f"kernel paged_decode_attention {ptag}: bitwise equal to the dense "
        f"kernel {same}; unchanged with NaN in unread pool rows {clean}")
    check(same and clean, f"paged decode {ptag}: not bitwise the dense "
          "kernel, or reads pool rows past lengths")
    paged_bytes = attn_bytes + 4 * bt.numel()
    record("paged_decode_attention_unified_max", ptag, pout,
           da.paged_decode_attention_unified_max_plain(
               q, kp, vp_, bt, lengths, phi=phi.phi)[0],
           lambda: da.paged_decode_attention_unified_max(
               q, kp, vp_, bt, lengths, phi=phi.phi),
           lambda: da.paged_decode_attention_unified_max_plain(
               q, kp, vp_, bt, lengths, phi=phi.phi),
           lib, paged_bytes, attn_flops, True, attn_close, slot="dbrx")
    record("paged_decode_attention_sync", ptag, psync,
           da.paged_decode_attention_sync_plain(q, kp, vp_, bt, lengths),
           lambda: da.paged_decode_attention_sync(q, kp, vp_, bt, lengths),
           lambda: da.paged_decode_attention_sync_plain(q, kp, vp_, bt,
                                                        lengths),
           lib, paged_bytes, attn_flops, True, attn_close, slot="dbrx")
    del kc, vc, kt, vt, kp, vp_, kpn, vpn

    # -- row 11: four rows share a 512-token prefix ------------------------
    glens = torch.tensor([1024, 800, 600, 520], dtype=torch.int32,
                         device=dev)
    plen = 512
    kp, vp_, bt, live, groups = grouped_layout(torch, gen, randn, glens,
                                               plen, s_max, hk, hd)
    kpn, vpn = poisoned(torch, (kp, vp_), live)
    ke = gather_paged_kv(kp, bt).transpose(1, 2).repeat_interleave(
        hq // hk, dim=1)
    ve = gather_paged_kv(vp_, bt).transpose(1, 2).repeat_interleave(
        hq // hk, dim=1)
    mask = (torch.arange(s_max, device=dev)[None, :] < glens[:, None])[
        :, None, None, :]
    n_keys = int(glens.sum())
    n_read = plen + int((glens - plen).sum())
    g_bytes = (2 * (2 * b * hq * hd + 2 * n_read * hk * hd) + 4 * b * hk
               + 4 * (bt.numel() + sum(t.numel() for t in groups)))
    gtag = f"{tag0} B=4 PS=64 prefix 512, 1024/800/600/520"
    gout, gstat = ga.grouped_paged_decode_attention_unified_max(
        q, kp, vp_, bt, glens, groups, phi=phi.phi)
    pout, pstat = da.paged_decode_attention_unified_max(q, kp, vp_, bt,
                                                        glens, phi=phi.phi)
    same = same_bits(torch, (gout, pout), (gstat, pstat))
    clean = same_bits(torch, (ga.grouped_paged_decode_attention_unified_max(
        q, kpn, vpn, bt, glens, groups, phi=phi.phi)[0], gout))
    log(f"kernel grouped_paged_decode_attention {gtag}: bitwise the paged "
        f"decode kernel {same}; unchanged with NaN in unread pool rows "
        f"{clean}")
    check(same and clean, f"grouped decode {gtag}: not bitwise the paged "
          "kernel, or reads pool rows it must not")
    record("grouped_paged_decode_attention_unified_max", gtag, gout,
           ga.grouped_paged_decode_attention_unified_max_plain(
               q, kp, vp_, bt, glens, groups, phi=phi.phi)[0],
           lambda: ga.grouped_paged_decode_attention_unified_max(
               q, kp, vp_, bt, glens, groups, phi=phi.phi),
           lambda: ga.grouped_paged_decode_attention_unified_max_plain(
               q, kp, vp_, bt, glens, groups, phi=phi.phi),
           lib, g_bytes, 4 * n_keys * hq * hd, True, attn_close,
           slot="dbrx")
    del kp, vp_, kpn, vpn, ke, ve

    # -- row 7: B = 2, causal, Sq = Sk = 512 --------------------------------
    bp, sq = 2, 512
    qp, kk, vv = (randn(bp, sq, h, hd) for h in (hq, hk, hk))
    qe = qp.transpose(1, 2)
    kx = kk.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    vx = vv.transpose(1, 2).repeat_interleave(hq // hk, dim=1)

    def lib_prefill():
        return F.scaled_dot_product_attention(qe, kx, vx, is_causal=True)

    pf_bytes = 2 * (2 * bp * sq * hq * hd + 2 * bp * sq * hk * hd)
    pf_flops = 4 * (bp * sq * (sq + 1) // 2) * hq * hd
    ftag = f"{tag0} B=2 Sq=Sk=512 causal"
    record("flash_prefill_unified_max", ftag,
           fp.flash_prefill_unified_max(qp, kk, vv, phi=phi.phi)[0],
           fp.flash_prefill_unified_max_plain(qp, kk, vv, phi=phi.phi)[0],
           lambda: fp.flash_prefill_unified_max(qp, kk, vv, phi=phi.phi),
           lambda: fp.flash_prefill_unified_max_plain(qp, kk, vv,
                                                      phi=phi.phi),
           lib_prefill, pf_bytes, pf_flops, True, attn_close, slot="dbrx")
    record("flash_prefill_sync", ftag, fp.flash_prefill_sync(qp, kk, vv),
           fp.flash_prefill_sync_plain(qp, kk, vv),
           lambda: fp.flash_prefill_sync(qp, kk, vv),
           lambda: fp.flash_prefill_sync_plain(qp, kk, vv), lib_prefill,
           pf_bytes, pf_flops, True, attn_close, slot="dbrx")
    del qp, kk, vv, qe, kx, vx

    # -- rows 9-10: B = 4, C = 64 after 960/453/0/128 positions -------------
    c = 64
    before = torch.tensor([960, 453, 0, 128], dtype=torch.int32, device=dev)
    kd, vd = randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)
    (kp, vp_), bt, live = paged_layout(torch, gen, (kd, vd), before + c)
    ke = kd.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    ve = vd.transpose(1, 2).repeat_interleave(hq // hk, dim=1)
    qpos = before[:, None] + torch.arange(c, device=dev)[None, :]
    cmask = (torch.arange(s_max, device=dev)[None, None, :]
             <= qpos[:, :, None])[:, None]
    pairs = int(c * before.sum().item() + b * c * (c + 1) // 2)
    ch_bytes = (2 * (2 * b * c * hq * hd + 2 * int((before + c).sum())
                     * hk * hd) + 4 * b * hk + 4 * bt.numel() + 4 * b)
    qc = randn(b, c, hq, hd)
    qce = qc.transpose(1, 2)

    def lib_chunk():
        return F.scaled_dot_product_attention(qce, ke, ve, attn_mask=cmask)

    ctag = f"{tag0} B=4 C=64 PS={PAGE} lengths 960/453/0/128"
    record("paged_chunk_attention_unified_max", ctag,
           ca.paged_chunk_attention_unified_max(qc, kp, vp_, bt, before,
                                                phi=phi.phi)[0],
           ca.paged_chunk_attention_unified_max_plain(qc, kp, vp_, bt, before,
                                                      phi=phi.phi)[0],
           lambda: ca.paged_chunk_attention_unified_max(
               qc, kp, vp_, bt, before, phi=phi.phi),
           lambda: ca.paged_chunk_attention_unified_max_plain(
               qc, kp, vp_, bt, before, phi=phi.phi),
           lib_chunk, ch_bytes, 4 * pairs * hq * hd, True, attn_close,
           slot="dbrx")
    record("paged_chunk_attention_sync", ctag,
           ca.paged_chunk_attention_sync(qc, kp, vp_, bt, before),
           ca.paged_chunk_attention_sync_plain(qc, kp, vp_, bt, before),
           lambda: ca.paged_chunk_attention_sync(qc, kp, vp_, bt, before),
           lambda: ca.paged_chunk_attention_sync_plain(qc, kp, vp_, bt,
                                                       before),
           lib_chunk, ch_bytes, 4 * pairs * hq * hd, True, attn_close,
           slot="dbrx")


def split_k_checks(torch, cfg, randn, record, gemm_close, log):
    """The split-K flat GEMM (rows 2 and 13, bf16 and quantized) where
    the split shows: the decode GEMMs whose N leaves SMs idle.

    * q, k / v, o_proj and down at M in {1, 4, 8, 13, 64}, bf16, int8 and
      fp8: ``flat_gemm`` (no residual) and ``oproj_residual_fused`` (with
      one), each within ``gemm_close`` of its split plain version.
    * Rows 0, 5 and M - 1 of M = 13 and 64, each run alone (M = 1),
      bitwise their rows in the batch; a second launch bitwise the first;
      a CUDA graph's replay at M = 4 bitwise the eager calls.
    * The second kernel-table line of rows 1, 2 and 13 at N = 896: gemv
      (M = 1) and flat_gemm (M = 4) on the down projection, and
      oproj_residual (M = 4) on the o_proj (its first line is the down
      projection), timed beside ``matmul`` / ``addmm``."""
    from repro_torch.kernels import decode_fuse as dfu
    from repro_torch.kernels import quant
    from repro_torch.kernels.flat_gemm import (flat_gemm, flat_gemm_plain,
                                               gemm_tiles)
    from repro_torch.kernels.gemv import gemv, gemv_plain
    from repro_torch.models import wquant

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nq, nk = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"q": (d, nq), "k/v": (d, nk), "o_proj": (nq, d),
              "down": (f, d)}
    x = randn(64, f)
    for tag, (k, n) in shapes.items():
        w = randn(k, n, scale=k ** -0.5)
        resid = randn(64, n)
        weights = {"bf16": (w, None)}
        for qs in (quant.INT8, quant.FP8):
            q = wquant.quantize_weight(w, qs)
            weights[qs.name] = (q["codes"], q["scale"])
        for kind, (wt, sc) in weights.items():
            body, bk, splits = gemm_tiles(k, n, w_bytes=wt.element_size())
            check(body == "split" and splits > 1,
                  f"split-K {tag}: {k}->{n} is not split")

            def gemm(xx, res=None):
                if res is None:
                    return flat_gemm(xx, wt, w_scale=sc)
                return dfu.oproj_residual_fused(xx, wt, res, w_scale=sc)

            def plain(xx, res=None):
                if res is None:
                    return flat_gemm_plain(xx, wt, w_scale=sc)
                return dfu.oproj_residual_plain(xx, wt, res, w_scale=sc)

            worst, close, alone, again = 0.0, True, True, True
            for m in (1, 4, 8, 13, 64):
                xx = x[:m, :k].contiguous()
                for res in (None, resid[:m].contiguous()):
                    got = gemm(xx, res)
                    want = plain(xx, res)
                    worst = max(worst, (got.float() - want.float()).abs()
                                .max().item())
                    close = close and gemm_close(got, want)[0]
                    again = again and same_bits(torch, (gemm(xx, res), got))
                    if m in (13, 64):
                        alone = alone and same_bits(torch, *[
                            (gemm(xx[i:i + 1], None if res is None
                                  else res[i:i + 1]), got[i:i + 1])
                            for i in (0, 5, m - 1)])
            # a graph replay at M = 4, both entries, bitwise the eager calls
            xx, res = x[:4, :k].contiguous(), resid[:4].contiguous()
            replay = graph_replay_same(
                torch, lambda: (gemm(xx), gemm(xx, res)))
            log(f"kernel split-K {tag} {kind} K={k} N={n} (BK={bk},"
                f" {splits} splits) M=1/4/8/13/64, with and without a "
                f"residual: max_abs_err={worst:.3e} (tol atol="
                f"{TOL['atol']} rtol={TOL['rtol']}) "
                f"{'ok' if close else 'MISMATCH'}"
                f"; a row alone bitwise in its batch {alone}; two launches "
                f"bitwise {again}; graph replay bitwise eager {replay}")
            check(close, f"split-K {tag} {kind}: kernel disagrees with its "
                  "split plain version")
            check(alone, f"split-K {tag} {kind}: a row's bits depend on M")
            check(again, f"split-K {tag} {kind}: two launches differ")
            check(replay, f"split-K {tag} {kind}: a graph replay differs "
                  "from the eager call")

    # -- the second kernel-table line of rows 1, 2 and 13 at N = 896 -------
    wd, wo = randn(f, d, scale=f ** -0.5), randn(nq, d, scale=nq ** -0.5)
    for name, fn, pl, m, k, w in (("gemv", gemv, gemv_plain, 1, f, wd),
                                  ("flat_gemm", flat_gemm, flat_gemm_plain, 4,
                                   f, wd)):
        xx = x[:m, :k].contiguous()
        record(name, f"M={m} K={k} N={d} (K,N) down", fn(xx, w), pl(xx, w),
               lambda: fn(xx, w), lambda: pl(xx, w),
               lambda: torch.matmul(xx, w), 2 * (m * k + k * d + m * d),
               2 * m * k * d, True, gemm_close, slot="n896")
    o, res = x[:4, :nq].contiguous(), randn(4, d)
    record("oproj_residual_fused", f"M=4 K={nq} N={d} o_proj",
           dfu.oproj_residual_fused(o, wo, res),
           dfu.oproj_residual_plain(o, wo, res),
           lambda: dfu.oproj_residual_fused(o, wo, res),
           lambda: dfu.oproj_residual_plain(o, wo, res),
           lambda: torch.addmm(res, o, wo), 2 * (4 * nq + nq * d + 8 * d),
           2 * 4 * nq * d, True, gemm_close, slot="n896")


def wgmma_gemm_checks(torch, randn, record, gemm_close, log):
    """Row 2's wgmma body (every flat_gemm launch whose N is not narrow),
    bf16, int8 and fp8, at qwen2-0.5b's and llama2-7b's widths, random
    weights from the smoke's generator.

    * gate / up (896 -> 4,864; 4,096 -> 11,008), the tied heads' (N, K)
      views (896 -> 152,064; 4,096 -> 32,000; bf16 only: a head never
      quantizes) and an o_proj-sized (K, N) shape at the narrowest N the
      body takes (896 -> 4,224, also through oproj_residual_fused with a
      residual), M in {1, 4, 8, 13, 64, 127, 300}, each within
      ``gemm_close`` of its plain version (the same K tiles and splits
      walked on the card); every launch counted once.
    * Rows 0, 5 and M - 1 run alone bitwise their rows in the batch; a
      second launch bitwise the first; a CUDA graph's replay at M = 4
      bitwise the eager call.
    * llama2-7b's M = 4 gate / up lines of row 2 (bf16 and codes) timed
      beside ``matmul`` (the kernel table's "llama" lines)."""
    from repro_torch import configs
    from repro_torch.kernels import decode_fuse as dfu
    from repro_torch.kernels import quant
    from repro_torch.kernels.flat_gemm import (flat_gemm, flat_gemm_plain,
                                               flat_gemm_quant, gemm_tiles)
    from repro_torch.models import wquant

    bf = torch.bfloat16
    for arch in (ARCH, "llama2-7b"):
        cfg = configs.get(arch)
        d, f = cfg.d_model, cfg.d_ff
        vocab = -(-cfg.vocab_size // 256) * 256
        x = randn(300, max(d, f))
        resid = randn(300, 4224)
        shapes = [("gate/up", d, f), ("tied head (N,K)", d, vocab)]
        if arch == ARCH:
            shapes.append(("o_proj-sized", cfg.num_heads * cfg.head_dim,
                           4224))
        for tag, k, n in shapes:
            kinds = {}
            if "tied" in tag:
                kinds["bf16"] = (randn(n, k, scale=k ** -0.5).T, None)
            else:
                w = randn(k, n, scale=k ** -0.5)
                kinds["bf16"] = (w, None)
                for qs in (quant.INT8, quant.FP8):
                    q = wquant.quantize_weight(w, qs)
                    kinds[qs.name] = (q["codes"], q["scale"])
            residual = tag == "o_proj-sized"
            for kind, (wt, sc) in kinds.items():
                body, _, splits = gemm_tiles(k, n, w_kn=wt.stride(1) == 1,
                                             w_bytes=wt.element_size())
                check(body == "wgmma", f"wgmma GEMM {arch} {tag}: {k}->{n} "
                      "takes the split body")
                counter = flat_gemm if sc is None else flat_gemm_quant

                def run(xx, res=None):
                    if res is None:
                        return flat_gemm(xx, wt, w_scale=sc)
                    return dfu.oproj_residual_fused(xx, wt, res, w_scale=sc)

                def plain(xx, res=None):
                    if res is None:
                        return flat_gemm_plain(xx, wt, w_scale=sc)
                    return dfu.oproj_residual_plain(xx, wt, res, w_scale=sc)

                worst, close, alone, again, counted = 0.0, True, True, True, \
                    True
                for m in (1, 4, 8, 13, 64, 127, 300):
                    xx = x[:m, :k].contiguous()
                    for res in ((None, resid[:m].contiguous()) if residual
                                else (None,)):
                        before = counter.launches
                        got = run(xx, res)
                        counted = counted and (res is not None or
                                               counter.launches - before == 1)
                        want = plain(xx, res)
                        worst = max(worst, (got.float() - want.float()).abs()
                                    .max().item())
                        close = close and gemm_close(got, want)[0]
                        again = again and same_bits(torch, (run(xx, res),
                                                            got))
                        alone = alone and same_bits(torch, *[
                            (run(xx[i:i + 1], None if res is None
                                 else res[i:i + 1]), got[i:i + 1])
                            for i in sorted({0, min(5, m - 1), m - 1})])
                x4, r4 = x[:4, :k].contiguous(), resid[:4].contiguous()
                replay = graph_replay_same(
                    torch, (lambda: (run(x4), run(x4, r4))) if residual
                    else (lambda: run(x4)))
                log(f"kernel wgmma GEMM {arch} {tag} {kind} K={k} N={n} "
                    f"({splits} splits{', with a residual' if residual else ''}"
                    f") M=1/4/8/13/64/127/300: max_abs_err={worst:.3e} (tol "
                    f"atol={TOL['atol']} rtol={TOL['rtol']}) "
                    f"{'ok' if close else 'MISMATCH'}; a row alone bitwise in "
                    f"its batch {alone}; two launches bitwise {again}; one "
                    f"launch counted a call {counted}; graph replay bitwise "
                    f"eager {replay}")
                name = f"wgmma GEMM {arch} {tag} {kind}"
                check(close, f"{name}: kernel disagrees with its plain "
                      "version")
                check(alone, f"{name}: a row's bits depend on M")
                check(again, f"{name}: two launches differ")
                check(counted, f"{name}: launches not counted once a call")
                check(replay, f"{name}: a graph replay differs from the "
                      "eager call")
                if arch == ARCH or tag != "gate/up":
                    continue
                # llama2-7b's timed gate / up lines at M = 4
                m = 4
                xx = x[:m, :k].contiguous()
                w = kinds["bf16"][0]
                if sc is None:
                    record("flat_gemm", f"llama2-7b M={m} K={k} N={n} (K,N) "
                           "gate/up", run(xx), plain(xx), lambda: run(xx),
                           lambda: plain(xx), lambda: torch.matmul(xx, w),
                           2 * (m * k + k * n + m * n), 2 * m * k * n, True,
                           gemm_close, slot="llama")
                else:
                    record("flat_gemm_quant", f"{kind} llama2-7b M={m} K={k} "
                           f"N={n} gate/up", run(xx), plain(xx),
                           lambda: run(xx), lambda: plain(xx),
                           lambda: (torch.matmul(xx, wt.to(bf)) * sc).to(bf),
                           2 * m * k + k * n + 4 * n + 2 * m * n,
                           2 * m * k * n, True, gemm_close,
                           twin=lambda: flat_gemm(xx, w),
                           slot="llama" if kind == "int8" else "fp8 llama")
            del kinds
        del x, resid


def graph_replay_same(torch, fn):
    """A CUDA graph's replay of ``fn`` (outputs zeroed first) gives the
    bits of an eager call; ``fn`` returns a tensor or a tuple of them."""
    def parts(r):
        return r if isinstance(r, tuple) else (r,)
    eager = parts(fn())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = parts(fn())
    for t in captured:
        t.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    return same_bits(torch, *zip(captured, eager))


def gemv_split_checks(torch, cfg, randn, embedding, gemm_close, log):
    """The split-K GEMV (row 1, bf16 and quantized) at the decode GEMMs'
    shapes, and the tied head's unsplit (N, K) body.

    * q, k / v, o_proj, gate / up and down at M in {1, 2, 4, 5, 8, 15},
      bf16, int8 and fp8, and the tied head (bf16), each within
      ``gemm_close`` of ``gemv_plain`` (the same splits walked on the
      card); past four rows the wrapper launches the kernel on slices of
      at most four rows (``gemv.row_slices``), one launch counted each.
    * Every row of M = 2, 4, 5, 8 and 15 run alone (M = 1) bitwise its row
      in the batch; a second launch bitwise the first; a CUDA graph's
      replay at M = 4 bitwise the eager call."""
    from repro_torch.kernels import quant
    from repro_torch.kernels.gemv import (gemv, gemv_plain, gemv_quant,
                                          gemv_tiles, row_slices)
    from repro_torch.models import wquant

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nq, nk = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"q": (d, nq), "k/v": (d, nk), "o_proj": (nq, d),
              "gate/up": (d, f), "down": (f, d)}
    x = randn(15, f)
    cases = []
    for tag, (k, n) in shapes.items():
        w = randn(k, n, scale=k ** -0.5)
        cases.append((tag, "bf16", k, w, None))
        for qs in (quant.INT8, quant.FP8):
            q = wquant.quantize_weight(w, qs)
            cases.append((tag, qs.name, k, q["codes"], q["scale"]))
    cases.append(("tied head (N,K)", "bf16", d, embedding.T, None))
    for tag, kind, k, wt, sc in cases:
        n = wt.shape[1]
        cols, splits = gemv_tiles(k, n, wt.stride(1) == 1)

        def run(xx):
            return gemv(xx, wt, w_scale=sc)

        counter = gemv if sc is None else gemv_quant
        worst, close, alone, again, counted = 0.0, True, True, True, True
        for m in (1, 2, 4, 5, 8, 15):
            xx = x[:m, :k].contiguous()
            before = counter.launches
            got = run(xx)
            counted = counted and (counter.launches - before
                                   == len(row_slices(m)))
            want = gemv_plain(xx, wt, w_scale=sc)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            close = close and gemm_close(got, want)[0]
            again = again and same_bits(torch, (run(xx), got))
            if m > 1:
                alone = alone and same_bits(torch, *[
                    (run(xx[i:i + 1]), got[i:i + 1]) for i in range(m)])
        replay = graph_replay_same(torch, lambda: run(x[:4, :k]))
        log(f"kernel gemv split {tag} {kind} K={k} N={n} ({cols} columns a "
            f"block, {splits} splits) M=1/2/4/5/8/15: max_abs_err="
            f"{worst:.3e} (tol atol={TOL['atol']} rtol={TOL['rtol']}) "
            f"{'ok' if close else 'MISMATCH'}; a row alone bitwise in its "
            f"batch {alone}; two launches bitwise {again}; one launch "
            f"counted per 4-row slice {counted}; graph replay bitwise eager "
            f"{replay}")
        check(counted, f"gemv {tag} {kind}: launches not counted per slice")
        check(close, f"gemv {tag} {kind}: kernel disagrees with its split "
              "plain version")
        check(alone, f"gemv {tag} {kind}: a row's bits depend on M")
        check(again, f"gemv {tag} {kind}: two launches differ")
        check(replay, f"gemv {tag} {kind}: a graph replay differs from the "
              "eager call")


def ffn_wgmma_checks(torch, randn, record, gemm_close, log):
    """The wgmma fused FFN-up (row 8), bf16, int8 and fp8, at qwen2-0.5b's
    and llama2-7b's widths (random weights), M in {1, 4, 13, 64, 256,
    1024}, swiglu and geglu: within ``gemm_close`` of
    ``fused_ffn_up_plain``; rows 0, M // 2 and M - 1 run alone bitwise
    their rows in the batch; a second launch bitwise the first; a CUDA
    graph's replay at M = 4 and 256 bitwise the eager call. llama2-7b's M
    = 4 lines of the quantized body are timed beside the library chain
    (codes cast to bf16, two matmuls and the steps)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import quant
    from repro_torch.models import wquant

    bf = torch.bfloat16
    for arch in (ARCH, "llama2-7b"):
        cfg = configs.get(arch)
        d, f = cfg.d_model, cfg.d_ff
        wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
        x = randn(1024, d)
        kinds = {"bf16": (wg, wu, {})}
        for qs in (quant.INT8, quant.FP8):
            qg, qu = (wquant.quantize_weight(w, qs) for w in (wg, wu))
            kinds[qs.name] = (qg["codes"], qu["codes"],
                              dict(wg_scale=qg["scale"], wu_scale=qu["scale"]))
        for kind, (g, u, kw) in kinds.items():
            for act in ("swiglu", "geglu"):
                def run(xx):
                    return ff.fused_ffn_up(xx, g, u, activation=act, **kw)

                worst, close, alone, again, replay = 0.0, True, True, True, \
                    True
                for m in (1, 4, 13, 64, 256, 1024):
                    xx = x[:m].contiguous()
                    got = run(xx)
                    want = ff.fused_ffn_up_plain(xx, g, u, activation=act,
                                                 **kw)
                    worst = max(worst, (got.float() - want.float()).abs()
                                .max().item())
                    close = close and gemm_close(got, want)[0]
                    again = again and same_bits(torch, (run(xx), got))
                    alone = alone and same_bits(torch, *[
                        (run(xx[i:i + 1]), got[i:i + 1])
                        for i in sorted({0, m // 2, m - 1})])
                    if m in (4, 256):
                        replay = replay and graph_replay_same(
                            torch, lambda: run(xx))
                name = f"fused_ffn_up wgmma {arch} {kind} {act}"
                log(f"kernel {name} K={d} N={f} M=1/4/13/64/256/1024: "
                    f"max_abs_err={worst:.3e} (tol atol={TOL['atol']} rtol="
                    f"{TOL['rtol']}) {'ok' if close else 'MISMATCH'}; a row "
                    f"alone bitwise in its batch {alone}; two launches "
                    f"bitwise {again}; graph replay bitwise eager {replay}")
                check(close, f"{name}: kernel disagrees with its plain "
                      "version")
                check(alone, f"{name}: a row's bits depend on M")
                check(again, f"{name}: two launches differ")
                check(replay, f"{name}: a graph replay differs from the "
                      "eager call")
            if arch == ARCH or kind == "bf16":
                continue
            # llama2-7b's timed quantized line at M = 4
            m = 4
            xx = x[:m].contiguous()
            record("fused_ffn_up_quant", f"{kind} llama2-7b M={m} K={d} "
                   f"N={f} swiglu", ff.fused_ffn_up(xx, g, u, **kw),
                   ff.fused_ffn_up_plain(xx, g, u, **kw),
                   lambda: ff.fused_ffn_up(xx, g, u, **kw),
                   lambda: ff.fused_ffn_up_plain(xx, g, u, **kw),
                   lambda: (F.silu(torch.matmul(xx, g.to(bf))
                                   * kw["wg_scale"])
                            * (torch.matmul(xx, u.to(bf))
                               * kw["wu_scale"])).to(bf),
                   2 * m * d + 2 * (d * f + 4 * f) + 2 * m * f,
                   4 * m * d * f, True, gemm_close,
                   twin=lambda: ff.fused_ffn_up(xx, wg, wu),
                   slot="llama" if kind == "int8" else "fp8 llama")
        del wg, wu, kinds


def ingest_ffn_split_checks(torch, randn, record, gemm_close, log):
    """The split-K fused decode ingest (row 12) and the rmsnorm-fused
    FFN-up (row 14, on its wgmma body for bf16 and codes alike) at
    qwen2-0.5b's and llama2-7b's widths, random weights from the smoke's
    generator (llama2-7b: head_dim 128, one query head a kv head).

    * M in {1, 4, 8, 13, 64}, bf16, int8 and fp8 (row 14 with swiglu and
      geglu), each within ``gemm_close`` of its plain version (the same
      splits walked on the card).
    * Rows 0, M // 2 and M - 1 run alone bitwise their rows in the batch;
      a second launch bitwise the first; a CUDA graph's replay at M = 4
      bitwise the eager call.
    * llama2-7b's M = 4 lines of rows 12 and 14 (bf16, and row 14's
      codes) are timed beside their library chains (the kernel table's
      "llama" lines)."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels import decode_fuse as dfu
    from repro_torch.kernels import quant
    from repro_torch.models import wquant

    gen = torch.Generator(device="cuda").manual_seed(3)
    for arch in (ARCH, "llama2-7b"):
        cfg = configs.get(arch)
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        hq, hk = cfg.num_heads, cfg.num_kv_heads
        nq, nk = hq * hd, hk * hd
        wq, wk, wv = (randn(d, n, scale=d ** -0.5) for n in (nq, nk, nk))
        bq, bkb, bv = (randn(n) for n in (nq, nk, nk))
        nscale = (torch.rand(d, generator=gen, device="cuda") + 0.5).to(
            torch.bfloat16)
        wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
        x = randn(64, d)
        pos = torch.randint(0, 4096, (64,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ikw = dict(num_heads=hq, num_kv_heads=hk, head_dim=hd,
                   rope_theta=cfg.rope_theta, bq=bq, bk=bkb, bv=bv)
        ingest_splits = dfu.ingest_splits(d, hq + 2 * hk)
        kinds = {"bf16": ((wq, wk, wv), {}, (wg, wu), {})}
        for qs in (quant.INT8, quant.FP8):
            leaves = [wquant.quantize_weight(w, qs)
                      for w in (wq, wk, wv, wg, wu)]
            kinds[qs.name] = (
                tuple(lf["codes"] for lf in leaves[:3]),
                dict(wq_scale=leaves[0]["scale"],
                     wk_scale=leaves[1]["scale"],
                     wv_scale=leaves[2]["scale"]),
                tuple(lf["codes"] for lf in leaves[3:]),
                dict(wg_scale=leaves[3]["scale"],
                     wu_scale=leaves[4]["scale"]))
        for kind, (qkv, qsc, gu, gsc) in kinds.items():
            def ingest(xx, pp, plain=False):
                fn = dfu.decode_ingest_plain if plain \
                    else dfu.decode_ingest_fused
                return fn(xx, nscale, *qkv, pp, **ikw, **qsc)

            cases = [("decode_ingest_fused", ingest)]
            for act in ("swiglu", "geglu"):
                def ffn(xx, pp, plain=False, act=act):
                    fn = dfu.ffn_norm_plain if plain else dfu.ffn_norm_fused
                    return fn(xx, nscale, *gu, activation=act, **gsc)
                cases.append((f"ffn_norm_fused {act}", ffn))
            for name, fn in cases:
                def parts(r):
                    return r if isinstance(r, tuple) else (r,)

                worst, close, alone, again = 0.0, True, True, True
                for m in (1, 4, 8, 13, 64):
                    xx, pp = x[:m].contiguous(), pos[:m].contiguous()
                    got = parts(fn(xx, pp))
                    want = parts(fn(xx, pp, plain=True))
                    for a, b in zip(got, want):
                        worst = max(worst, (a.float() - b.float()).abs()
                                    .max().item())
                        close = close and gemm_close(a, b)[0]
                    again = again and same_bits(
                        torch, *zip(parts(fn(xx, pp)), got))
                    alone = alone and same_bits(torch, *[
                        (a, b[i:i + 1]) for i in sorted({0, m // 2, m - 1})
                        for a, b in zip(parts(fn(xx[i:i + 1], pp[i:i + 1])),
                                        got)])
                x4, p4 = x[:4].contiguous(), pos[:4].contiguous()
                replay = graph_replay_same(torch, lambda: fn(x4, p4))
                log(f"kernel split {name} {arch} {kind} K={d} (ingest "
                    f"{ingest_splits} splits, ffn_norm "
                    f"{dfu.ffn_norm_splits(d, f, gu[0].element_size())}) "
                    f"M=1/4/8/13/64: max_abs_err={worst:.3e} (tol atol="
                    f"{TOL['atol']} rtol={TOL['rtol']}) "
                    f"{'ok' if close else 'MISMATCH'}; a row alone bitwise "
                    f"in its batch {alone}; two launches bitwise {again}; "
                    f"graph replay bitwise eager {replay}")
                check(close, f"{name} {arch} {kind}: kernel disagrees with "
                      "its split plain version")
                check(alone, f"{name} {arch} {kind}: a row's bits depend on "
                      "M")
                check(again, f"{name} {arch} {kind}: two launches differ")
                check(replay, f"{name} {arch} {kind}: a graph replay differs "
                      "from the eager call")
        if arch == ARCH:
            continue
        # llama2-7b's timed lines at M = 4, bf16, beside the library chains
        m = 4
        x4, p4 = x[:m].contiguous(), pos[:m].contiguous()
        wqkv, bqkv = torch.cat([wq, wk, wv], 1), torch.cat([bq, bkb, bv])
        half = hd // 2
        inv_freq = cfg.rope_theta ** (
            -torch.arange(half, device="cuda", dtype=torch.float32) / half)

        def lib_ingest():
            h = F.rms_norm(x4, (d,), nscale, eps=1e-6)
            qkv = torch.addmm(bqkv, h, wqkv).view(m, -1, hd)
            ang = p4.float()[:, None, None] * inv_freq
            c, sn = ang.cos(), ang.sin()
            x1, x2 = qkv[:, :hq + hk, :half], qkv[:, :hq + hk, half:]
            rot = torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], -1)
            return rot.to(qkv.dtype), qkv[:, hq + hk:]

        def lib_ffn():
            h = F.rms_norm(x4, (d,), nscale, eps=1e-6)
            return F.silu(torch.matmul(h, wg)) * torch.matmul(h, wu)

        n_all = nq + 2 * nk
        record("decode_ingest_fused",
               f"llama2-7b M={m} K={d} N={nq}+{nk}+{nk} bias rope",
               torch.cat(dfu.decode_ingest_fused(x4, nscale, wq, wk, wv, p4,
                                                 **ikw), 1),
               torch.cat(dfu.decode_ingest_plain(x4, nscale, wq, wk, wv, p4,
                                                 **ikw), 1),
               lambda: dfu.decode_ingest_fused(x4, nscale, wq, wk, wv, p4,
                                               **ikw),
               lambda: dfu.decode_ingest_plain(x4, nscale, wq, wk, wv, p4,
                                               **ikw),
               lib_ingest,
               2 * (m * d + d + d * n_all + n_all + m * n_all) + 4 * m,
               2 * m * d * n_all, True, gemm_close, slot="llama")
        record("ffn_norm_fused", f"llama2-7b M={m} K={d} N={f} swiglu",
               dfu.ffn_norm_fused(x4, nscale, wg, wu),
               dfu.ffn_norm_plain(x4, nscale, wg, wu),
               lambda: dfu.ffn_norm_fused(x4, nscale, wg, wu),
               lambda: dfu.ffn_norm_plain(x4, nscale, wg, wu), lib_ffn,
               2 * (m * d + d + 2 * d * f + m * f), 4 * m * d * f, True,
               gemm_close, slot="llama")
        bf = torch.bfloat16
        for kind in ("int8", "fp8"):
            _, _, gu, gsc = kinds[kind]

            def lib_ffn_q(gu=gu, gsc=gsc):
                h = F.rms_norm(x4, (d,), nscale, eps=1e-6)
                return (F.silu(torch.matmul(h, gu[0].to(bf))
                               * gsc["wg_scale"])
                        * (torch.matmul(h, gu[1].to(bf))
                           * gsc["wu_scale"])).to(bf)

            record("ffn_norm_fused_quant",
                   f"{kind} llama2-7b M={m} K={d} N={f} swiglu",
                   dfu.ffn_norm_fused(x4, nscale, *gu, **gsc),
                   dfu.ffn_norm_plain(x4, nscale, *gu, **gsc),
                   lambda: dfu.ffn_norm_fused(x4, nscale, *gu, **gsc),
                   lambda: dfu.ffn_norm_plain(x4, nscale, *gu, **gsc),
                   lib_ffn_q,
                   2 * m * d + 2 * d + 2 * (d * f + 4 * f) + 2 * m * f,
                   4 * m * d * f, True, gemm_close,
                   twin=lambda: dfu.ffn_norm_fused(x4, nscale, wg, wu),
                   slot="llama" if kind == "int8" else "fp8 llama")
        del wq, wk, wv, wg, wu, wqkv, kinds


def split_kv_checks(torch, cfg, gen, randn, record, attn_close, log):
    """The split-KV chunk kernels (rows 9-10) where the split shows.

    * A long chunk: one sequence with 4,032 positions before a 64-token
      chunk (16 splits of 256 keys), timed beside SDPA over the
      pre-gathered view; with a block table twice as wide as its live
      positions (16 more splits past the chunk) and NaN in every pool row
      that holds no live position, its output is bitwise the tight
      table's on the clean pool: an empty split reads nothing and adds
      nothing.
    * A ragged chunk: row 9's case with chunk_lens 64/37/1/64, and the
      pool rows past each sequence's last valid position written with NaN
      (bf16), the NaN code (fp8) or the code -128 that encode never writes
      (int8, which has no NaN): the valid rows' output is bitwise the
      clean pool's, and the same as without chunk_lens."""
    import torch.nn.functional as F

    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import quant
    from repro_torch.serving import kvquant

    hd, hq, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    phi, dev, c = cfg.softmax_phi, "cuda", 64

    # -- the long chunk: B=1, 4,032 positions before it --------------------
    before = torch.tensor([4032], dtype=torch.int32, device=dev)
    n_live = 4096
    kd, vd = randn(1, 2 * n_live, hk, hd), randn(1, 2 * n_live, hk, hd)
    (kp, vp), wide, live = paged_layout(torch, gen, (kd, vd), before + c)
    tight = wide[:, :n_live // PAGE]
    kpn, vpn = poisoned(torch, (kp, vp), live)
    q = randn(1, c, hq, hd)
    qe = q.transpose(1, 2)
    ke, ve = (x[:, :n_live].transpose(1, 2).repeat_interleave(hq // hk, dim=1)
              for x in (kd, vd))
    qpos = before[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(n_live, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    pairs = c * 4032 + c * (c + 1) // 2
    nbytes = (2 * (2 * c * hq * hd + 2 * n_live * hk * hd) + 4 * hk
              + 4 * tight.numel() + 4)
    tag = "B=1 C=64 PS=64, 4032 positions before (16 splits)"
    lib = lambda: F.scaled_dot_product_attention(qe, ke, ve, attn_mask=mask)
    out, _ = ca.paged_chunk_attention_unified_max(q, kp, vp, tight, before,
                                                  phi=phi.phi)
    sync = ca.paged_chunk_attention_sync(q, kp, vp, tight, before)
    clean = same_bits(
        torch, (ca.paged_chunk_attention_unified_max(
            q, kpn, vpn, wide, before, phi=phi.phi)[0], out),
        (ca.paged_chunk_attention_sync(q, kpn, vpn, wide, before), sync))
    log(f"kernel paged_chunk_attention {tag}: a table twice as wide, NaN in "
        f"every unread pool row, bitwise the tight table's {clean}")
    check(clean, f"paged chunk {tag}: an empty split reads or adds")
    record("paged_chunk_attention_unified_max", tag, out,
           ca.paged_chunk_attention_unified_max_plain(q, kp, vp, tight,
                                                      before, phi=phi.phi)[0],
           lambda: ca.paged_chunk_attention_unified_max(
               q, kp, vp, tight, before, phi=phi.phi),
           lambda: ca.paged_chunk_attention_unified_max_plain(
               q, kp, vp, tight, before, phi=phi.phi),
           lib, nbytes, 4 * pairs * hq * hd, True, attn_close, slot="long")
    record("paged_chunk_attention_sync", tag, sync,
           ca.paged_chunk_attention_sync_plain(q, kp, vp, tight, before),
           lambda: ca.paged_chunk_attention_sync(q, kp, vp, tight, before),
           lambda: ca.paged_chunk_attention_sync_plain(q, kp, vp, tight,
                                                       before),
           lib, nbytes, 4 * pairs * hq * hd, True, attn_close, slot="long")

    # -- the ragged chunk: chunk_lens 64/37/1/64 ----------------------------
    b, s_max = 4, 1024
    before = torch.tensor([960, 453, 0, 128], dtype=torch.int32, device=dev)
    clens = torch.tensor([64, 37, 1, 64], dtype=torch.int32, device=dev)
    (kp, vp), bt, _ = paged_layout(
        torch, gen, (randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)),
        before + c)
    written = torch.zeros((kp.shape[0], PAGE), dtype=torch.bool, device=dev)
    for i in range(b):
        n = -(-int(before[i] + c) // PAGE)
        pos = torch.arange(n * PAGE, device=dev).reshape(n, PAGE)
        written[bt[i, :n].long()] = pos < int(before[i] + clens[i])
    q = randn(b, c, hq, hd)
    keep = torch.arange(c, device=dev)[None, :] < clens[:, None]
    for name in ("bf16", "int8", "fp8"):
        if name == "bf16":
            pools = [(kp, None), (vp, None)]
        else:
            qs = quant.INT8 if name == "int8" else quant.FP8
            pools = [kvquant.quantize_pages(p, qs) for p in (kp, vp)]
        dirty = []
        for codes, _ in pools:
            if name == "bf16":
                bad = torch.full_like(codes, float("nan"))
            else:
                bad = torch.full_like(codes.view(torch.uint8),
                                      0x80 if name == "int8" else 0x7F
                                      ).view(codes.dtype)
            dirty.append(torch.where(written[:, :, None, None], codes, bad))
        kw = {} if name == "bf16" else dict(k_scale=pools[0][1],
                                            v_scale=pools[1][1])
        (kc, _), (vc, _) = pools
        same = []
        for fn in (lambda k, v, **x: ca.paged_chunk_attention_unified_max(
                       q, k, v, bt, before, phi=phi.phi, **kw, **x)[0],
                   lambda k, v, **x: ca.paged_chunk_attention_sync(
                       q, k, v, bt, before, **kw, **x)):
            ragged = fn(kc, vc, chunk_lens=clens)
            same.append(same_bits(
                torch, (fn(*dirty, chunk_lens=clens)[keep], ragged[keep]),
                (fn(kc, vc)[keep], ragged[keep])))
        log(f"kernel paged_chunk_attention {name} ragged chunk (chunk_lens "
            f"64/37/1/64, the rows past each sequence's last valid position "
            f"dirty): valid rows bitwise the clean pool's and the unragged "
            f"call's, unified {same[0]}, sync {same[1]}")
        check(all(same), f"paged chunk {name} ragged chunk: a row past the "
              "last valid position reaches a valid row")


def decode_split_checks(torch, timer, cfg, gen, randn, record, attn_close,
                        log):
    """The split-KV decode kernels (rows 3-6 and 11) where the split shows.

    * The long case: B = 4, every row 8,192 positions (128 splits of 64
      keys), rows 3-6 timed beside SDPA (over the GQA-expanded cache) as
      their second line; paged bitwise dense. Row 11 on the same lengths
      with a 4,096-token prefix shared by the four rows, bitwise row 5.
    * A grouped case whose prefix is not a multiple of a split: 32-row
      pages, a 160-token prefix (two whole splits; stage 2 re-reads the
      last 32 prefix keys), bf16 and int8 pages, out and stat bitwise
      row 5 on the same pool and unchanged with NaN in every pool row
      (and, int8, every step) that holds no position a row reads."""
    import torch.nn.functional as F

    from repro_torch import hardware
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import group_attention as ga
    from repro_torch.kernels import quant
    from repro_torch.kernels.ref import gather_paged_kv
    from repro_torch.serving import kvquant

    spec = hardware.DEFAULT
    hd, hq, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    phi, dev, b = cfg.softmax_phi, "cuda", 4

    # -- the long case: rows 3-6 -------------------------------------------
    s_max = 8192
    lengths = torch.full((b,), s_max, dtype=torch.int32, device=dev)
    kc, vc = randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    ke = kt.repeat_interleave(hq // hk, dim=1)
    ve = vt.repeat_interleave(hq // hk, dim=1)
    (kp, vp), bt, _ = paged_layout(torch, gen, (kc, vc), lengths)
    q = randn(b, hq, hd)
    q4 = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(q4, ke, ve)
    n_valid = b * s_max
    nbytes = 2 * (2 * b * hq * hd + 2 * n_valid * hk * hd) + 4 * b * hk
    flops = 4 * n_valid * hq * hd
    tag = f"B=4 S={s_max} every row full ({s_max // 64} splits)"
    ptag = tag + f" PS={PAGE} shuffled"
    out, stat = da.decode_attention_unified_max(q, kt, vt, lengths,
                                                phi=phi.phi)
    sync = da.decode_attention_sync(q, kt, vt, lengths)
    pout, pstat = da.paged_decode_attention_unified_max(q, kp, vp, bt,
                                                        lengths, phi=phi.phi)
    psync = da.paged_decode_attention_sync(q, kp, vp, bt, lengths)
    same = same_bits(torch, (pout, out), (pstat, stat), (psync, sync))
    log(f"kernel paged_decode_attention {ptag}: bitwise equal to the dense "
        f"kernel {same}")
    check(same, f"paged decode {ptag}: not bitwise the dense kernel")
    want, want_stat = da.decode_attention_unified_max_plain(
        q, kt, vt, lengths, phi=phi.phi)
    serr = (stat - want_stat).abs().max().item()
    log(f"kernel decode_attention_unified_max {tag}: stat max_abs_err="
        f"{serr:.3e}")
    check(serr <= 1e-2 * max(1.0, want_stat.abs().max().item()),
          f"decode unified-max {tag}: stat disagrees")
    record("decode_attention_unified_max", tag, out, want,
           lambda: da.decode_attention_unified_max(q, kt, vt, lengths,
                                                   phi=phi.phi),
           lambda: da.decode_attention_unified_max_plain(
               q, kt, vt, lengths, phi=phi.phi),
           lib, nbytes, flops, True, attn_close, slot="long")
    record("decode_attention_sync", tag, sync,
           da.decode_attention_sync_plain(q, kt, vt, lengths),
           lambda: da.decode_attention_sync(q, kt, vt, lengths),
           lambda: da.decode_attention_sync_plain(q, kt, vt, lengths),
           lib, nbytes, flops, True, attn_close, slot="long")
    pbytes = nbytes + 4 * bt.numel()
    record("paged_decode_attention_unified_max", ptag, pout,
           da.paged_decode_attention_unified_max_plain(
               q, kp, vp, bt, lengths, phi=phi.phi)[0],
           lambda: da.paged_decode_attention_unified_max(
               q, kp, vp, bt, lengths, phi=phi.phi),
           lambda: da.paged_decode_attention_unified_max_plain(
               q, kp, vp, bt, lengths, phi=phi.phi),
           lib, pbytes, flops, True, attn_close, slot="long")
    record("paged_decode_attention_sync", ptag, psync,
           da.paged_decode_attention_sync_plain(q, kp, vp, bt, lengths),
           lambda: da.paged_decode_attention_sync(q, kp, vp, bt, lengths),
           lambda: da.paged_decode_attention_sync_plain(q, kp, vp, bt,
                                                        lengths),
           lib, pbytes, flops, True, attn_close, slot="long")

    # -- the long case: row 11, a 4,096-token prefix shared by four rows ---
    plen = 4096
    kp, vp, bt, _, groups = grouped_layout(torch, gen, randn, lengths, plen,
                                           s_max, hk, hd)
    kd, vd = (gather_paged_kv(p, bt).transpose(1, 2) for p in (kp, vp))
    ke = kd.repeat_interleave(hq // hk, dim=1)
    ve = vd.repeat_interleave(hq // hk, dim=1)
    lib = lambda: F.scaled_dot_product_attention(q4, ke, ve)
    n_read = plen + b * (s_max - plen)
    gbytes = (2 * (2 * b * hq * hd + 2 * n_read * hk * hd) + 4 * b * hk
              + 4 * (bt.numel() + sum(t.numel() for t in groups)))
    gtag = f"B=4 S={s_max} PS={PAGE}, prefix {plen} shared by 4 rows"
    gout, gstat = ga.grouped_paged_decode_attention_unified_max(
        q, kp, vp, bt, lengths, groups, phi=phi.phi)
    pout, pstat = da.paged_decode_attention_unified_max(q, kp, vp, bt,
                                                        lengths, phi=phi.phi)
    same = same_bits(torch, (gout, pout), (gstat, pstat))
    log(f"kernel grouped_paged_decode_attention {gtag}: out and stat "
        f"bitwise the paged decode kernel {same}")
    check(same, f"grouped decode {gtag}: not bitwise the paged kernel")
    record("grouped_paged_decode_attention_unified_max", gtag, gout,
           ga.grouped_paged_decode_attention_unified_max_plain(
               q, kp, vp, bt, lengths, groups, phi=phi.phi)[0],
           lambda: ga.grouped_paged_decode_attention_unified_max(
               q, kp, vp, bt, lengths, groups, phi=phi.phi),
           lambda: ga.grouped_paged_decode_attention_unified_max_plain(
               q, kp, vp, bt, lengths, groups, phi=phi.phi),
           lib, gbytes, flops, True, attn_close, slot="long")
    p_ms = timer.ms(lambda: da.paged_decode_attention_unified_max(
        q, kp, vp, bt, lengths, phi=phi.phi))
    log(f"kernel paged_decode_attention_unified_max {gtag} (the same input "
        f"ungrouped): kernel_ms={p_ms:.4f} bound_ms="
        f"{bound_ms(pbytes, flops, spec)[0]:.4f}")

    # -- a prefix that is not a multiple of a split: 32-row pages ---------
    page, plen, s32 = 32, 160, 1024
    glens = torch.tensor([1024, 800, 600, 161], dtype=torch.int32,
                         device=dev)
    kp, vp, bt, live, groups = grouped_layout(torch, gen, randn, glens, plen,
                                              s32, hk, hd, page=page)
    q = randn(b, hq, hd)
    tag = f"B=4 PS={page} prefix {plen} (2.5 splits), 1024/800/600/161"
    for name in ("bf16", "int8"):
        if name == "bf16":
            (kc, ks), (vc, vs) = (kp, None), (vp, None)
        else:
            (kc, ks), (vc, vs) = (kvquant.quantize_pages(p, quant.INT8)
                                  for p in (kp, vp))
        kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
        nan_kw = dict(kw)
        if ks is None:
            kn, vn = poisoned(torch, (kc, vc), live)
        else:
            kn, vn = kc, vc
            read = live.any(dim=1)[:, None]
            nan_kw = {key: torch.where(read, st, torch.full_like(
                st, float("nan"))) for key, st in kw.items()}
        gout, gstat = ga.grouped_paged_decode_attention_unified_max(
            q, kc, vc, bt, glens, groups, phi=phi.phi, **kw)
        pout, pstat = da.paged_decode_attention_unified_max(
            q, kc, vc, bt, glens, phi=phi.phi, **kw)
        same = same_bits(torch, (gout, pout), (gstat, pstat))
        nan_out, _ = ga.grouped_paged_decode_attention_unified_max(
            q, kn, vn, bt, glens, groups, phi=phi.phi, **nan_kw)
        clean = same_bits(torch, (nan_out, gout))
        ok, tol = attn_close(
            gout, ga.grouped_paged_decode_attention_unified_max_plain(
                q, kc, vc, bt, glens, groups, phi=phi.phi, **kw)[0])
        log(f"kernel grouped_paged_decode_attention {name} {tag}: out and "
            f"stat bitwise the paged decode kernel {same}; unchanged with "
            f"NaN where it must not read {clean}; against its plain version "
            f"{'ok' if ok else 'MISMATCH'} ({tol})")
        check(same, f"grouped decode {name} {tag}: not bitwise row 5")
        check(clean, f"grouped decode {name} {tag}: reads what it must not")
        check(ok, f"grouped decode {name} {tag}: disagrees with its plain "
              "version")


def grouped_layout(torch, gen, randn, glens, plen, s_max, hk, hd,
                   page=PAGE):
    """Row 11's pool: every row's table leads with one shared ``plen``-
    token prefix (shuffled ``page``-row pages of a pool 8 pages larger
    than needed), then its own pages to ``glens[b]``. Returns the bf16
    pools, the tables, the (NP, page) mask of rows that hold a position
    some row reads, and the one-group ``DecodeGroups``."""
    from repro_torch.kernels import group_attention as ga
    b, dev = glens.shape[0], glens.device
    npre = plen // page
    own = [-(-int(n) // page) - npre for n in glens.tolist()]
    num_pages = npre + sum(own) + 8
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    kp, vp = (randn(num_pages, page, hk, hd) for _ in range(2))
    bt = torch.full((b, s_max // page), num_pages, dtype=torch.int32,
                    device=dev)
    live = torch.zeros((num_pages, page), dtype=torch.bool, device=dev)
    pre = perm[:npre].int()
    live[pre.long()] = True
    lo = npre
    for i, n in enumerate(own):
        pages = perm[lo:lo + n]
        lo += n
        bt[i, :npre] = pre
        bt[i, npre:npre + n] = pages.int()
        live[pages] = (npre * page + torch.arange(n * page, device=dev)
                       < int(glens[i])).reshape(n, page)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    groups = ga.DecodeGroups(
        tables=pre[None], n_pages=i32(npre), g_prefix_len=i32(plen),
        num_members=i32(b), member_rows=i32(*range(b))[None],
        gid=i32(*[0] * b), member=i32(*range(b)), prefix_len=i32(*[plen] * b))
    return kp, vp, bt, live, groups


def kv_quant_kernels(torch, cfg, gen, randn, record, attn_close, log):
    """Rows 5, 6, 9, 10 and both stages of 11 on int8 / fp8 KV pages: the
    bf16 rows' full-width inputs quantized page by page with
    ``kvquant.quantize_pages``. Each quantized body against its plain
    version (within ATTN_REL of each row's RMS), timed beside its bf16
    twin on the same shape, the plain version and the library chain
    (dequantize to bf16, then SDPA over a pre-gathered view); the grouped
    pair bitwise quantized row 5; NaN in the steps of every page a kernel
    must not read, and for fp8 the NaN code in every pool row that holds
    no position it reads, changes nothing; the scatter run on the card
    gives the CPU's codes and steps bitwise."""
    import torch.nn.functional as F

    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import group_attention as ga
    from repro_torch.kernels import ops, quant
    from repro_torch.kernels.ref import gather_paged_kv
    from repro_torch.serving import kvquant

    hd, hq, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    g = hq // hk
    dev, bf = "cuda", torch.bfloat16
    phi = cfg.softmax_phi
    b, s_max = 4, 1024

    def quantize(pools, qs):
        return [kvquant.quantize_pages(p, qs) for p in pools]

    def poison(qs, qpools, live):
        """NaN steps on every page with no live row; for fp8 also the NaN
        code (0x7f) in every row that is not live."""
        read = live.any(dim=1)[:, None]
        out = []
        for codes, steps in qpools:
            steps = torch.where(read, steps, torch.full_like(
                steps, float("nan")))
            if not qs.is_int:
                c8 = codes.view(torch.uint8)
                codes = torch.where(live[:, :, None, None], c8,
                                    torch.full_like(c8, 0x7F)).view(
                                        codes.dtype)
            out.append((codes, steps))
        return out

    def expanded(codes, steps, bt):
        """Codes gathered through the tables and GQA-expanded to (B, HQ,
        S, D), with their per-position steps (B, HQ, S, 1): the library
        chain's pre-gathered view (made once, outside the timing)."""
        c = gather_paged_kv(codes.view(torch.uint8), bt).view(
            codes.dtype).transpose(1, 2)
        st = steps[bt.long().clamp(max=codes.shape[0] - 1)]   # (B, NB, HK)
        st = st.repeat_interleave(PAGE, dim=1).transpose(1, 2)[..., None]
        return (c.repeat_interleave(g, dim=1), st.repeat_interleave(g, dim=1))

    def dequant(view):
        return (view[0].float() * view[1]).to(bf)

    def q_bytes(n_rows, n_pages, n_q, extra):
        """q and out once each (bf16), K and V codes of every row read,
        the steps of every page read, plus ``extra``."""
        return 4 * n_q * hq * hd + 2 * n_rows * hk * hd + 8 * n_pages * hk \
            + extra

    # -- rows 5-6: decode over a shuffled pool (row 3's shapes) ------------
    lengths = torch.tensor([1024, 517, 64, 3], dtype=torch.int32, device=dev)
    (kp, vp), bt, live = paged_layout(
        torch, gen, (randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)),
        lengths)
    n_valid = int(lengths.sum())
    n_pages = sum(-(-int(n) // PAGE) for n in lengths.tolist())
    dec_bytes = q_bytes(n_valid, n_pages, b, 4 * b * hk + 4 * bt.numel())
    dec_flops = 4 * n_valid * hq * hd
    mask = (torch.arange(s_max, device=dev)[None, :] < lengths[:, None])[
        :, None, None, :]
    q = randn(b, hq, hd)
    q4 = q[:, :, None, :]
    for qs in (quant.INT8, quant.FP8):
        slot = None if qs.is_int else "fp8"
        (kc, ks), (vc, vs) = quantize((kp, vp), qs)
        (kcn, ksn), (vcn, vsn) = poison(qs, ((kc, ks), (vc, vs)), live)
        kw = dict(k_scale=ks, v_scale=vs)
        kview, vview = expanded(kc, ks, bt), expanded(vc, vs, bt)
        lib = lambda: F.scaled_dot_product_attention(
            q4, dequant(kview), dequant(vview), attn_mask=mask)
        tag = f"{qs.name} B=4 S=1024 PS={PAGE} ragged shuffled"
        out, stat = da.paged_decode_attention_unified_max(
            q, kc, vc, bt, lengths, phi=phi.phi, **kw)
        want, want_stat = da.paged_decode_attention_unified_max_plain(
            q, kc, vc, bt, lengths, phi=phi.phi, **kw)
        check((stat - want_stat).abs().max().item()
              <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              f"quantized paged decode {qs.name}: stat disagrees")
        sync = da.paged_decode_attention_sync(q, kc, vc, bt, lengths, **kw)
        clean = same_bits(
            torch, (da.paged_decode_attention_unified_max(
                q, kcn, vcn, bt, lengths, phi=phi.phi, k_scale=ksn,
                v_scale=vsn)[0], out),
            (da.paged_decode_attention_sync(q, kcn, vcn, bt, lengths,
                                            k_scale=ksn, v_scale=vsn), sync))
        log(f"kernel paged_decode_attention {tag}: unchanged with NaN steps "
            f"on unread pages{'' if qs.is_int else ' and NaN codes in unread rows'}"
            f" {clean}")
        check(clean, f"quantized paged decode {tag}: reads what it must not")
        record("paged_decode_attention_unified_max_quant", tag, out, want,
               lambda: da.paged_decode_attention_unified_max(
                   q, kc, vc, bt, lengths, phi=phi.phi, **kw),
               lambda: da.paged_decode_attention_unified_max_plain(
                   q, kc, vc, bt, lengths, phi=phi.phi, **kw),
               lib, dec_bytes, dec_flops, True, attn_close,
               twin=lambda: da.paged_decode_attention_unified_max(
                   q, kp, vp, bt, lengths, phi=phi.phi), slot=slot)
        record("paged_decode_attention_sync_quant", tag, sync,
               da.paged_decode_attention_sync_plain(q, kc, vc, bt, lengths,
                                                    **kw),
               lambda: da.paged_decode_attention_sync(q, kc, vc, bt, lengths,
                                                      **kw),
               lambda: da.paged_decode_attention_sync_plain(
                   q, kc, vc, bt, lengths, **kw),
               lib, dec_bytes, dec_flops, True, attn_close,
               twin=lambda: da.paged_decode_attention_sync(q, kp, vp, bt,
                                                           lengths),
               slot=slot)
        # the front door with the recompute forced: s - phi > 40
        qo = q * 20.0
        got = ops.attention_decode_paged(qo, kc, vc, bt, lengths,
                                         phi_cfg=phi, plan=DEFAULT_PLAN, **kw)
        ok, tol = attn_close(got, da.paged_decode_attention_sync_plain(
            qo, kc, vc, bt, lengths, **kw))
        log(f"kernel ops.attention_decode_paged {tag}, s-phi>40: recompute "
            f"{'ok' if ok else 'MISMATCH'} ({tol})")
        check(ok, f"quantized ops.attention_decode_paged {tag} recompute")

    # -- row 11: four rows share one 512-token prefix (row 11's shapes) ----
    glens = torch.tensor([1024, 800, 600, 520], dtype=torch.int32,
                         device=dev)
    plen = 512
    kp, vp, bt, live, groups = grouped_layout(torch, gen, randn, glens, plen,
                                              s_max, hk, hd)
    n_keys = int(glens.sum())
    n_tail = n_keys - b * plen
    tail_pages = sum(-(-int(n) // PAGE) - plen // PAGE
                     for n in glens.tolist())
    tables = 4 * (bt.numel() + sum(t.numel() for t in groups))
    g_bytes = q_bytes(plen + n_tail, plen // PAGE + tail_pages, b,
                      4 * b * hk + tables)
    mg = b * g
    # the prefix's whole splits of stage 1's partials: num, den, stat (f32)
    parts_bytes = 4 * (plen // 64) * hk * mg * (hd + 2)
    t_bytes = q_bytes(n_tail, tail_pages, b,
                      parts_bytes + 4 * b * hk + 4 * bt.numel() + 4 * 3 * b)
    gmask = (torch.arange(s_max, device=dev)[None, :] < glens[:, None])[
        :, None, None, :]
    for qs in (quant.INT8, quant.FP8):
        slot = None if qs.is_int else "fp8"
        (kc, ks), (vc, vs) = quantize((kp, vp), qs)
        (kcn, ksn), (vcn, vsn) = poison(qs, ((kc, ks), (vc, vs)), live)
        kw = dict(phi=phi.phi, k_scale=ks, v_scale=vs)
        kview, vview = expanded(kc, ks, bt), expanded(vc, vs, bt)
        lib = lambda: F.scaled_dot_product_attention(
            q4, dequant(kview), dequant(vview), attn_mask=gmask)
        tag = f"{qs.name} B=4 PS={PAGE} prefix 512, 1024/800/600/520"
        gout, gstat = ga.grouped_paged_decode_attention_unified_max(
            q, kc, vc, bt, glens, groups, **kw)
        pout, pstat = da.paged_decode_attention_unified_max(
            q, kc, vc, bt, glens, **kw)
        same = same_bits(torch, (gout, pout), (gstat, pstat))
        clean = same_bits(torch, (ga.grouped_paged_decode_attention_unified_max(
            q, kcn, vcn, bt, glens, groups, phi=phi.phi, k_scale=ksn,
            v_scale=vsn)[0], gout))
        log(f"kernel grouped_paged_decode_attention {tag}: out and stat "
            f"bitwise the quantized paged decode kernel {same}; unchanged "
            f"with NaN where it must not read {clean}")
        check(same, f"quantized grouped decode {tag}: not bitwise row 5")
        check(clean, f"quantized grouped decode {tag}: reads what it must "
              "not")
        want = ga.grouped_paged_decode_attention_unified_max_plain(
            q, kc, vc, bt, glens, groups, **kw)[0]
        record("grouped_paged_decode_attention_unified_max_quant", tag, gout,
               want, lambda: ga.grouped_paged_decode_attention_unified_max(
                   q, kc, vc, bt, glens, groups, **kw),
               lambda: ga.grouped_paged_decode_attention_unified_max_plain(
                   q, kc, vc, bt, glens, groups, **kw),
               lib, g_bytes, 4 * n_keys * hq * hd, True, attn_close,
               twin=lambda: ga.grouped_paged_decode_attention_unified_max(
                   q, kp, vp, bt, glens, groups, phi=phi.phi), slot=slot)
        # stage 2 alone, on stage 1's partials
        parts = ga.group_prefix_partials(q, kc, vc, groups, **kw)
        bparts = ga.group_prefix_partials(q, kp, vp, groups, phi=phi.phi)
        record("grouped_decode_stage2_quant", tag + ", stage 2",
               ga.group_tail_merge(q, kc, vc, bt, glens, groups, *parts,
                                   **kw)[0],
               ga.group_tail_plain(q, kc, vc, bt, glens, groups, *parts,
                                   **kw)[0],
               lambda: ga.group_tail_merge(q, kc, vc, bt, glens, groups,
                                           *parts, **kw),
               lambda: ga.group_tail_plain(q, kc, vc, bt, glens, groups,
                                           *parts, **kw),
               None, t_bytes, 4 * n_tail * hq * hd, True, attn_close,
               twin=lambda: ga.group_tail_merge(q, kp, vp, bt, glens, groups,
                                                *bparts, phi=phi.phi),
               slot=slot)

    # -- rows 9-10: a 64-token chunk over the pool (row 9's shapes) --------
    c = 64
    before = torch.tensor([960, 453, 0, 128], dtype=torch.int32, device=dev)
    (kp, vp), bt, live = paged_layout(
        torch, gen, (randn(b, s_max, hk, hd), randn(b, s_max, hk, hd)),
        before + c)
    qpos = before[:, None] + torch.arange(c, device=dev)[None, :]
    cmask = (torch.arange(s_max, device=dev)[None, None, :]
             <= qpos[:, :, None])[:, None]                   # (B,1,C,S)
    pairs = int(c * before.sum().item() + b * c * (c + 1) // 2)
    n_rows = int((before + c).sum())
    ch_pages = sum(-(-int(n) // PAGE) for n in (before + c).tolist())
    ch_bytes = q_bytes(n_rows, ch_pages, b * c,
                       4 * b * hk + 4 * bt.numel() + 4 * b)
    qc = randn(b, c, hq, hd)
    qe = qc.transpose(1, 2)
    for qs in (quant.INT8, quant.FP8):
        slot = None if qs.is_int else "fp8"
        (kc, ks), (vc, vs) = quantize((kp, vp), qs)
        (kcn, ksn), (vcn, vsn) = poison(qs, ((kc, ks), (vc, vs)), live)
        kw = dict(k_scale=ks, v_scale=vs)
        kview, vview = expanded(kc, ks, bt), expanded(vc, vs, bt)
        lib = lambda: F.scaled_dot_product_attention(
            qe, dequant(kview), dequant(vview), attn_mask=cmask)
        tag = f"{qs.name} B=4 C={c} PS={PAGE} lengths 960/453/0/128"
        out, stat = ca.paged_chunk_attention_unified_max(
            qc, kc, vc, bt, before, phi=phi.phi, **kw)
        want, want_stat = ca.paged_chunk_attention_unified_max_plain(
            qc, kc, vc, bt, before, phi=phi.phi, **kw)
        check((stat - want_stat).abs().max().item()
              <= 1e-2 * max(1.0, want_stat.abs().max().item()),
              f"quantized paged chunk {qs.name}: stat disagrees")
        sync = ca.paged_chunk_attention_sync(qc, kc, vc, bt, before, **kw)
        clean = same_bits(
            torch, (ca.paged_chunk_attention_unified_max(
                qc, kcn, vcn, bt, before, phi=phi.phi, k_scale=ksn,
                v_scale=vsn)[0], out),
            (ca.paged_chunk_attention_sync(qc, kcn, vcn, bt, before,
                                           k_scale=ksn, v_scale=vsn), sync))
        log(f"kernel paged_chunk_attention {tag}: unchanged with NaN where "
            f"it must not read {clean}")
        check(clean, f"quantized paged chunk {tag}: reads what it must not")
        record("paged_chunk_attention_unified_max_quant", tag, out, want,
               lambda: ca.paged_chunk_attention_unified_max(
                   qc, kc, vc, bt, before, phi=phi.phi, **kw),
               lambda: ca.paged_chunk_attention_unified_max_plain(
                   qc, kc, vc, bt, before, phi=phi.phi, **kw),
               lib, ch_bytes, 4 * pairs * hq * hd, True, attn_close,
               twin=lambda: ca.paged_chunk_attention_unified_max(
                   qc, kp, vp, bt, before, phi=phi.phi), slot=slot)
        record("paged_chunk_attention_sync_quant", tag, sync,
               ca.paged_chunk_attention_sync_plain(qc, kc, vc, bt, before,
                                                   **kw),
               lambda: ca.paged_chunk_attention_sync(qc, kc, vc, bt, before,
                                                     **kw),
               lambda: ca.paged_chunk_attention_sync_plain(
                   qc, kc, vc, bt, before, **kw),
               lib, ch_bytes, 4 * pairs * hq * hd, True, attn_close,
               twin=lambda: ca.paged_chunk_attention_sync(qc, kp, vp, bt,
                                                          before),
               slot=slot)

    # -- the scatter on the card: the CPU's codes and steps, bitwise ----------
    # a dirty pool (a loud earlier tenant), then a ragged 64-token chunk
    # (spectator, sentinel page, mid-page start: rescale, page entries),
    # then a decode append of one token per row
    for qs in (quant.INT8, quant.FP8):
        num_pages = 40
        codes, steps = kvquant.quantize_pages(
            randn(num_pages, PAGE, hk, hd, scale=30.0), qs)
        bt = torch.randperm(num_pages, generator=gen, device=dev)[
            :b * 8].reshape(b, 8).int()
        bt[3, 1:] = num_pages
        writes = [(randn(b, c, hk, hd), [100, 0, 37, 50], [64, 0, 64, 40]),
                  (randn(b, 1, hk, hd), [164, 0, 101, 90], [1, 1, 1, 1])]
        card = (codes.clone(), steps.clone())
        host = (codes.cpu(), steps.cpu())
        for new, lens, clens in writes:
            for (cd, st), where in ((card, dev), (host, "cpu")):
                kvquant.scatter_chunk_quantized(
                    cd, st, new.to(where), bt.to(where),
                    torch.tensor(lens, dtype=torch.int32, device=where),
                    torch.tensor(clens, dtype=torch.int32, device=where), qs)
        same = {what: same_bits(torch, (a.cpu(), h)) for what, a, h in (
            ("codes", card[0], host[0]), ("steps", card[1], host[1]))}
        log(f"kvquant {qs.name}: the scatter on the card (a 64-token ragged "
            f"chunk over a dirty {num_pages}-page pool, then a decode "
            f"append) bitwise the CPU's: codes {same['codes']}, steps "
            f"{same['steps']}")
        check(all(same.values()), f"kvquant {qs.name}: the card's scatter "
              "differs from the CPU's")


# ---------------------------------------------------------------------------
# phase 3-4: serving and logits
# ---------------------------------------------------------------------------


# the two grouped stages under their names in REPLACES (the JAX entry is
# stage 1; stage 2 is logged beside it and must launch as often)
COUNTER_NAMES = {"group_prefix_partials":
                 "grouped_paged_decode_attention_unified_max",
                 "group_tail_merge": "grouped_decode_stage2",
                 "group_prefix_partials_quant":
                 "grouped_paged_decode_attention_unified_max_quant",
                 "group_tail_merge_quant": "grouped_decode_stage2_quant"}


def counters():
    """Every kernel wrapper's launch counter, by its name in REPLACES.
    Built from ``ops.LAUNCH_COUNTERS``, the registry that CUDA-graph
    replays credit, so no counter read here can miss the replays."""
    from repro_torch.kernels.ops import LAUNCH_COUNTERS
    return {COUNTER_NAMES.get(fn.__name__, fn.__name__): fn
            for fn in LAUNCH_COUNTERS}


def trace_replays(lp):
    """Record, for every graph replay of the LoopedDecode ``lp``, which
    graph ran: its index in capture order (a capture is replayed at
    once). Returns the list it fills."""
    order, seq = [], []
    run = lp.run

    def traced(step, inputs, anchors):
        n = lp.replays
        out = run(step, inputs, anchors)
        if lp.replays > n:
            i = next((i for i, o in enumerate(order) if o is out), None)
            if i is None:
                i = len(order)
                order.append(out)
            seq.append(i)
        return out

    lp.run = traced
    return seq


def returns(seq) -> int:
    """Replays that went back to a graph captured before the one just
    replayed."""
    return sum(1 for a, b in zip(seq, seq[1:]) if b < a)


HEADER = 128          # shared system-prompt tokens of runs E to H, K and L
SHARED_NEW = 96       # > one page of growth past admission's headroom
F_PAGES = 16          # run F's pool: one preemption at these lengths


def shared_requests(np, cfg, seed, n=8):
    """Requests that all start with one HEADER-token prompt: tail lengths
    are drawn first, so they do not depend on the vocabulary size."""
    from repro_torch.serving.request import SamplingParams
    rng = np.random.default_rng(seed + 1)
    tails = rng.integers(8, 173, size=n)
    header = rng.integers(1, cfg.vocab_size, size=HEADER)
    sp = SamplingParams(max_new_tokens=SHARED_NEW)
    return [(np.concatenate([header, rng.integers(
        1, cfg.vocab_size, size=int(t))]).astype(np.int32), sp)
        for t in tails]


def mixed_requests(np, cfg, seed, n=24):
    """Runs L and L': two HEADER-token system prompts taken in turn, and
    8 to 40 new tokens per request. As requests come and go the slots
    hold two groups of two, one group of three or four, or one of two,
    so the grouped plan's (NG, LP, M) bucket changes back and forth and
    the looped engine replays several graphs in turn."""
    from repro_torch.serving.request import SamplingParams
    rng = np.random.default_rng(seed + 2)
    tails = rng.integers(8, 173, size=n)
    news = rng.integers(8, 41, size=n)
    headers = [rng.integers(1, cfg.vocab_size, size=HEADER)
               for _ in range(2)]
    return [(np.concatenate([headers[i % 2], rng.integers(
        1, cfg.vocab_size, size=int(t))]).astype(np.int32),
        SamplingParams(max_new_tokens=int(m)))
        for i, (t, m) in enumerate(zip(tails, news))]


def tuned_plan():
    """Run H's plan: the JAX package's tuned serving plan on the kernel
    backend (grouped decode, fused FFN-up)."""
    from repro_torch.core.plan import make_plan
    return make_plan("cuda", decode_group="grouped")


def looped_plan(granularity="looped"):
    """Run K's plan: run H's with the looped decode granularity (fused
    stage kernels, the decode step replayed as one CUDA graph); with
    ``"fused"``, its eager twin (runs K' and L')."""
    from repro_torch.core.plan import make_plan
    return make_plan("cuda", decode_group="grouped",
                     decode_fusion=granularity)


def serve_runs():
    """(tag, engine kwargs, request set, kernels that must launch) of every
    serve run."""
    from repro_torch.core.plan import make_plan
    paged = dict(cache_kind="paged", page_size=PAGE)
    attn = ("paged_decode_attention_unified_max",
            "paged_decode_attention_sync")
    fused = attn + ("paged_chunk_attention_unified_max",
                    "paged_chunk_attention_sync")
    # every decode tick of G and H finds a group, so the ungrouped T1
    # kernel need not launch there
    grouped = ("paged_decode_attention_sync",
               "paged_chunk_attention_unified_max",
               "paged_chunk_attention_sync",
               "grouped_paged_decode_attention_unified_max",
               "grouped_decode_stage2")
    # the fused decode stages: ingest, o_proj + residual, ffn_norm, and
    # the down projection through oproj_residual again
    stages = ("decode_ingest_fused", "oproj_residual_fused",
              "ffn_norm_fused")
    dense_fused = ("flat_gemm", "decode_attention_unified_max",
                   "decode_attention_sync") + stages
    # quantized weights: every layer GEMM through a quantized variant
    q_stages = tuple(n + "_quant" for n in stages)
    # quantized KV pages: every attention through a quantized body
    q_fused = tuple(n + "_quant" for n in fused)
    q_grouped = ("paged_decode_attention_sync_quant",
                 "paged_chunk_attention_unified_max_quant",
                 "paged_chunk_attention_sync_quant",
                 "grouped_paged_decode_attention_unified_max_quant",
                 "grouped_decode_stage2_quant")
    return [
        ("A slots=4 chunked prefill", dict(num_slots=4), "plain",
         ("flat_gemm", "decode_attention_unified_max",
          "decode_attention_sync")),
        ("B slots=1 chunked prefill", dict(num_slots=1), "plain",
         ("gemv", "flat_gemm", "decode_attention_unified_max")),
        ("C slots=4 prefill_chunk=0", dict(num_slots=4, prefill_chunk=0),
         "plain", ("flat_gemm", "flash_prefill_unified_max",
                   "flash_prefill_sync")),
        ("D slots=4 paged gather", dict(num_slots=4, plan=make_plan(
            "cuda", gather_chunk="dense", fused_ffn=False), **paged),
         "plain",
         ("flat_gemm",) + attn),
        ("E slots=4 paged fused sharing", dict(
            num_slots=4, prefix_sharing=True, **paged), "shared", fused),
        ("E' slots=4 paged fused", dict(num_slots=4, **paged), "shared",
         fused),
        (f"F slots=4 paged fused sharing num_pages={F_PAGES}", dict(
            num_slots=4, prefix_sharing=True, num_pages=F_PAGES, **paged),
         "shared", fused),
        ("G slots=4 paged fused sharing grouped decode", dict(
            num_slots=4, prefix_sharing=True, plan=make_plan(
                "cuda", decode_group="grouped", fused_ffn=False), **paged),
         "shared", grouped),
        ("H slots=4 paged fused sharing grouped decode fused FFN-up", dict(
            num_slots=4, prefix_sharing=True, plan=tuned_plan(), **paged),
         "shared", grouped + ("fused_ffn_up",)),
        ("I slots=4 chunked prefill fused stages", dict(
            num_slots=4, decode_fusion="fused"), "plain", dense_fused),
        ("J slots=4 chunked prefill looped", dict(
            num_slots=4, decode_fusion="looped"), "plain", dense_fused),
        ("K slots=4 paged fused sharing grouped decode fused FFN-up looped",
         dict(num_slots=4, prefix_sharing=True, plan=looped_plan(), **paged),
         "shared", grouped + ("fused_ffn_up",) + stages),
        ("K' slots=4 K's plan with the fused stages, eager", dict(
            num_slots=4, prefix_sharing=True, plan=looped_plan("fused"),
            **paged), "shared", grouped + ("fused_ffn_up",) + stages),
        ("L slots=4 K's plan, two headers, varied lengths", dict(
            num_slots=4, prefix_sharing=True, plan=looped_plan(), **paged),
         "mixed", grouped + ("fused_ffn_up",) + stages),
        ("L' slots=4 L with the fused stages, eager", dict(
            num_slots=4, prefix_sharing=True, plan=looped_plan("fused"),
            **paged), "mixed", grouped + ("fused_ffn_up",) + stages),
        ("M slots=4 chunked prefill int8 weights", dict(
            num_slots=4, weight_dtype="int8"), "plain16",
         ("flat_gemm_quant", "decode_attention_unified_max")),
        ("N slots=1 chunked prefill int8 weights", dict(
            num_slots=1, weight_dtype="int8"), "plain16",
         ("gemv_quant", "flat_gemm_quant")),
        ("O slots=4 looped fp8 weights", dict(
            num_slots=4, decode_fusion="looped", weight_dtype="fp8"),
         "plain16", q_stages),
        ("O' slots=4 O with the fused stages, eager", dict(
            num_slots=4, decode_fusion="fused", weight_dtype="fp8"),
         "plain16", q_stages),
        ("P slots=4 K's plan int8 weights", dict(
            num_slots=4, prefix_sharing=True, plan=looped_plan(),
            weight_dtype="int8", **paged), "shared32",
         grouped + ("fused_ffn_up_quant",) + q_stages),
        ("Q slots=4 E with int8 KV pages", dict(
            num_slots=4, prefix_sharing=True, kv_dtype="int8", **paged),
         "shared", q_fused),
        ("Q' slots=4 E' with int8 KV pages", dict(
            num_slots=4, kv_dtype="int8", **paged), "shared", q_fused),
        ("R slots=4 G with int8 KV pages", dict(
            num_slots=4, prefix_sharing=True, kv_dtype="int8",
            plan=make_plan("cuda", decode_group="grouped", fused_ffn=False),
            **paged), "shared", q_grouped),
        ("S slots=4 K with fp8 KV pages", dict(
            num_slots=4, prefix_sharing=True, kv_dtype="fp8",
            plan=looped_plan(), **paged), "shared",
         q_grouped + ("fused_ffn_up",) + stages),
        ("S' slots=4 S with the fused stages, eager", dict(
            num_slots=4, prefix_sharing=True, kv_dtype="fp8",
            plan=looped_plan("fused"), **paged), "shared",
         q_grouped + ("fused_ffn_up",) + stages),
    ]


def count_pages_read(eng):
    """Count, beside the engine's own counter, the pages every decode
    tick's resident rows hold when the step runs (the pages decode
    attention reads). Returns a one-element list it fills."""
    import dataclasses
    total = [0]
    step = eng.api.decode_step

    def counted(*args, **kw):
        total[0] += sum(len(eng.slots.slots[i].pages) for i in eng.by_slot)
        return step(*args, **kw)

    if eng.pool is not None:
        eng.api = dataclasses.replace(eng.api, decode_step=counted)
    return total


def serve_phase(torch, cfg, params, request_sets, log, launches):
    from repro_torch.serving.engine import Engine

    # warm-up (allocator, library handles) so the first timed run is not
    # charged for one-time set-up; its launches are not counted
    Engine(cfg, params, num_slots=4, max_seq=1024, device="cuda").run(
        request_sets["plain"][:2])

    outputs, engines, replayed = {}, {}, {}
    for tag, kw, which, expect in serve_runs():
        requests = request_sets[which]
        eng = Engine(cfg, params, max_seq=1024, device="cuda", **kw)
        if eng.ctx.graphs is not None:
            replayed[tag.split()[0]] = trace_replays(eng.ctx.graphs)
        pages_read = count_pages_read(eng)
        for fn in counters().values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = eng.run(requests)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in counters().items()}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        total = sum(len(v) for v in out.values())
        st = eng.stats
        paged = ""
        if eng.pool is not None:
            paged = (f"; pool {eng.pool.num_pages} pages, peak "
                     f"{st.peak_pages_used}, preemptions {st.preemptions}, "
                     f"shared prefix pages {st.shared_prefix_pages}, saved "
                     f"prefill tokens {st.saved_prefill_tokens}, COW forks "
                     f"{st.cow_forks}, grouped decodes "
                     f"{st.grouped_requests}, prefix KV bytes saved "
                     f"{st.prefix_kv_bytes_saved}")
        graphs = ""
        if eng.ctx.graphs is not None:
            lp = eng.ctx.graphs
            seq = replayed[tag.split()[0]]
            graphs = (f"; graphs: {st.graph_captures} captured, "
                      f"{st.graph_replays} replays, {lp.eager_ticks} eager "
                      f"first ticks, {returns(seq)} replays back to an "
                      "earlier-captured graph")
            check(st.graph_replays == eng.ticks - lp.eager_ticks,
                  f"{tag}: {st.graph_replays} replays in {eng.ticks} ticks "
                  f"with {lp.eager_ticks} eager first ticks")
            check(0 < st.graph_captures <= lp.eager_ticks,
                  f"{tag}: {st.graph_captures} graphs for "
                  f"{lp.eager_ticks} keys")
        digest = hashlib.sha256(json.dumps(
            sorted(out.items())).encode()).hexdigest()[:16]
        log(f"serve {tag}: {len(out)} requests, {total} tokens in "
            f"{dt:.3f}s = {total / dt:.1f} tok/s; {eng.ticks} decode ticks "
            f"at {1e3 * st.decode_seconds / max(eng.ticks, 1):.3f} ms/tick; "
            f"prefill {st.prefill_seconds:.3f}s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB{paged}"
            f"{graphs}; weights {eng.weight_dtype}, "
            f"{st.weight_bytes_decode_read} decode weight bytes read; "
            f"kv {eng.kv_dtype}, {st.kv_page_bytes} B/page, "
            f"{st.kv_bytes_decode_read} decode KV bytes read; "
            f"tokens sha256 {digest}; launches {json.dumps(counts)}")
        # the stored weight stream per decode tick, at the launched width
        # (a tick that preemption left with no row reads none)
        per_tick = WEIGHT_BYTES_PER_LAYER[eng.weight_dtype] * cfg.num_layers
        read = st.weight_bytes_decode_read
        check(read == eng.ticks * per_tick if not st.preemptions else
              read % per_tick == 0 and read <= eng.ticks * per_tick,
              f"{tag}: {read} weight bytes in {eng.ticks} ticks")
        # a quantized run launches no bf16 layer-GEMM kernel (its codes
        # are never dequantized ahead of one) and a bf16 run no quantized
        # variant; only the LM head (tied, bf16) uses gemv / flat_gemm
        if eng.weight_dtype == "bf16":
            idle = [n for n in counts if n.endswith("_quant")
                    and n not in KV_QUANT]
        else:
            idle = [n[:-len("_quant")] for n in counts
                    if n.endswith("_quant") and n not in KV_QUANT
                    and n not in ("gemv_quant", "flat_gemm_quant")]
        # a quantized-KV run launches no bf16 attention body (its codes
        # are never dequantized ahead of one), a bf16 run no quantized one
        idle += list(KV_QUANT if eng.kv_dtype == "bf16" else BF16_ATTENTION)
        for n in idle:
            check(counts[n] == 0, f"{tag}: kernel {n} launched {counts[n]} "
                  "times")
        if eng.pool is not None:
            # every decode tick reads each resident page's stored slab
            page = KV_PAGE_BYTES_PER_LAYER[eng.kv_dtype] * cfg.num_layers
            check(st.kv_page_bytes == page, f"{tag}: {st.kv_page_bytes} "
                  f"B per page, not {page}")
            check(st.kv_bytes_decode_read == pages_read[0] * page > 0,
                  f"{tag}: {st.kv_bytes_decode_read} decode KV bytes for "
                  f"{pages_read[0]} pages read")
        for rid, toks in out.items():
            check(len(toks) == requests[rid][1].max_new_tokens,
                  f"{tag}: request {rid} produced {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"{tag}: request {rid} produced an out-of-vocab token")
            check(eng.finish_reason(rid).value == "length",
                  f"{tag}: request {rid} finished early")
        for n in expect:
            check(counts[n] > 0, f"{tag}: kernel {n} was never launched")
        for q in ("", "_quant"):
            check(counts["grouped_decode_stage2" + q] == counts[
                "grouped_paged_decode_attention_unified_max" + q],
                f"{tag}: the grouped stages launched unequally")
        outputs[tag.split()[0]] = out
        engines[tag.split()[0]] = eng
    # the paged contracts: dense = paged, sharing on = off, and a clean
    # pool after preemption
    check(outputs["D"] == outputs["A"], "run D's tokens differ from A's")
    check(engines["E"].stats.shared_prefix_pages > 0,
          "run E shared no prefix page")
    check(outputs["E"] == outputs["E'"], "run E's tokens differ from E′'s")
    f = engines["F"]
    check(f.stats.preemptions > 0, "run F preempted nothing")
    f.slots.check()
    check(f.pool.used_pages == 0, f"run F left {f.pool.used_pages} pages "
          "allocated")
    def agree(a, b):
        return sum(sum(1 for x, y in zip(outputs[a][r], outputs[b][r])
                       if x == y) for r in outputs[a])

    def agree16(a, b):
        """Positions where b's tokens (a shorter run of the same requests)
        match a's."""
        return sum(sum(1 for x, y in zip(outputs[a][r], outputs[b][r])
                       if x == y) for r in outputs[b])

    total = sum(len(v) for v in outputs["E"].values())
    log(f"serve paged contracts: D == A tokens; E shared "
        f"{engines['E'].stats.shared_prefix_pages} prefix pages, E == E′ "
        f"tokens; F {f.stats.preemptions} preemptions, slots.check() ok, "
        f"pool empty after; F agrees with E on {agree('E', 'F')}/{total} "
        f"tokens")
    g = engines["G"].stats
    check(outputs["G"] == outputs["E"], "run G's tokens differ from E's")
    check(g.grouped_requests > 0 and g.prefix_kv_bytes_saved > 0,
          "run G grouped no decode")
    log(f"serve grouped contracts: G == E tokens with {g.grouped_requests} "
        f"grouped decodes, {g.prefix_kv_bytes_saved} prefix KV bytes saved; "
        f"H (fused FFN-up) agrees with E on {agree('E', 'H')}/{total} "
        f"tokens")
    check(outputs["J"] == outputs["I"], "run J's tokens differ from I's")
    k = engines["K"].stats
    check(k.grouped_requests > 0, "run K grouped no decode")
    check(outputs["K"] == outputs["K'"], "run K's tokens differ from K′'s")
    # L: several graphs in one shared pool, replayed in turn, not in
    # capture order, and still token for token its eager twin
    el = engines["L"].stats
    back = returns(replayed["L"])
    check(outputs["L"] == outputs["L'"], "run L's tokens differ from L′'s")
    check(el.graph_captures >= 2, f"run L captured {el.graph_captures} "
          "graph(s); its traffic should change the group bucket")
    check(back > 0, "run L never went back to an earlier-captured graph")
    check(outputs["O"] == outputs["O'"], "run O's tokens differ from O′'s")
    plain16 = sum(len(v) for v in outputs["M"].values())
    log(f"serve quantized-weight contracts: O == O′ tokens "
        f"({sum(len(v) for v in outputs['O'].values())}); weight bytes per "
        f"decode tick {WEIGHT_BYTES_PER_LAYER['int8'] * cfg.num_layers} "
        f"(int8, fp8) against "
        f"{WEIGHT_BYTES_PER_LAYER['bf16'] * cfg.num_layers} (bf16); M "
        f"(int8) agrees with A "
        f"on the first 16 tokens of each request at "
        f"{agree16('A', 'M')}/{plain16} positions, O (fp8) with J at "
        f"{agree16('J', 'O')}/{plain16}; P (int8, "
        f"{engines['P'].stats.graph_replays} replays) with K at "
        f"{agree16('K', 'P')}/{sum(len(v) for v in outputs['P'].values())}")
    # quantized KV pages: the codes are a pure function of the write
    # history, so sharing, grouping and the looped graph keep the tokens
    check(outputs["Q"] == outputs["Q'"], "run Q's tokens differ from Q′'s")
    check(outputs["R"] == outputs["Q"], "run R's tokens differ from Q's")
    check(outputs["S"] == outputs["S'"], "run S's tokens differ from S′'s")
    check(engines["R"].stats.grouped_requests > 0
          and engines["S"].stats.grouped_requests > 0,
          "runs R and S grouped no decode")
    log(f"serve quantized-KV contracts: Q == Q′ == R tokens ({total}), "
        f"S == S′ tokens; KV bytes per page "
        f"{KV_PAGE_BYTES_PER_LAYER['int8'] * cfg.num_layers} (int8, fp8) "
        f"against {KV_PAGE_BYTES_PER_LAYER['bf16'] * cfg.num_layers} "
        f"(bf16); decode KV bytes "
        f"read E {engines['E'].stats.kv_bytes_decode_read}, Q "
        f"{engines['Q'].stats.kv_bytes_decode_read}, K "
        f"{engines['K'].stats.kv_bytes_decode_read}, S "
        f"{engines['S'].stats.kv_bytes_decode_read}; Q (int8) agrees with "
        f"E on {agree('E', 'Q')}/{total} tokens, S (fp8, "
        f"{engines['S'].stats.graph_replays} replays) with K on "
        f"{agree('K', 'S')}/{total}")
    plain_total = sum(len(v) for v in outputs["A"].values())
    log(f"serve fusion contracts: J == I tokens; I (fused stages) agrees "
        f"with A on {agree('A', 'I')}/{plain_total} tokens; K == K′ "
        f"tokens; K (looped, {k.graph_replays} replays) agrees with H on "
        f"{agree('H', 'K')}/{total} tokens, {k.grouped_requests} grouped "
        f"decodes; L == L′ tokens ({sum(len(v) for v in outputs['L'].values())}"
        f") with {el.graph_captures} graphs in one pool, "
        f"{back} replays back to an earlier-captured graph")
    return outputs


def chunk_profile_phase(torch, cfg, params, shared, log, tag="E",
                        **engine_kw):
    """Where a run's chunk steps spend the card: one run (warm; run E's
    engine unless ``engine_kw`` says otherwise) with every
    ``api.prefill_chunk`` call under torch.profiler, its device busy time
    (sum of kernel times), the shares of the fused chunk attention
    kernels and of the fused FFN-up in it, and the step's wall on the
    host clock. Returns the steps' (busy, attention, FFN-up, wall) in ms,
    None when the profiler reported no device time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, num_slots=4, max_seq=1024, device="cuda",
                 prefix_sharing=True, cache_kind="paged", page_size=PAGE,
                 **engine_kw)
    real = eng.api.prefill_chunk
    steps = []

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = real(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
        attn = [e for e in evs if "split_kernel" in e.key
                or "combine_kernel" in e.key]
        ffn = [e for e in evs if "ffn_up" in e.key]
        steps.append((sum(e.self_device_time_total for e in evs) / 1e3,
                      sum(e.self_device_time_total for e in attn) / 1e3,
                      sum(e.self_device_time_total for e in ffn) / 1e3,
                      1e3 * wall))
        return res

    eng.api = dataclasses.replace(eng.api, prefill_chunk=profiled)
    eng.run(shared)
    busy = sum(b for b, _, _, _ in steps)
    if busy == 0:
        log(f"profile {tag} chunk steps: device time not measured (the "
            "profiler reported none)")
        return
    n = len(steps)
    log(f"profile {tag} chunk steps: {n} steps, device busy "
        f"{busy / n:.3f} ms/step (fused chunk attention "
        f"{sum(a for _, a, _, _ in steps) / n:.3f}, fused FFN-up "
        f"{sum(u for _, _, u, _ in steps) / n:.3f}), wall "
        f"{sum(w for _, _, _, w in steps) / n:.3f} ms/step; per step busy "
        + " ".join(f"{b:.3f}" for b, _, _, _ in steps))
    return steps


def profile_phase(torch, cfg, params, requests, log, tag="slots=4",
                  slots=4, ranges=(), max_seq=1024, **engine_kw):
    """Where a decode tick's time goes at ``slots`` slots (four requests
    submitted), with the GEMV kernels' share of it: 8 steady ticks timed
    on the host clock without the profiler, then 8 more under
    torch.profiler for the device busy time (sum of kernel times) and
    the costliest device kernels. The idle share is given against both
    walls: the profiled window's own (busy and wall from one window, the
    wall inflated by the profiler) and the unprofiled window's (adjacent
    ticks of the same engine, the wall a serving user sees). The
    admission step before the window (one prefill wave and one tick)
    reports its kernel launches too. ``ranges`` names
    ``record_function`` ranges whose device time (the kernels launched
    inside them) is reported with its share of busy. Returns (busy,
    unprofiled wall) in ms a tick, None when the profiler reported no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    eng = Engine(cfg, params, num_slots=slots, max_seq=max_seq,
                 device="cuda", **engine_kw)
    for p, _ in requests[:4]:
        eng.submit(p, SamplingParams(max_new_tokens=40))
    for fn in counters().values():
        fn.launches = 0
    eng.step()                          # admission + prefill + one tick
    first = {name: fn.launches for name, fn in counters().items()
             if fn.launches}
    log(f"profile {tag}: launches of the admission step (prefill wave "
        f"and one decode tick) {json.dumps(first)}")
    for _ in range(2):
        eng.step()                      # warm ticks
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n
    for fn in counters().values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    per_tick = {name: fn.launches / n for name, fn in counters().items()
                if fn.launches}
    graphs = ""
    if eng.ctx.graphs is not None:
        graphs = (f" (graphs after the window: {eng.stats.graph_captures} "
                  f"captured, {eng.stats.graph_replays} replays)")
    log(f"profile {tag} decode: kernel launches per tick "
        f"{json.dumps(per_tick)}{graphs}")
    # device-side events only (the aten ops that launched them carry the
    # same time again as their own "self device" time)
    # (a record_function range also appears as a device-side span: not a
    # kernel, so not busy time)
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in evs) / n
    if busy_us == 0:
        log(f"profile {tag} decode: device time not measured (the "
            "profiler reported none)")
        return
    gemv_us = sum(e.self_device_time_total for e in evs
                  if "gemv" in e.key) / n
    log(f"profile {tag} decode ({n} ticks each window): device busy "
        f"{busy_us / 1e3:.3f} ms/tick; profiled wall {1e3 * wall:.3f} "
        f"ms/tick, device idle {100 * (1 - busy_us / 1e6 / wall):.1f}%; "
        f"unprofiled wall {1e3 * plain_wall:.3f} ms/tick, device idle "
        f"{100 * (1 - busy_us / 1e6 / plain_wall):.1f}%; gemv kernels "
        f"{gemv_us / 1e3:.3f} ms/tick ({100 * gemv_us / busy_us:.1f}% of "
        f"busy)")
    for rng in ranges:
        # the host-side range's device time (its kernels' time) and its
        # device-side span (first kernel start to last kernel end)
        us, span = (sum(e.device_time_total if cpu else
                        e.self_device_time_total
                        for e in prof.key_averages() if e.key == rng and (
                            e.device_type == torch.autograd.DeviceType.CPU)
                        == cpu) / n for cpu in (True, False))
        log(f"profile {tag} decode: range {rng} {us / 1e3:.3f} ms/tick of "
            f"kernel time ({100 * us / busy_us:.1f}% of busy), device span "
            f"{span / 1e3:.3f} ms/tick")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"profile   {e.self_device_time_total / n / 1e3:8.4f} ms/tick "
            f"{e.count // n:5d} calls/tick  {e.key[:90]}")
    name = "decode_profile.txt" if tag == "slots=4" else \
        f"decode_profile_{tag.split()[0]}.txt"
    (OUT_DIR / name).write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    return busy_us / 1e3, 1e3 * plain_wall


def tick_profiles(torch, cfg, params, requests, shared, log):
    """The decode tick of A (4 slots) and of the 1-slot runs B and N
    (bf16, int8 weights: the GEMV's share), the chunk steps of E, H and P
    (H: the fused FFN-up at a chunk step's 256 rows; P: its int8 body),
    and the looped ticks of J, K, O, P and S (the fused stages, rows
    12-14, replayed in one CUDA graph a tick)."""
    from repro_torch.serving.request import SamplingParams
    profile_phase(torch, cfg, params, requests, log)
    profile_phase(torch, cfg, params, requests, log, tag="B slots=1",
                  slots=1)
    profile_phase(torch, cfg, params, requests, log,
                  tag="N slots=1 int8 weights", slots=1, weight_dtype="int8")
    chunk_profile_phase(torch, cfg, params, shared, log)
    # two new tokens each: only the prefill is profiled
    sp2 = SamplingParams(max_new_tokens=2)
    chunk_profile_phase(torch, cfg, params, [(p, sp2) for p, _ in shared],
                        log, tag="H", plan=tuned_plan())
    chunk_profile_phase(torch, cfg, params, [(p, sp2) for p, _ in shared],
                        log, tag="P int8 weights", plan=looped_plan(),
                        weight_dtype="int8")
    paged = dict(cache_kind="paged", page_size=PAGE, prefix_sharing=True,
                 plan=looped_plan())
    profile_phase(torch, cfg, params, requests, log,
                  tag="J slots=4 looped", decode_fusion="looped")
    profile_phase(torch, cfg, params, shared, log,
                  tag="K slots=4 paged sharing grouped fused-FFN looped",
                  **paged)
    profile_phase(torch, cfg, params, requests, log,
                  tag="O slots=4 looped fp8 weights", decode_fusion="looped",
                  weight_dtype="fp8")
    profile_phase(torch, cfg, params, shared, log,
                  tag="P slots=4 paged sharing grouped fused-FFN looped int8 "
                  "weights", weight_dtype="int8", **paged)
    profile_phase(torch, cfg, params, shared, log,
                  tag="S slots=4 paged sharing grouped looped fp8 KV pages",
                  kv_dtype="fp8", **paged)


def logits_phase(torch, cfg, params, requests, log, cuda_tokens):
    from repro_torch.core.plan import DEFAULT_PLAN, make_plan
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx
    from repro_torch.serving.engine import Engine

    api = get_model(cfg)
    torch_plan = make_plan("torch")
    prompts = [p for p, _ in requests[:4]]
    c = 64
    toks = torch.zeros((4, c), dtype=torch.int32, device="cuda")
    for i, p in enumerate(prompts):
        toks[i] = torch.as_tensor(p[:c], device="cuda")
    chunk_lens = torch.full((4,), c, dtype=torch.int32, device="cuda")
    zeros = torch.zeros((4,), dtype=torch.int32, device="cuda")
    # the fused decode stages against the "torch" plan with the same knobs
    fused_plans = {"cuda": make_plan("cuda", decode_fusion="fused"),
                   "torch": make_plan("torch", fused_ffn=True,
                                      decode_fusion="fused")}
    results = {}
    for name, plan in (("cuda", DEFAULT_PLAN), ("torch", torch_plan)):
        ctx = LayerCtx(cfg, plan)
        cache = api.init_cache(DenseLayout(4, 1024), device="cuda")
        with torch.no_grad():
            l1, cache = api.prefill_chunk(ctx, params, toks, chunk_lens,
                                          cache, zeros)
            nxt = results["cuda"][0][:, :cfg.vocab_size].argmax(-1) \
                if name == "torch" else l1[:, :cfg.vocab_size].argmax(-1)
            cache_f = {k: v.clone() for k, v in cache.items()}
            l2, cache = api.decode_step(ctx, params, nxt.int(), cache,
                                        chunk_lens)
            l2f, _ = api.decode_step(LayerCtx(cfg, fused_plans[name]),
                                     params, nxt.int(), cache_f, chunk_lens)
            del cache_f
            cache2 = api.init_cache(DenseLayout(4, 64), device="cuda")
            l3, _ = api.prefill(ctx, params, toks, chunk_lens, cache2)
        results[name] = (l1, l2, l3, l2f)
    worst = 0.0
    for i, what in enumerate(("first prefill chunk", "first decode step",
                              "one-shot prefill",
                              "first decode step, fused stages")):
        a = results["cuda"][i][:, :cfg.vocab_size].float()
        b = results["torch"][i][:, :cfg.vocab_size].float()
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"logits {what}: cuda plan vs torch plan max_abs_err={err:.4f} "
            f"(tol {LOGITS_TOL}; logit range {b.abs().max().item():.2f}); "
            f"argmax agree {(a.argmax(-1) == b.argmax(-1)).sum().item()}/4")
    check(worst <= LOGITS_TOL, f"logits differ by {worst} > {LOGITS_TOL}")

    eng = Engine(cfg, params, num_slots=4, max_seq=1024, plan=torch_plan,
                 device="cuda")
    ref_out = eng.run(requests)
    same = sum(sum(1 for a, b in zip(cuda_tokens[r], ref_out[r]) if a == b)
               for r in ref_out)
    total = sum(len(v) for v in ref_out.values())
    prefix = sum(next((i for i, (a, b) in enumerate(
        zip(cuda_tokens[r], ref_out[r])) if a != b), len(ref_out[r]))
        for r in ref_out)
    log(f"greedy tokens, cuda plan vs torch plan (slots=4): {same}/{total} "
        f"positions agree, {prefix}/{total} before the first divergence")


def shared_pool_operands(torch, shared, c=64, b=4):
    """Block tables over a (b · 1024 / PAGE)-page pool: private tables of
    shuffled pages, the same tables with every row leading with row 0's
    first two pages, the one-group ``DecodeGroups`` of that shared
    2c-token prefix, and the first 2c tokens of b shared-header prompts."""
    from repro_torch.kernels import group_attention as ga
    nb = 1024 // PAGE
    perm = torch.randperm(b * nb,
                          generator=torch.Generator().manual_seed(0))
    private = perm.reshape(b, nb).to(device="cuda", dtype=torch.int32)
    shared_bt = private.clone()
    shared_bt[:, :2] = private[0, :2]

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    groups = ga.DecodeGroups(
        tables=private[:1, :2].contiguous(), n_pages=i32(2),
        g_prefix_len=i32(2 * c), num_members=i32(b),
        member_rows=i32(*range(b))[None], gid=i32(*[0] * b),
        member=i32(*range(b)), prefix_len=i32(*[2 * c] * b))
    toks = torch.stack([torch.as_tensor(p[:2 * c]) for p, _ in shared[:b]])
    return private, shared_bt, groups, toks.to(device="cuda",
                                                dtype=torch.int32)


def graph_phase(torch, cfg, params, shared, log):
    """A looped step's CUDA graph against the eager fused step. From
    identical cache states the same decode step runs eagerly under
    ``"fused"`` and, under ``"looped"``, as the key's eager first call,
    the capture (with other tokens and lengths, from the same state) and
    a replay with the checked inputs: the replay's logits and the whole
    cache (every KV row the step wrote) must hold the eager step's bits.
    On the dense cache, and on the paged pool with grouped decode over a
    shared 128-token prefix, with bf16 pages and with int8 ones (codes and
    steps included)."""
    from repro_torch.core.plan import make_plan
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout, PagedLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    b = 4
    dense = api.init_cache(DenseLayout(b, 1024), device="cuda")
    for t in dense.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    lens = torch.tensor([1000, 517, 64, 3], dtype=torch.int32,
                        device="cuda")
    cases = [("dense", dense, lens, {}, {})]
    private, shared_bt, groups, toks = shared_pool_operands(torch, shared)
    c = toks.shape[1] // 2
    row0 = torch.tensor([c, 0, 0, 0], dtype=torch.int32, device="cuda")
    ctx = LayerCtx(cfg, make_plan("cuda", decode_group="grouped"))
    # the bf16 pool, and an int8 one: the replay must also write the codes
    # and steps of the quantized scatter bit for bit
    for kv_dtype in ("bf16", "int8"):
        pool = api.init_cache(PagedLayout(private.numel(), PAGE, kv_dtype),
                              device="cuda")
        with torch.no_grad():
            for i in range(2):
                _, pool = api.prefill_chunk(
                    ctx, params, toks[:, i * c:(i + 1) * c], row0, pool,
                    torch.full((b,), i * c, dtype=torch.int32,
                               device="cuda"),
                    block_tables=shared_bt)
        what = "paged grouped" + ("" if kv_dtype == "bf16" else
                                  f" {kv_dtype} KV pages")
        cases.append((what, pool,
                      torch.full((b,), 2 * c, dtype=torch.int32,
                                 device="cuda"),
                      dict(block_tables=shared_bt, decode_groups=groups),
                      dict(decode_group="grouped")))
    for what, cache0, lengths, kw, plan_kw in cases:
        tokens = [torch.randint(1, cfg.vocab_size, (b,), generator=gen,
                                device="cuda", dtype=torch.int32)
                  for _ in range(3)]
        fused = LayerCtx(cfg, make_plan("cuda", decode_fusion="fused",
                                        **plan_kw))
        looped = LayerCtx(cfg, make_plan("cuda", decode_fusion="looped",
                                         **plan_kw))
        with torch.no_grad():
            want_cache = {k: v.clone() for k, v in cache0.items()}
            want, _ = api.decode_step(fused, params, tokens[0], want_cache,
                                      lengths, **kw)
            cache = {k: v.clone() for k, v in cache0.items()}
            # eager first call, capture + replay, replay: each from the
            # same state, the first two with other inputs
            for toks_i, lens_i in ((tokens[1], lengths + 2),
                                   (tokens[2], lengths + 1),
                                   (tokens[0], lengths)):
                for k in cache:
                    cache[k].copy_(cache0[k])
                got, _ = api.decode_step(looped, params, toks_i, cache,
                                         lens_i, **kw)
            torch.cuda.synchronize()
        lp = looped.graphs
        same = same_bits(torch, (got, want),
                         *((cache[k], want_cache[k]) for k in cache))
        log(f"graph {what}: looped replay (after {lp.eager_ticks} eager "
            f"call, {lp.captures} capture, {lp.replays} replays) bitwise "
            f"the eager fused step: logits and KV {same}")
        check((lp.eager_ticks, lp.captures, lp.replays) == (1, 1, 2),
              f"graph {what}: the calls did not go eager, capture, replay")
        check(same, f"graph {what}: the replay differs from the eager step")


def paged_logits_phase(torch, cfg, params, shared, log, kv_dtype="bf16"):
    """The paged pool's logits against the ``"torch"`` plan (gather +
    reference math): a second chunk that reads the first one's resident
    pages, and the first decode step. Three times: the ``"cuda"`` default
    plan (fused chunk kernel, paged decode kernel) over private tables,
    and runs H's and K's plans (grouped decode, fused FFN-up; K's with
    the fused stages, its first decode step eager) with all four rows'
    tables leading with the same two pages: row 0 prefills them (the
    others are spectators), then every row decodes one token of its own
    through one group. ``kv_dtype`` is the pool's page precision (both
    plans); returns the ``"torch"`` plan's logits per case, the rows
    compared, (second chunk, first decode step)."""
    from repro_torch.core.plan import DEFAULT_PLAN, make_plan
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import PagedLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    c, b = 64, 4
    private, shared_bt, groups, toks = shared_pool_operands(torch, shared)
    num_pages = private.numel()
    full = torch.full((b,), c, dtype=torch.int32, device="cuda")
    row0 = torch.tensor([c, 0, 0, 0], dtype=torch.int32, device="cuda")
    out = {}
    cases = (
        ("paged", (DEFAULT_PLAN, make_plan("torch")), private, full, None),
        ("grouped fused-FFN", (tuned_plan(), make_plan(
            "torch", decode_group="grouped", fused_ffn=True)), shared_bt,
         row0, groups),
        ("K's plan (looped)", (looped_plan(), make_plan(
            "torch", decode_group="grouped", fused_ffn=True,
            decode_fusion="looped")), shared_bt, row0, groups),
    )
    for what, plans, bt, chunk_lens, grp in cases:
        results = {}
        for name, plan in zip(("cuda", "torch"), plans):
            ctx = LayerCtx(cfg, plan)
            cache = api.init_cache(PagedLayout(num_pages, PAGE, kv_dtype),
                                   device="cuda")
            ff.fused_ffn_up.launches = 0
            with torch.no_grad():
                _, cache = api.prefill_chunk(ctx, params, toks[:, :c],
                                             chunk_lens, cache, full * 0,
                                             block_tables=bt)
                chunk_ffn = ff.fused_ffn_up.launches
                l2, cache = api.prefill_chunk(ctx, params, toks[:, c:],
                                              chunk_lens, cache, full,
                                              block_tables=bt)
                nxt = (results["cuda"][0] if name == "torch" else l2)[
                    :, :cfg.vocab_size].argmax(-1)
                if grp is not None:
                    # every row continues the same prefix with a token
                    # of its own
                    nxt = nxt[0] + torch.arange(b, device="cuda")
                l3, _ = api.decode_step(ctx, params, nxt.int(), cache,
                                        2 * full, block_tables=bt,
                                        decode_groups=grp)
            results[name] = (l2, l3)
            if name == "cuda" and plan.fused_ffn.fused:
                log(f"logits {what}: fused_ffn_up launches per chunk step "
                    f"{chunk_ffn}")
        rows = (slice(0, 1), slice(None)) if grp is not None else \
            (slice(None), slice(None))
        worst = 0.0
        kv = "" if kv_dtype == "bf16" else f" {kv_dtype} KV pages"
        for i, step in enumerate(("second chunk over resident pages",
                                  "first decode step")):
            a = results["cuda"][i][rows[i], :cfg.vocab_size].float()
            r = results["torch"][i][rows[i], :cfg.vocab_size].float()
            err = (a - r).abs().max().item()
            worst = max(worst, err)
            log(f"logits {what}{kv} {step}: cuda plan vs torch plan "
                f"max_abs_err={err:.4f} (tol {LOGITS_TOL}; logit range "
                f"{r.abs().max().item():.2f}); argmax agree "
                f"{(a.argmax(-1) == r.argmax(-1)).sum().item()}/"
                f"{a.shape[0]}")
        check(worst <= LOGITS_TOL,
              f"{what}{kv} logits differ by {worst} > {LOGITS_TOL}")
        out[what] = [results["torch"][i][rows[i], :cfg.vocab_size].float()
                     for i in range(2)]
    return out


def kv_quant_logits_phase(torch, cfg, params, shared, log, bf16):
    """int8 and fp8 KV pages on the shared requests: the ``"cuda"`` plans
    within LOGITS_TOL of the ``"torch"`` plan with the same pages
    (:func:`paged_logits_phase`), and the ``"torch"`` plan's quantized
    logits within the JAX package's guard, logits_guard_tol(spec) x
    max(|logits|, 1), of its bf16 logits (``bf16``, that phase's result
    on bf16 pages)."""
    from repro_torch.kernels import quant
    for qs in (quant.INT8, quant.FP8):
        got = paged_logits_phase(torch, cfg, params, shared, log,
                                 kv_dtype=qs.name)
        for what, steps in got.items():
            for step, a, b in zip(("second chunk", "first decode step"),
                                  steps, bf16[what]):
                tol = quant.logits_guard_tol(qs) * max(
                    b.abs().max().item(), 1.0)
                err = (a - b).abs().max().item()
                log(f"logits guard {qs.name} KV pages, {what}, {step}: torch "
                    f"plan quantized vs bf16 max_abs_err={err:.4f} (guard "
                    f"{tol:.4f}); argmax agree "
                    f"{(a.argmax(-1) == b.argmax(-1)).sum().item()}/"
                    f"{a.shape[0]}")
                check(err <= tol, f"{qs.name} KV pages {what} {step}: "
                      f"logits leave the guard ({err} > {tol})")


def quant_logits_phase(torch, cfg, params, requests, log):
    """Quantized weights against the ``"torch"`` plan: for int8 and fp8,
    the params quantized once on the card; a prefill chunk and the first
    decode step under the default plan (quantized flat GEMM at decode,
    the XLA-dot expression at the 256-row chunk), the fused stages and
    run H's plan (the quantized fused FFN-up at the chunk), each within
    LOGITS_TOL of the ``"torch"`` plan with the same knobs and params.
    On the ``"torch"`` plan, the quantized logits within the JAX
    package's guard, logits_guard_tol(spec) x max(|logits|, 1), of the
    bf16 logits."""
    from repro_torch.core.plan import DEFAULT_PLAN, make_plan
    from repro_torch.kernels import quant
    from repro_torch.models import wquant
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    c = 64
    toks = torch.zeros((4, c), dtype=torch.int32, device="cuda")
    for i, (p, _) in enumerate(requests[:4]):
        toks[i] = torch.as_tensor(p[:c], device="cuda")
    lens = torch.full((4,), c, dtype=torch.int32, device="cuda")
    zeros = torch.zeros((4,), dtype=torch.int32, device="cuda")
    nxt = toks[:, 0].contiguous()       # one teacher-forced next token

    def run(plan, p):
        ctx = LayerCtx(cfg, plan)
        cache = api.init_cache(DenseLayout(4, 1024), device="cuda")
        with torch.no_grad():
            l1, cache = api.prefill_chunk(ctx, p, toks, lens, cache, zeros)
            l2, _ = api.decode_step(ctx, p, nxt, cache, lens)
        return [t[:, :cfg.vocab_size].float() for t in (l1, l2)]

    bf16 = run(make_plan("torch"), params)
    plans = (("default plan", DEFAULT_PLAN, make_plan("torch")),
             ("fused stages", make_plan("cuda", decode_fusion="fused"),
              make_plan("torch", fused_ffn=True, decode_fusion="fused")),
             ("H's plan (fused FFN-up)", tuned_plan(),
              make_plan("torch", fused_ffn=True)))
    for qs in (quant.INT8, quant.FP8):
        qp = wquant.quantize_params(params, qs)
        for what, cuda_plan, torch_plan in plans:
            got, want = run(cuda_plan, qp), run(torch_plan, qp)
            for step, a, b in zip(("prefill chunk", "first decode step"),
                                  got, want):
                err = (a - b).abs().max().item()
                log(f"logits {qs.name} weights, {what}, {step}: cuda plan vs "
                    f"torch plan max_abs_err={err:.4f} (tol {LOGITS_TOL}); "
                    f"argmax agree "
                    f"{(a.argmax(-1) == b.argmax(-1)).sum().item()}/4")
                check(err <= LOGITS_TOL, f"{qs.name} {what} {step} logits "
                      f"differ by {err} > {LOGITS_TOL}")
            if what == "default plan":
                for step, a, b in zip(("prefill chunk",
                                       "first decode step"), want, bf16):
                    tol = quant.logits_guard_tol(qs) * max(
                        b.abs().max().item(), 1.0)
                    err = (a - b).abs().max().item()
                    log(f"logits guard {qs.name}, {step}: torch plan "
                        f"quantized vs bf16 max_abs_err={err:.4f} (guard "
                        f"{tol:.4f}); argmax agree "
                        f"{(a.argmax(-1) == b.argmax(-1)).sum().item()}/4")
                    check(err <= tol, f"{qs.name} {step}: quantized logits "
                          f"leave the guard ({err} > {tol})")
        del qp


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# T3 on the card: the cost models' fixed costs, the wallclock tuner, and
# serving with the tuned GEMM route (runs T, U and the CLI's V)
# ---------------------------------------------------------------------------

TIED_HEAD = "lm_head_tied"
# the [K, N] shapes whose share of a tick the T / U profiles report
SHARE_SHAPES = {"gate/up": "gate_up", "k/v": "kv_proj", "head": TIED_HEAD}


def graph_ms_per_call(torch, fn, n=1000, reps=7):
    """Median device ms a call of ``fn`` adds when ``n`` calls run back to
    back in one CUDA graph (the replay's CUDA-event time over ``n``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def cost_phase(torch, seed, requests, shared, log):
    """The fixed costs in ``hardware.H100_SXM`` that T3's cost models add,
    measured here, each printed beside its committed value (a mismatch is
    printed, not failed: the machine is shared and noisy). The engine runs
    use qwen2-0.5b at its full depth (params drawn here from ``seed``,
    freed at the end), as the committed values were measured. Returns
    {field: measured seconds}.

    * launch_s: the noop probe kernel (csrc/probe.cu) launched 1,000 times
      back to back in a CUDA graph, device time a launch;
    * host_dispatch_s: the same launches eager, host time a launch;
    * library_edge_s: a 64 x 64 x 64 bf16 ``torch.matmul`` 1,000 times in a
      graph, device time a call (the library GEMM's fixed cost);
    * host_copy_s: one 4 KB pinned host-to-device copy, then a
      synchronize, on the host clock (median of 50);
    * kv_step_s: row 3 (decode_attention_unified_max) on its long case
      (4 rows of 8,192 keys, 128 splits) against its short one (lengths
      1024/517/64/3, 16 splits), less the bytes, per extra split;
    * chunk_step_s: run E's chunk steps (2 new tokens a request), each
      step's unprofiled wall less its profiled device busy, median;
    * loop_setup_s: run J's looped tick, unprofiled wall less busy.
    """
    import dataclasses

    from repro_torch import configs, hardware
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    spec = hardware.H100_SXM
    cfg = configs.get(ARCH)
    params = get_model(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    got = {}
    lib = _build.load("probe", {"probe_noop": [_build.VP, _build.I32,
                                               _build.VP]})
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")

    def noop():
        _build.check(lib, "probe_noop", lib.probe_noop(
            _build.ptr(flag), 1, _build.stream_of(flag)))

    got["launch_s"] = 1e-3 * graph_ms_per_call(torch, noop)
    n, walls = 1000, []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            noop()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n)
    got["host_dispatch_s"] = statistics.median(walls)
    a = torch.randn((64, 64), device="cuda").to(torch.bfloat16)
    b = torch.randn((64, 64), device="cuda").to(torch.bfloat16)
    got["library_edge_s"] = 1e-3 * graph_ms_per_call(
        torch, lambda: torch.matmul(a, b))
    src = torch.zeros(4096, dtype=torch.uint8).pin_memory()
    dst = torch.empty(4096, dtype=torch.uint8, device="cuda")
    copies = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    got["host_copy_s"] = statistics.median(copies)

    # one more 64-key split of decode attention, beyond its bytes
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(7)
    timer = Timer(torch)
    case = {}
    for s_max, lens in ((1024, [1024, 517, 64, 3]), (8192, [8192] * 4)):
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kc, vc = (torch.randn((4, s_max, hk, hd), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        q = torch.randn((4, hq, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        ms = timer.ms(lambda: da.decode_attention_unified_max(
            q, kt, vt, lengths, phi=cfg.softmax_phi.phi))
        nbytes = 2 * (2 * 4 * hq * hd + 2 * sum(lens) * hk * hd) + 16 * hk
        case[s_max] = (ms, nbytes, -(-s_max // 64))
    (t1, b1, n1), (t2, b2, n2) = case[1024], case[8192]
    got["kv_step_s"] = (1e-3 * (t2 - t1) - (b2 - b1) / spec.hbm_bw) / (
        n2 - n1)
    log(f"cost row 3: short {t1:.4f} ms ({n1} splits, {b1} B), long "
        f"{t2:.4f} ms ({n2} splits, {b2} B)")
    del timer

    # a chunk step's wall beyond its device work (run E's engine)
    sp2 = SamplingParams(max_new_tokens=2)
    reqs = [(p, sp2) for p, _ in shared]
    paged = dict(num_slots=4, max_seq=1024, device="cuda",
                 prefix_sharing=True, cache_kind="paged", page_size=PAGE)
    for _ in range(2):                   # the first run warms the engine
        eng = Engine(cfg, params, **paged)
        real, walls = eng.api.prefill_chunk, []

        def timed(*args, _real=real, _walls=walls, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _real(*args, **kw)
            torch.cuda.synchronize()
            _walls.append(time.perf_counter() - t0)
            return res

        eng.api = dataclasses.replace(eng.api, prefill_chunk=timed)
        eng.run(reqs)
    steps = chunk_profile_phase(torch, cfg, params, reqs, log,
                                tag="E (cost phase)")
    check(steps is not None and len(steps) == len(walls),
          f"cost phase: {len(walls)} unprofiled chunk steps against "
          f"{None if steps is None else len(steps)} profiled")
    got["chunk_step_s"] = statistics.median(
        w - 1e-3 * busy for w, (busy, _, _, _) in zip(walls, steps))
    log(f"cost E chunk steps: unprofiled wall "
        f"{1e3 * sum(walls) / len(walls):.3f} ms/step over {len(walls)}")

    j = profile_phase(torch, cfg, params, requests, log,
                      tag="J slots=4 looped (cost phase)",
                      decode_fusion="looped")
    check(j is not None, "cost phase: run J's tick has no device time")
    got["loop_setup_s"] = 1e-3 * (j[1] - j[0])

    for field, v in got.items():
        want = getattr(spec, field)
        log(f"cost {field}: measured {v:.3e} s, H100_SXM {want:.3e} s "
            f"(measured / committed {v / want:.2f})")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return got


def tune_phase(torch, cfg, log, strict=True):
    """``tune(cfg, H100_SXM, measure="wallclock")``: every entry's (K, N,
    m1, m2) and the three impls' times at M = 1, 4, 8 and 16; the plan
    saved under chiprun_out/ and reloaded strictly; where its entries
    differ from the committed ``plans_torch/`` file. Fails if a shape of
    ``called_gemm_shapes`` has no entry and, ``strict``, if the committed
    file does not load strictly or its analytical knobs differ from this
    tune's. Returns the tuned plan."""
    from repro_torch import hardware
    from repro_torch.core import dispatch
    from repro_torch.core import plan as plan_mod

    spec = hardware.H100_SXM
    t0 = time.perf_counter()
    tuned = plan_mod.tune(cfg, spec, measure="wallclock")
    log(f"tune {cfg.name} on {spec.name} (wallclock, "
        f"{time.perf_counter() - t0:.1f}s): {tuned.describe()}")
    check(tuned.provenance.measure == "wallclock",
          "tune: provenance does not say wallclock")
    called = dispatch.called_gemm_shapes(cfg)
    missing = [gs for gs in called
               if (gs.k, gs.n) not in tuned.matmul.entries]
    check(not missing, f"tune: called shapes without an entry: {missing}")
    names = {(gs.k, gs.n): gs.name
             for gs in plan_mod.tuned_gemm_shapes(cfg) + called}
    measure = dispatch.wallclock_measure_factory(
        nk=[(gs.k, gs.n) for gs in called if gs.name == TIED_HEAD])
    for (k, n), e in sorted(tuned.matmul.entries.items()):
        cells = []
        for m in (1, 4, 8, 16):
            a, b, c = (1e3 * measure(impl, m, k, n)
                       for impl in dispatch.Impl)
            cells.append(f"M={m} {a:.4f}/{b:.4f}/{c:.4f}")
        log(f"tune entry {names[(k, n)]} ({k}, {n}): m1={e.m1} m2={e.m2}; "
            f"ms gemv/flat_gemm/matmul " + "; ".join(cells))
    log(f"tune default ladder: m1={tuned.matmul.default_m1} "
        f"m2={tuned.matmul.default_m2}; find_weight_dtype: "
        f"{dispatch.find_weight_dtype(cfg, spec=spec)} (any guard), "
        f"{dispatch.find_weight_dtype(cfg, spec=spec, tol_budget=0.0)} "
        "(bitwise only)")
    saved = tuned.save(plan_mod.default_plan_path(cfg, spec,
                                                  root=str(OUT_DIR)))
    check(plan_mod.ExecutionPlan.load(saved, cfg=cfg, spec=spec) == tuned,
          "tune: the saved plan does not reload to itself")
    log(f"tune: saved to {saved}, reloads strictly to the same plan")

    committed_path = ROOT / plan_mod.default_plan_path(cfg, spec)
    if not committed_path.exists():
        check(not strict, f"tune: no committed plan {committed_path}")
        log(f"tune: no committed plan {committed_path}")
        return tuned
    committed = plan_mod.ExecutionPlan.load(str(committed_path), cfg=cfg,
                                            spec=spec, strict=strict)
    for kn in sorted(set(committed.matmul.entries) | set(
            tuned.matmul.entries)):
        old, new = committed.matmul.entries.get(kn), \
            tuned.matmul.entries.get(kn)
        if old != new:
            log(f"tune: entry {kn} differs from the committed plan: "
                f"committed {old and (old.m1, old.m2)}, now "
                f"{new and (new.m1, new.m2)}")
    knobs = (("attention_decode", "block_k"), ("paged", "chunk_block"),
             ("paged", "fused_threshold"), ("paged", "group_threshold"),
             ("paged", "swap_threshold"), ("decode_fusion", "granularity"),
             ("matmul", "weight_dtype"))
    diff = [f"{op}.{knob}: committed "
            f"{getattr(getattr(committed, op), knob)!r}, now "
            f"{getattr(getattr(tuned, op), knob)!r}"
            for op, knob in knobs
            if getattr(getattr(committed, op), knob)
            != getattr(getattr(tuned, op), knob)]
    log(f"tune: analytical knobs against {committed_path.name}: "
        + ("; ".join(diff) if diff else "all equal"))
    check(not diff or not strict,
          f"tune: analytical knobs differ from the committed plan: {diff}")
    return tuned


def gemm_launch_checker(log_calls):
    """Wrap ``ops.matmul`` so that every call checks its launch counters
    against the plan's pick: ImplA launches ``gemv`` once per four-row
    slice, ImplB ``flat_gemm`` once, ImplC neither. Appends (M, K, N,
    impl) to ``log_calls`` and raises SmokeFailure on a mismatch.
    Returns a function that restores ``ops.matmul``."""
    from repro_torch.core.dispatch import Impl
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.kernels import ops
    from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_quant
    from repro_torch.kernels.gemv import gemv, gemv_quant, row_slices

    real = ops.matmul

    def launched():
        return (gemv.launches + gemv_quant.launches,
                flat_gemm.launches + flat_gemm_quant.launches)

    def checked(x, w, *, plan=None):
        g0, f0 = launched()
        out = real(x, w, plan=plan)
        g1, f1 = launched()
        k, n = x.shape[-1], out.shape[-1]
        m = x.numel() // k
        impl = (plan or DEFAULT_PLAN).matmul.pick(m, k, n)
        want = {Impl.GEMV: (len(row_slices(m)), 0),
                Impl.FLAT_GEMM: (0, 1), Impl.XLA_DOT: (0, 0)}[impl]
        check((g1 - g0, f1 - f0) == want,
              f"matmul M={m} K={k} N={n}: the plan picks {impl.value}, "
              f"launched gemv {g1 - g0}, flat_gemm {f1 - f0}")
        log_calls.append((m, k, n, impl))
        return out

    ops.matmul = checked

    def restore():
        ops.matmul = real

    return restore


def tuned_serve_phase(torch, cfg, params, requests, tuned, outputs,
                      launches, log):
    """Runs T (A's traffic and plan, the tuned GEMM route) and U (B's, 1
    slot), each with every counter set to 0 just before and read just
    after, every GEMM's launches checked against the plan's pick
    (:func:`gemm_launch_checker`) and every (K, N) it saw a tuned entry;
    tokens counted against A's and B's. Returns the tuned split plan."""
    import dataclasses

    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.serving.engine import Engine

    plan = dataclasses.replace(DEFAULT_PLAN, matmul=tuned.matmul)
    for tag, slots, ref in (("T", 4, "A"), ("U", 1, "B")):
        eng = Engine(cfg, params, num_slots=slots, max_seq=1024, plan=plan,
                     device="cuda")
        calls = []
        for fn in counters().values():
            fn.launches = 0
        restore = gemm_launch_checker(calls)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run(requests)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            restore()
        counts = {n: fn.launches for n, fn in counters().items()}
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
        seen = {(k, n) for _, k, n, _ in calls}
        check(seen <= set(tuned.matmul.entries),
              f"{tag}: GEMM shapes without a tuned entry: "
              f"{sorted(seen - set(tuned.matmul.entries))}")
        picks = {}
        for m, k, n, impl in calls:
            key = f"{k}x{n} {impl.value}"
            picks[key] = picks.get(key, 0) + 1
        for rid, toks in out.items():
            check(len(toks) == requests[rid][1].max_new_tokens
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"{tag}: request {rid} produced {toks}")
        total = sum(len(v) for v in out.values())
        agree = sum(sum(1 for x, y in zip(outputs[ref][r], out[r]) if x == y)
                    for r in out)
        log(f"serve {tag} slots={slots} {ref}'s traffic, tuned GEMM route: "
            f"{len(out)} requests, {total} tokens in {dt:.3f}s = "
            f"{total / dt:.1f} tok/s; {eng.ticks} decode ticks at "
            f"{1e3 * eng.stats.decode_seconds / max(eng.ticks, 1):.3f} "
            f"ms/tick; {len(calls)} GEMM calls, every launch under the "
            f"plan's pick; calls by (K x N, impl) {json.dumps(picks)}; "
            f"agrees with {ref} on {agree}/{total} tokens; launches "
            f"{json.dumps(counts)}")
    return plan


def tuned_logits_phase(torch, cfg, params, requests, plan, log):
    """The first prefill chunk's and decode step's logits of the tuned
    split plan (4 rows, as T, and 1, as U) against the "torch" plan's,
    within LOGITS_TOL."""
    from repro_torch.core.plan import make_plan
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    c = 64
    worst = 0.0
    for b in (4, 1):
        toks = torch.stack([torch.as_tensor(p[:c], device="cuda")
                            for p, _ in requests[:b]]).int()
        lens = torch.full((b,), c, dtype=torch.int32, device="cuda")
        zeros = torch.zeros((b,), dtype=torch.int32, device="cuda")
        res, nxt = {}, None
        for name, p in (("tuned", plan), ("torch", make_plan("torch"))):
            ctx = LayerCtx(cfg, p)
            cache = api.init_cache(DenseLayout(b, 1024), device="cuda")
            with torch.no_grad():
                l1, cache = api.prefill_chunk(ctx, params, toks, lens,
                                              cache, zeros)
                if nxt is None:
                    nxt = l1[:, :cfg.vocab_size].argmax(-1).int()
                l2, _ = api.decode_step(ctx, params, nxt, cache, lens)
            res[name] = (l1, l2)
        for i, what in enumerate(("first prefill chunk",
                                  "first decode step")):
            x = res["tuned"][i][:, :cfg.vocab_size].float()
            y = res["torch"][i][:, :cfg.vocab_size].float()
            err = (x - y).abs().max().item()
            worst = max(worst, err)
            log(f"logits tuned GEMM route, {b} row(s), {what}: vs torch "
                f"plan max_abs_err={err:.4f} (tol {LOGITS_TOL}); argmax "
                f"agree {(x.argmax(-1) == y.argmax(-1)).sum().item()}/{b}")
    check(worst <= LOGITS_TOL,
          f"tuned-route logits differ by {worst} > {LOGITS_TOL}")


def gemm_share_profile(torch, cfg, params, requests, log, tag, slots,
                       plan=None):
    """A split decode tick's device busy, its unprofiled wall and the
    shares of gate / up, k / v and the head in it (each GEMM call under
    a ``record_function`` label naming its (K, N), so cuBLAS's kernels
    count too): 2 warm ticks, 8 timed, 8 profiled. Returns (busy ms,
    wall ms, {share: ms})."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import dispatch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    eng = Engine(cfg, params, num_slots=slots, max_seq=1024, device="cuda",
                 plan=plan)
    for p, _ in requests[:4]:
        eng.submit(p, SamplingParams(max_new_tokens=40))
    for _ in range(3):
        eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    real = ops.matmul

    def labelled(x, w, *, plan=None):
        k = x.shape[-1]
        n_ = (w["codes"] if isinstance(w, dict) else w).shape[-1]
        with record_function(f"gemm {k}x{n_}"):
            return real(x, w, plan=plan)

    ops.matmul = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
    finally:
        ops.matmul = real
    avg = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # each label also appears on the card's timeline, as a span over the
    # kernels its calls launched (the host-side label links only the
    # kernels of aten ops, not those the wrappers launch through ctypes):
    # busy sums kernels only, a shape's time is its labels' device spans
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == cuda and not e.is_user_annotation) / n / 1e3
    by_shape = {e.key: e.device_time_total / n / 1e3 for e in avg
                if e.key.startswith("gemm ") and e.device_type == cuda
                and e.is_user_annotation}
    shapes = {gs.name: f"gemm {gs.k}x{gs.n}"
              for gs in dispatch.called_gemm_shapes(cfg)}
    shares = {s: by_shape.get(shapes[name], 0.0)
              for s, name in SHARE_SHAPES.items()}
    if busy == 0:
        log(f"profile {tag}: device time not measured (the profiler "
            "reported none)")
        return None
    log(f"profile {tag}: device busy {busy:.3f} ms/tick, unprofiled wall "
        f"{wall:.3f} ms/tick (idle {100 * (1 - busy / wall):.1f}%); "
        + ", ".join(f"{s} {v:.3f} ms ({100 * v / busy:.1f}%)"
                    for s, v in shares.items())
        + f"; every GEMM {sum(by_shape.values()):.3f} ms")
    return busy, wall, shares


def tuned_profiles(torch, cfg, params, requests, plan, log):
    """T beside A (4 slots) and U beside B (1 slot), in turns (A, T, T, A;
    B, U, U, B) in one call."""
    for slots, base, tuned in ((4, "A", "T"), (1, "B", "U")):
        for tag in (base, tuned, tuned, base):
            gemm_share_profile(
                torch, cfg, params, requests, log,
                f"{tag} slots={slots} split tick GEMM shares", slots,
                plan=plan if tag == tuned else None)


def cli_phase(log):
    """Run V: the serving CLI in a subprocess with the committed plan,
    strictly loaded, on a few requests at full width."""
    import os

    from repro_torch import configs, hardware
    from repro_torch.core import plan as plan_mod

    path = ROOT / plan_mod.default_plan_path(configs.get(ARCH),
                                             hardware.H100_SXM)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--plan", str(path), "--requests", "4", "--slots", "4",
           "--max-seq", "512", "--max-new", "8", "--prompt-len", "48"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    dt = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"serve V (CLI, --plan {path.name}): {line}")
    check(res.returncode == 0,
          f"serve V: the CLI exited {res.returncode}: {res.stderr[-2000:]}")
    check("served 4 requests" in res.stdout and "plan " in res.stdout,
          f"serve V: unexpected output {res.stdout[-2000:]}")
    log(f"serve V: CLI subprocess finished in {dt:.1f}s")


# ---------------------------------------------------------------------------
# phase 3b: the tiered KV hierarchy on full-width qwen2-0.5b
# ---------------------------------------------------------------------------

HOST_PAGES = 64       # runs W, W′, Wp: room for every retained page


def ordered(out):
    """A run's tokens in submission order (rids keep counting across the
    runs of one engine)."""
    return [out[r] for r in sorted(out)]


def counted_run(torch, eng, requests, launches):
    """``eng.run(requests)`` with every launch counter set to 0 just before
    and read just after; the counts join ``launches``."""
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    out = eng.run(requests)
    torch.cuda.synchronize()
    counts = {n: fn.launches for n, fn in counters().items()}
    for n, c in counts.items():
        launches[n] = launches.get(n, 0) + c
    return out, counts


def check_finished(tag, out, requests, vocab):
    for toks, (_, sp) in zip(ordered(out), requests):
        check(len(toks) == sp.max_new_tokens
              and all(0 <= t < vocab for t in toks),
              f"{tag}: a request produced {len(toks)} tokens, or one out of "
              "the vocabulary")


def promoted_bytes_checker(torch, eng):
    """Before a flush: keep the bytes of every session page about to be
    demoted, by its prefix-index key. Then wrap the engine's promotion so
    that every promoted page whose key was kept must hold those bytes
    bit for bit right after its upload. Returns a one-element list that
    counts the pages checked."""
    kept = {}
    for page in eng.slots._session:
        key = eng.prefix._by_page.get(page)
        if key is not None:
            kept[key] = [leaf[:, page].clone() for leaf in eng.cache.values()]
    real = eng._apply_pending_promotions
    checked = [0]

    def promote(admitted):
        dsts = [dst for idx, _ in admitted
                for _slab, dst in eng.slots.slots[idx].pending_promotions]
        real(admitted)
        for dst in dsts:
            want = kept.get(eng.prefix._by_page.get(dst))
            if want is None:
                continue
            check(same_bits(torch, *[(leaf[:, dst], w) for leaf, w in zip(
                eng.cache.values(), want)]),
                f"promoted page {dst} does not hold the bytes it was "
                "demoted with")
            checked[0] += 1

    eng._apply_pending_promotions = promote
    return checked


def chunk_step_timer(torch, eng):
    """Time every ``prefill_chunk`` call of ``eng`` on the host clock
    (synchronized on both sides); returns the list of ms it fills."""
    import dataclasses
    real = eng.api.prefill_chunk
    walls = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(*args, **kw)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        return res

    eng.api = dataclasses.replace(eng.api, prefill_chunk=timed)
    return walls


def tier_phase(torch, cfg, params, shared, outputs, log, launches):
    """Runs W, W′, W″, Wp and Wc (see the module docstring). Returns the
    mean wall of run W's round-1 chunk steps (E's traffic), in ms."""
    import shutil

    import numpy as np

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    paged = dict(num_slots=4, max_seq=1024, cache_kind="paged",
                 page_size=PAGE, prefix_sharing=True, device="cuda")
    vocab = cfg.vocab_size

    def tiers_line(tag, eng, extra=""):
        st, ts = eng.stats, eng.tiers.stats
        log(f"serve {tag}: demoted {st.demoted_pages}, promoted "
            f"{st.promoted_pages}, session hits {st.session_hits}, host "
            f"evicted {st.host_evicted_pages}, disk demotions "
            f"{ts.disk_demotions}, preemptions {st.preemptions}, shared "
            f"prefix pages {st.shared_prefix_pages}, saved prefill tokens "
            f"{st.saved_prefill_tokens}, peak pages {st.peak_pages_used}/"
            f"{eng.pool.num_pages}{extra}")

    def two_rounds(tag, base, **kw):
        eng = Engine(cfg, params, **paged, **kw)
        walls = chunk_step_timer(torch, eng)
        t0 = time.perf_counter()
        r1, _ = counted_run(torch, eng, shared, launches)
        t1 = time.perf_counter()
        walls1 = list(walls)
        check_finished(f"{tag} round 1", r1, shared, vocab)
        check(ordered(r1) == base, f"run {tag}: round 1's tokens differ")
        caps = eng.stats.graph_captures
        checked = promoted_bytes_checker(torch, eng)
        t2 = time.perf_counter()
        eng.evict_finished(flush=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        check(eng.slots.session_pages() == 0 and eng.pool.used_pages == 0,
              f"run {tag}: the flush left {eng.pool.used_pages} pages on "
              "the device")
        r2, counts = counted_run(torch, eng, shared, launches)
        t4 = time.perf_counter()
        check(ordered(r2) == ordered(r1),
              f"run {tag}: round 2's tokens differ from round 1's")
        st = eng.stats
        check(st.demoted_pages > 0 and st.promoted_pages > 0
              and st.session_hits > 0,
              f"run {tag}: demoted {st.demoted_pages}, promoted "
              f"{st.promoted_pages}, session hits {st.session_hits}")
        check(checked[0] > 0, f"run {tag}: no promoted page was checked "
              "against its demoted bytes")
        eng.slots.check()
        tiers_line(tag, eng, f"; round 1 {t1 - t0:.3f}s, flush "
                   f"{1e3 * (t3 - t2):.3f} ms, round 2 {t4 - t3:.3f}s; "
                   f"{checked[0]} promoted pages bitwise their demoted "
                   f"bytes; round 1 chunk steps {len(walls1)}, mean "
                   f"{statistics.mean(walls1):.3f} ms; graphs "
                   f"{caps} -> {st.graph_captures} captured, "
                   f"{st.graph_replays} replays; round 2 launches "
                   f"{json.dumps({n: c for n, c in counts.items() if c})}")
        return eng, r1, r2, caps, walls1

    e_toks, s_toks = ordered(outputs["E"]), ordered(outputs["S"])
    w, w1, w2, _, walls = two_rounds("W", e_toks, host_pages=HOST_PAGES)
    chunk_ms = statistics.mean(walls)

    # Wc: every request returns as its prompt, its reply and 32 more tokens
    sp32 = SamplingParams(max_new_tokens=32)
    convo = [(np.concatenate([p, np.asarray(t, np.int32)]), sp32)
             for (p, _), t in zip(shared, ordered(w2))]
    hits = w.stats.session_hits
    wc, _ = counted_run(torch, w, convo, launches)
    check_finished("Wc", wc, convo, vocab)
    check(w.stats.session_hits > hits, "run Wc: no session hit")
    plain = Engine(cfg, params, **paged)
    ref, _ = counted_run(torch, plain, convo, launches)
    agree = sum(a == b for x, y in zip(ordered(wc), ordered(ref))
                for a, b in zip(x, y))
    tiers_line("Wc (conversation)", w, f"; {w.stats.session_hits - hits} "
               f"session hits this round; agrees with a tier-less engine "
               f"on {agree}/{32 * len(convo)} tokens")
    del w, plain

    wq, _, _, caps, _ = two_rounds("W'", s_toks, host_pages=HOST_PAGES,
                                   kv_dtype="fp8", plan=looped_plan())
    check(wq.stats.graph_captures == caps,
          f"run W′: round 2 captured {wq.stats.graph_captures - caps} new "
          "graph(s); a promotion must only replay")
    del wq

    disk = OUT_DIR / "tiers"
    shutil.rmtree(disk, ignore_errors=True)
    wd, _, _, _, _ = two_rounds("W''", e_toks, host_pages=8, disk_pages=64,
                                disk_dir=str(disk))
    check(wd.tiers.stats.disk_demotions > 0, "run W″: nothing reached disk")
    del wd
    shutil.rmtree(disk, ignore_errors=True)

    # shortest job first: on this traffic FCFS re-admits F's victim from
    # the tier-0 session cache before any reclaim reaches its pages, so
    # nothing would be promoted; under SJF a resume promotes
    wp = Engine(cfg, params, **dict(paged, num_pages=F_PAGES),
                host_pages=HOST_PAGES, scheduler="sjf")
    out, _ = counted_run(torch, wp, shared, launches)
    check_finished("Wp", out, shared, vocab)
    st = wp.stats
    check(st.preemptions > 0 and st.demoted_pages > 0
          and st.promoted_pages > 0,
          f"run Wp: preemptions {st.preemptions}, demoted "
          f"{st.demoted_pages}, promoted {st.promoted_pages}")
    wp.slots.check()
    wp.flush_sessions()
    check(wp.pool.used_pages == 0,
          f"run Wp: {wp.pool.used_pages} pages left after the flush")
    agree = sum(a == b for x, y in zip(ordered(out), e_toks)
                for a, b in zip(x, y))
    tiers_line(f"Wp (F's {F_PAGES}-page pool, SJF)", wp,
               f"; slots.check() ok, no page allocated after the flush; "
               f"agrees with E on {agree}/{sum(map(len, e_toks))} tokens")
    del wp
    gc.collect()
    torch.cuda.empty_cache()
    return chunk_ms


def transfer_phase(torch, cfg, params, log, chunk_ms):
    """Gather (device to pinned host) and upload (host to device, in
    place) of 1, 8, 32 and 128 pages through the engine's own tier
    copies, bf16 and fp8 pages, median of 5 on the host clock around
    synchronized calls; each beside ``dispatch.predict_swap_time``, the
    re-prefill the swap replaces (that many of run W's chunk steps, one
    64-token page a step) and the plans' ``paged.swap_threshold``. The
    uploaded pages must hold the gathered pages' bits."""
    from repro_torch import configs, hardware
    from repro_torch.core import dispatch
    from repro_torch.core import plan as plan_mod
    from repro_torch.serving.engine import Engine

    spec = hardware.H100_SXM
    tuned = plan_mod.ExecutionPlan.load(
        ROOT / plan_mod.default_plan_path(configs.get(ARCH), spec),
        cfg=configs.get(ARCH), spec=spec)
    log(f"tiers transfer: swap_threshold {plan_mod.DEFAULT_PLAN.paged.swap_threshold} "
        f"(default plan), {tuned.paged.swap_threshold} (plans_torch/); "
        f"host link {spec.host_bw / 1e9:.1f} GB/s, host_copy_s "
        f"{1e6 * spec.host_copy_s:.1f} us (H100_SXM); run W's chunk step "
        f"{chunk_ms:.3f} ms")
    for kv in ("bf16", "fp8"):
        eng = Engine(cfg, params, num_slots=1, max_seq=1024,
                     cache_kind="paged", page_size=PAGE, prefix_sharing=True,
                     host_pages=256, num_pages=256, kv_dtype=kv,
                     device="cuda")
        for leaf in eng.cache.values():
            leaf.view(torch.uint8).random_(0, 255)
        page_bytes = eng.stats.kv_page_bytes
        slot = eng.slots.slots[0]
        for n in (1, 8, 32, 128):
            src = list(range(n))
            dst = list(range(128, 128 + n))
            gather, upload = [], []
            for rep in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                slabs = eng._gather_pages(src)
                t1 = time.perf_counter()
                slot.pending_promotions = [(slabs[p], d)
                                           for p, d in zip(src, dst)]
                eng._apply_pending_promotions([(0, None)])
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                gather.append(1e3 * (t1 - t0))
                upload.append(1e3 * (t2 - t1))
                if rep == 0:
                    check(same_bits(torch, *[(leaf[:, dst], leaf[:, src])
                                             for leaf in eng.cache.values()]),
                          f"tiers transfer {kv} {n} pages: the uploaded "
                          "pages differ from the gathered ones")
            g, u = statistics.median(gather), statistics.median(upload)
            gb = n * page_bytes / 1e9
            pred = 1e3 * dispatch.predict_swap_time(n, page_bytes, spec=spec)
            log(f"tiers transfer {kv} {n:3d} pages x {page_bytes} B: gather "
                f"{g:.3f} ms ({g / n:.4f} ms/page, {gb / (g / 1e3):.2f} "
                f"GB/s), upload {u:.3f} ms ({u / n:.4f} ms/page, "
                f"{gb / (u / 1e3):.2f} GB/s) against the link's "
                f"{spec.host_bw / 1e9:.1f} GB/s; predict_swap_time "
                f"{pred:.4f} ms; re-prefill {n} x {chunk_ms:.3f} = "
                f"{n * chunk_ms:.1f} ms")
        del eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the MoE family, dbrx-132b at its published widths
# ---------------------------------------------------------------------------


def logits_check(torch, cfg, params, reqs, log):
    """X's first prefill chunk and decode step (4 rows, a 64-row paged
    pool) on X's plan against the "torch" plan. With the "torch" run's
    expert choices forced every row must lie within 5 % of the "torch"
    logits' range; free, every row whose token chose the same experts in
    every layer must too, and the rows that chose otherwise are
    counted."""
    from repro_torch.core.plan import make_plan
    from repro_torch.models import moe
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import PagedLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    c = 64
    toks = torch.zeros((4, c), dtype=torch.int32, device="cuda")
    for i, (p, _) in enumerate(reqs[:4]):
        toks[i, :min(len(p), c)] = torch.as_tensor(p[:c], device="cuda")
    chunk_lens = torch.full((4,), c, dtype=torch.int32, device="cuda")
    zeros = torch.zeros((4,), dtype=torch.int32, device="cuda")
    bt = torch.arange(64, dtype=torch.int32, device="cuda").view(4, 16)
    route = moe.route

    def run(plan, nxt=None, force=None):
        """(prefill logits, decode logits, next tokens, each route call's
        expert choices), ``force`` replacing the choices call by call."""
        calls = []

        def routed(router, xg, k):
            probs, w, idx = route(router, xg, k)
            if force is not None:
                idx = force[len(calls)]
                w = probs.gather(-1, idx)
                w = w / w.sum(-1, keepdim=True)
            calls.append(idx)
            return probs, w, idx

        moe.route = routed
        try:
            ctx = LayerCtx(cfg, plan)
            cache = api.init_cache(PagedLayout(64, PAGE), device="cuda")
            with torch.no_grad():
                l1, cache = api.prefill_chunk(ctx, params, toks, chunk_lens,
                                              cache, zeros, block_tables=bt)
                if nxt is None:
                    nxt = l1[:, :cfg.vocab_size].argmax(-1).int()
                l2, _ = api.decode_step(ctx, params, nxt, cache, chunk_lens,
                                        block_tables=bt)
        finally:
            moe.route = route
        return l1, l2, nxt, calls

    x_plan = make_plan("cuda", decode_fusion="fused")
    c1, c2, nxt, ccalls = run(x_plan)
    t1, t2, _, tcalls = run(make_plan("torch"), nxt=nxt)
    f1, f2, _, _ = run(x_plan, nxt=nxt, force=tcalls)
    n_layers = cfg.num_layers
    for i, (what, got, forced, want) in enumerate((
            ("first prefill chunk", c1, f1, t1),
            ("first decode step", c2, f2, t2))):
        # the route calls of this step, one a layer; a row's own tokens:
        # the chunk's last position (prefill), its one token (decode)
        calls = zip(ccalls[i * n_layers:(i + 1) * n_layers],
                    tcalls[i * n_layers:(i + 1) * n_layers])
        flipped = torch.zeros(4, dtype=torch.bool, device="cuda")
        n_flips = 0
        for a, b in calls:
            rows = a.reshape(4, -1, a.shape[-1]).sort(-1).values != \
                b.reshape(4, -1, b.shape[-1]).sort(-1).values
            n_flips += int(rows.any(-1).sum())
            flipped |= rows[:, -1].any(-1)
        b_ = want[:, :cfg.vocab_size].float()
        rng_ = b_.abs().max().item()
        tol = 0.05 * rng_
        free = (got[:, :cfg.vocab_size].float() - b_).abs().amax(-1)
        same = (forced[:, :cfg.vocab_size].float() - b_).abs().amax(-1)
        log(f"logits {MOE_ARCH} {what}: X's plan vs torch plan, per row "
            f"max_abs_err free {[round(v, 4) for v in free.tolist()]}, with "
            f"the torch run's expert choices "
            f"{[round(v, 4) for v in same.tolist()]} (tol 5% of the range "
            f"{rng_:.3f} = {tol:.4f}); {n_flips} (token, layer) expert sets "
            f"differ, rows whose own token's did: "
            f"{flipped.nonzero().flatten().tolist()}; argmax agree "
            f"{(got[:, :cfg.vocab_size].argmax(-1) == b_.argmax(-1)).sum().item()}/4")
        check(bool((same <= tol).all()), f"{MOE_ARCH} {what} logits with "
              f"the same expert choices differ by {same.max().item()} > {tol}")
        check(bool((free[~flipped] <= tol).all()), f"{MOE_ARCH} {what} "
              "logits of rows whose experts agree differ by more than "
              f"{tol}")


def moe_runs():
    """(tag, engine kwargs, kernels that must launch) of runs X to X‴."""
    from repro_torch.core.plan import make_plan
    paged = dict(cache_kind="paged", page_size=PAGE)
    gather = make_plan("cuda", gather_chunk="dense", fused_ffn=False)
    attn = ("paged_decode_attention_unified_max",
            "paged_decode_attention_sync")
    chunk = ("paged_chunk_attention_unified_max",
             "paged_chunk_attention_sync")
    stages = ("decode_ingest_fused", "oproj_residual_fused", "flat_gemm")
    return [
        ("X paged fused chunk kernel, fused stages", dict(
            decode_fusion="fused", **paged), attn + chunk + stages),
        ("X' X looped", dict(decode_fusion="looped", **paged),
         attn + chunk + stages),
        ("X'' dense cache, D's plan", dict(plan=gather),
         ("flat_gemm", "decode_attention_unified_max",
          "decode_attention_sync")),
        ("X''' paged, D's plan", dict(plan=gather, **paged),
         ("flat_gemm",) + attn),
    ]


def moe_phase(torch, seed, lengths, log, launches):
    """Runs X to X‴: dbrx-132b at its published widths, cut to
    MOE_LAYERS layers, random bf16 weights from ``seed``; A's prompt
    lengths (tokens drawn from dbrx's vocabulary), 16 new tokens, 4
    slots, chunked prefill 64. X′ = X and X‴ = X″ token for token; every
    ``ops.matmul`` call of X at a ``called_gemm_shapes`` shape; X's first
    prefill and decode logits against the "torch" plan
    (:func:`logits_check`); busy and wall a tick of X and X′, the MoE
    tail's share of X's busy, and the tick's bytes against its bound."""
    import dataclasses

    import numpy as np

    from repro_torch import configs, hardware
    from repro_torch.core import dispatch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_leaves
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    cfg = dataclasses.replace(configs.get(MOE_ARCH), num_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(gen, device="cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(t.nbytes for t in tree_leaves(params))
    log(f"moe {MOE_ARCH}: {MOE_LAYERS} of {configs.get(MOE_ARCH).num_layers}"
        f" layers, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.num_experts_per_tok}, "
        f"vocabulary {cfg.vocab_size} (untied head); {weight_bytes / 1e9:.2f}"
        f" GB of weights drawn in {time.perf_counter() - t0:.1f}s; device "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(seed + 3)
    sp = SamplingParams(max_new_tokens=16)
    reqs = [(rng.integers(1, cfg.vocab_size, size=n).astype(np.int32), sp)
            for n in lengths]
    called = {(s.k, s.n) for s in dispatch.called_gemm_shapes(cfg)}
    outs = {}
    for tag, kw, expect in moe_runs():
        seen = set()
        real = ops.matmul
        if tag.startswith("X "):
            def recording(x, w, **k):
                out = real(x, w, **k)
                seen.add((x.shape[-1], out.shape[-1]))
                return out
            ops.matmul = recording
        try:
            eng = Engine(cfg, params, num_slots=4, max_seq=1024,
                         prefill_chunk=64, device="cuda", **kw)
            t0 = time.perf_counter()
            out, counts = counted_run(torch, eng, reqs, launches)
            dt = time.perf_counter() - t0
        finally:
            ops.matmul = real
        check_finished(tag, out, reqs, cfg.vocab_size)
        for n in expect:
            check(counts[n] > 0, f"{tag}: kernel {n} was never launched")
        graphs = ""
        if eng.ctx.graphs is not None:
            graphs = (f"; graphs {eng.stats.graph_captures} captured, "
                      f"{eng.stats.graph_replays} replays")
        log(f"serve {tag}: {len(out)} requests, "
            f"{sum(map(len, out.values()))} tokens in {dt:.3f}s, "
            f"{eng.ticks} decode ticks at "
            f"{1e3 * eng.stats.decode_seconds / max(eng.ticks, 1):.3f} "
            f"ms/tick{graphs}; launches "
            f"{json.dumps({n: c for n, c in counts.items() if c})}")
        if seen:
            check(seen <= called, f"{tag}: ops.matmul called at "
                  f"{sorted(seen - called)}, not a called_gemm_shapes shape")
            log(f"serve {tag}: every ops.matmul (K, N) {sorted(seen)} is a "
                f"called_gemm_shapes({MOE_ARCH}) shape")
        outs[tag.split()[0]] = ordered(out)
        del eng
    check(outs["X'"] == outs["X"], "run X′'s tokens differ from X's")
    check(outs["X'''"] == outs["X''"], "run X‴'s tokens differ from X″'s")
    agree = sum(a == b for x, y in zip(outs["X"], outs["X''"])
                for a, b in zip(x, y))
    log(f"serve moe contracts: X′ == X, X‴ == X″ token for token; X agrees "
        f"with X″ on {agree}/{16 * len(reqs)} tokens")

    # X's first prefill chunk and decode step against the "torch" plan. A
    # token whose router scores two experts within rounding of each other
    # may pick another expert set under each plan (the plans round the
    # router's input differently), which moves that row's logits by more
    # than rounding; so X's plan runs twice: free, and with the "torch"
    # run's expert choices (weights from its own router) forced
    logits_check(torch, cfg, params, reqs, log)

    # busy and wall a tick; the MoE tail's share of X's busy tick
    spec = hardware.H100_SXM
    tick_bytes = sum(t.nbytes for t in tree_leaves(params["layers"])) \
        + params["lm_head"].nbytes
    bound = 1e3 * tick_bytes / spec.hbm_bw
    real_mlp = moe._moe_mlp

    def annotated(*a, **k):
        with torch.profiler.record_function("moe_tail"):
            return real_mlp(*a, **k)

    moe._moe_mlp = annotated
    try:
        x = profile_phase(torch, cfg, params, reqs, log,
                          tag="X dbrx-132b paged fused stages",
                          ranges=("moe_tail",), cache_kind="paged",
                          page_size=PAGE, decode_fusion="fused")
    finally:
        moe._moe_mlp = real_mlp
    xl = profile_phase(torch, cfg, params, reqs, log,
                       tag="X' dbrx-132b paged looped", cache_kind="paged",
                       page_size=PAGE, decode_fusion="looped")
    for tag, r in (("X", x), ("X'", xl)):
        if r is not None:
            log(f"moe tick {tag}: {tick_bytes} bytes a tick (every layer's "
                f"weights, all experts read at zero drop, and the head) -> "
                f"bound {bound:.3f} ms at {spec.hbm_bw / 1e12:.2f} TB/s; "
                f"busy {r[0]:.3f} ms ({bound / r[0]:.2f} of the bound's "
                f"rate), wall {r[1]:.3f} ms")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: slice 7b, the RWKV6, Hymba and Whisper families at full width
# ---------------------------------------------------------------------------


def family_requests(np, cfg, seed, lengths, new=32):
    from repro_torch.serving.request import SamplingParams
    rng = np.random.default_rng(seed)
    sp = SamplingParams(max_new_tokens=new)
    return [(rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32),
             sp) for n in lengths]


def first_row_logits(eng, n_new):
    """Record the logits row of the engine's first request (rid 0, the
    first admitted, so row 0 of the first prefill wave and slot 0 of the
    decode ticks) for each of its ``n_new`` tokens: the prefill's and
    the next ``n_new - 1`` decode ticks'. Returns the list it fills."""
    import dataclasses
    rows = []
    api = eng.api

    def prefill(*a, **k):
        logits, cache = api.prefill(*a, **k)
        if not rows:
            rows.append(logits[0].float().clone())
        return logits, cache

    def decode_step(*a, **k):
        logits, cache = api.decode_step(*a, **k)
        if len(rows) < n_new:
            rows.append(logits[0].float().clone())
        return logits, cache

    eng.api = dataclasses.replace(api, prefill=prefill,
                                  decode_step=decode_step)
    return rows


def family_serve(torch, tag, cfg, params, reqs, max_seq, expect, log,
                 launches, plan=None):
    """Serve ``reqs`` on 4 slots (dense cache, ``plan`` or the default
    plan) with every launch counted and every ``ops.matmul`` (K, N)
    recorded, which must lie in ``called_gemm_shapes``; every kernel of
    ``expect`` must have launched (here or in the 1-slot run). Row batch
    invariance: the first request served alone on the same 4-slot engine
    (its wave's prompt bucket, so every launch has the run's shapes) must
    give its row's logits bit for bit at each of its steps, and so its
    tokens. Then the first request alone on 1 slot, where the GEMMs take
    row 1 (GEMV) at decode and other shapes at prefill: its tokens are
    counted against its row's (random weights carry the rounding of two
    kernel routes far, Hymba's most). Returns the 4-slot run's tokens in
    submission order."""
    from repro_torch.core import dispatch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine

    called = {(s.k, s.n) for s in dispatch.called_gemm_shapes(cfg)}
    seen = set()
    real = ops.matmul

    def recording(x, w, **k):
        out = real(x, w, **k)
        seen.add((x.shape[-1], out.shape[-1]))
        return out

    n_new = reqs[0][1].max_new_tokens
    ops.matmul = recording
    rows = {}
    try:
        eng = Engine(cfg, params, num_slots=4, max_seq=max_seq,
                     device="cuda", plan=plan)
        rows[4] = first_row_logits(eng, n_new)
        t0 = time.perf_counter()
        out, counts = counted_run(torch, eng, reqs, launches)
        dt = time.perf_counter() - t0
        alone = {}
        for slots in (4, 1):
            a_eng = Engine(cfg, params, num_slots=slots, max_seq=max_seq,
                           device="cuda", plan=plan)
            rows[-slots] = first_row_logits(a_eng, n_new)
            a_out, a_counts = counted_run(torch, a_eng, reqs[:1], launches)
            alone[slots] = (ordered(a_out)[0], a_counts)
    finally:
        ops.matmul = real
    check_finished(tag, out, reqs, cfg.vocab_size)
    one_counts = alone[1][1]
    for n in expect:
        check(counts[n] + one_counts[n] > 0,
              f"{tag}: kernel {n} was never launched")
    check(seen <= called, f"{tag}: ops.matmul called at "
          f"{sorted(seen - called)}, not a called_gemm_shapes shape")
    toks = ordered(out)
    log(f"serve {tag}: {len(out)} requests, {sum(map(len, toks))} tokens "
        f"in {dt:.3f}s, {eng.ticks} decode ticks at "
        f"{1e3 * eng.stats.decode_seconds / max(eng.ticks, 1):.3f} ms/tick, "
        f"prefill {eng.stats.prefill_seconds:.3f}s; launches "
        f"{json.dumps({n: c for n, c in counts.items() if c})}; alone on 1 "
        f"slot {json.dumps({n: c for n, c in one_counts.items() if c})}; "
        f"every ops.matmul (K, N) {sorted(seen)} is a called_gemm_shapes "
        "shape")
    check(all(len(r) == n_new for r in rows.values()), f"{tag}: a run "
          "recorded too few logits rows of its first request")
    same = all(torch.equal(a, b) for a, b in zip(rows[4], rows[-4]))
    check(same and alone[4][0] == toks[0], f"{tag}: the first request "
          "alone on the 4-slot engine does not give its row's logits bit "
          "for bit")
    one = alone[1][0]
    agree = sum(x == y for x, y in zip(toks[0], one))
    first = next((i for i, (x, y) in enumerate(zip(toks[0], one)) if x != y),
                 len(one))
    diffs = [(x[:cfg.vocab_size] - y[:cfg.vocab_size]).abs().max().item()
             for x, y in zip(rows[4], rows[-1])]
    log(f"serve {tag}: row batch invariance: the first request alone on "
        f"the 4-slot engine gives its row's logits bit for bit at all "
        f"{n_new} steps, and its tokens; alone on 1 slot (GEMV at decode) "
        f"{agree}/{len(one)} tokens agree, the first {first} in a row; max "
        f"|logits(row) - logits(1 slot)| {diffs[0]:.4f} at prefill, "
        f"{max(diffs[1:first + 1] or [0.0]):.4f} over the decode steps "
        "before the first difference")
    return toks


def family_logits(torch, cfg, params, reqs, max_seq, log, frames=None,
                  forced=False):
    """The first 4 requests' prefill and 8 teacher-forced decode steps on
    the default ("cuda") plan against the "torch" plan on the card, each
    step's logits within 5 % of the "torch" logits' range; the next
    tokens are the "torch" plan's argmax, and the steps whose argmax the
    plans share are counted. ``frames`` feed the encoder.

    ``forced``: every layer of the "cuda" run takes the "torch" run's
    input to that layer, and each decode step starts from the "torch"
    run's cache, so that the limit holds the kernels to the reference
    math layer by layer; each layer's update (output minus input) must
    then lie within 5 % of the "torch" update's range too. For a model
    whose random-init dynamics carry one bf16 rounding through the depth
    to a large share of the logits (Hymba: the same plan's 1-slot and
    4-slot routes differ by about half the range), the free-running
    difference is logged, not held."""
    from repro_torch.core.plan import DEFAULT_PLAN, make_plan
    from repro_torch.models import stack
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout, pow2_bucket
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    lens = [len(p) for p, _ in reqs[:4]]
    t = pow2_bucket(max(lens), lo=64, hi=max_seq)
    toks = torch.zeros((4, t), dtype=torch.int32, device="cuda")
    for i, (p, _) in enumerate(reqs[:4]):
        toks[i, :len(p)] = torch.as_tensor(p, device="cuda")
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = {} if frames is None else {"frames": frames}
    ctxs = {"torch": LayerCtx(cfg, make_plan("torch")),
            "cuda": LayerCtx(cfg, DEFAULT_PLAN)}
    real = stack.run_stack_cached
    layer_in, worst_layer = [], [0.0]

    def run_stack_cached(layers, x, cache, fn, mode):
        """Record each layer's input ("torch"), or run each layer on the
        recorded input and hold its update to the recorded one's."""
        outs = []
        for i, (p_i, c_i) in enumerate(zip(stack.unstack(layers),
                                           stack.unstack(cache))):
            if mode == "torch":
                layer_in.append(x)
            else:
                x = layer_in[i]
            y = fn(p_i, x, c_i)
            outs.append(y - x)
            x = y
        return x, cache, outs

    def step(name, fn, *a, **k):
        if not forced:
            return fn(ctxs[name], *a, **k) + (None,)
        got = {}

        def patched(layers, x, cache, blk):
            x, cache, got["upd"] = run_stack_cached(layers, x, cache, blk,
                                                    name)
            return x, cache

        stack.run_stack_cached = patched
        try:
            return fn(ctxs[name], *a, **k) + (got["upd"],)
        finally:
            stack.run_stack_cached = real

    caches = {n: api.init_cache(DenseLayout(4, max_seq), device="cuda")
              for n in ctxs}
    out = {n: [] for n in ctxs}
    with torch.no_grad():
        upd = {}
        for name in ("torch", "cuda"):
            lg, caches[name], upd[name] = step(
                name, api.prefill, params, toks, lengths, caches[name], **kw)
            out[name].append(lg[:, :cfg.vocab_size].float())
        for i in range(9):
            if forced:
                for u_t, u_c in zip(upd["torch"], upd["cuda"]):
                    lim = 0.05 * u_t.abs().max().item()
                    err = (u_c - u_t).abs().max().item()
                    worst_layer[0] = max(worst_layer[0], err / lim)
                    check(err <= lim, f"logits {cfg.name} step {i}: a "
                          f"layer's update on the default plan differs by "
                          f"{err} > {lim} (5% of its range)")
            if i == 8:
                break
            nxt = out["torch"][-1].argmax(-1).int()
            layer_in.clear()
            if forced:
                for n_, leaf in caches["cuda"].items():
                    leaf.copy_(caches["torch"][n_])
            for name in ("torch", "cuda"):
                lg, caches[name], upd[name] = step(
                    name, api.decode_step, params, nxt, caches[name],
                    lengths + i)
                out[name].append(lg[:, :cfg.vocab_size].float())
    del caches
    worst, agree = 0.0, 0
    for i, (got, want) in enumerate(zip(out["cuda"], out["torch"])):
        tol = 0.05 * want.abs().max().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err / tol)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
        check(err <= tol, f"logits {cfg.name} step {i}: the default plan's "
              f"logits differ from the torch plan's by {err} > {tol} (5% "
              "of the range)")
    how = ("every layer on the torch run's input and cache, each layer's "
           f"update within {worst_layer[0]:.3f} x its 5% limit; "
           if forced else "")
    if forced:
        # the free-running prefill, logged
        with torch.no_grad():
            free = [api.prefill(ctxs[n], params, toks, lengths,
                                api.init_cache(DenseLayout(4, max_seq),
                                               device="cuda"), **kw)[0]
                    [:, :cfg.vocab_size].float() for n in ("cuda", "torch")]
        log(f"logits {cfg.name} free-running prefill: default plan vs torch "
            f"plan max_abs_err {(free[0] - free[1]).abs().max().item():.4f} "
            f"against 5% of the range "
            f"{0.05 * free[1].abs().max().item():.4f} (not held: the depth "
            "carries each route's rounding)")
    log(f"logits {cfg.name}: prefill and 8 decode steps on the default plan "
        f"vs the torch plan ({how}teacher-forced tokens), worst max_abs_err "
        f"{worst:.3f} x the limit (5% of the torch logits' range); argmax "
        f"agree {agree}/36")


def chunked_vs_stepwise(torch, cfg, params, prompt, max_seq, log):
    """The prompt prefilled in one chunked pass against the same prompt
    stepped token by token, layer by layer: each layer's recurrence (the
    RWKV time mix, Hymba's SSD) stepped over the very input the chunked
    pass gave it must end in its state within the JAX package's limit
    (rtol = atol = 3e-2). The whole model stepped through
    ``decode_step`` is compared too and logged: there each layer's input
    already differs by the two paths' bf16 rounding, which grows with
    depth (on the CPU in bf16 too; the f32 model agrees exactly)."""
    from repro_torch.models import hybrid, ssm
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx

    api = get_model(cfg)
    ctx = LayerCtx(cfg)
    mod, name = ((ssm, "time_mix_chunked") if cfg.family == "ssm"
                 else (hybrid, "ssm_chunked"))
    real = getattr(mod, name)
    calls = []

    def recorded(ctx_, p, x, *a, **k):
        out = real(ctx_, p, x, *a, **k)
        calls.append((p, x, out[1]))
        return out

    toks = torch.as_tensor(prompt, device="cuda")[None]
    n = toks.shape[1]
    setattr(mod, name, recorded)
    try:
        with torch.no_grad():
            chunked = api.init_cache(DenseLayout(1, max_seq), device="cuda")
            _, chunked = api.prefill(ctx, params, toks, torch.tensor(
                [n], dtype=torch.int32, device="cuda"), chunked)
    finally:
        setattr(mod, name, real)
    check(len(calls) == cfg.num_layers, f"{cfg.name}: {len(calls)} "
          f"recurrences recorded for {cfg.num_layers} layers")
    worst, rels = 0.0, []
    with torch.no_grad():
        for p, x, s_chunk in calls:
            state = torch.zeros_like(s_chunk)
            last = torch.zeros_like(x[:, 0])
            for t in range(n):
                if cfg.family == "ssm":
                    _, state, last = ssm.time_mix_step(ctx, p, x[:, t],
                                                       state, last)
                else:
                    _, state = hybrid.ssm_step(ctx, p, x[:, t], state)
            ok = torch.allclose(s_chunk, state, rtol=3e-2, atol=3e-2)
            err = (s_chunk - state).abs()
            worst = max(worst, (err / (3e-2 + 3e-2 * state.abs())).max()
                        .item())
            rels.append(((s_chunk - state).norm() / state.norm()).item())
            check(ok, f"{cfg.name} layer {len(rels) - 1}: the chunked "
                  "state differs from the stepped one beyond 3e-2")
        stepped = api.init_cache(DenseLayout(1, max_seq), device="cuda")
        for i in range(n):
            _, stepped = api.decode_step(ctx, params, toks[:, i], stepped,
                                         torch.tensor([i], dtype=torch.int32,
                                                      device="cuda"))
    a, b = chunked["state"], stepped["state"]
    deep = [((a[i] - b[i]).norm() / b[i].norm()).item()
            for i in range(cfg.num_layers)]
    log(f"chunked vs stepwise {cfg.name}: {n}-token prompt; each layer's "
        f"recurrence on its chunked input, stepped: every state within "
        f"rtol = atol = 3e-2 (worst {worst:.3f} x the limit; relative norm "
        f"error {min(rels):.2e} .. {max(rels):.2e}); the whole model "
        f"stepped through decode_step: relative norm error of the state "
        f"layer 0 {deep[0]:.2e}, layer {cfg.num_layers // 2} "
        f"{deep[cfg.num_layers // 2]:.2e}, layer {cfg.num_layers - 1} "
        f"{deep[-1]:.2e} (bf16 rounding carried through the depth)")


def family_tick(torch, cfg, params, reqs, max_seq, tag, log, **engine_kw):
    """Busy and wall a decode tick (profile_phase) beside the tick's bound:
    the decoder's weights (every layer's and the head's bytes, read once a
    tick) over the card's memory rate."""
    from repro_torch import hardware
    from repro_torch.models.stack import tree_leaves
    spec = hardware.H100_SXM
    weight_bytes = sum(t.nbytes for t in tree_leaves(params["layers"]))
    weight_bytes += params["lm_head"].nbytes
    bound = 1e3 * weight_bytes / spec.hbm_bw
    r = profile_phase(torch, cfg, params, reqs, log, tag=tag,
                      max_seq=max_seq, **engine_kw)
    if r is not None:
        log(f"tick {tag}: {weight_bytes} weight bytes a tick (the decoder's "
            f"layers and the head) -> bound {bound:.3f} ms at "
            f"{spec.hbm_bw / 1e12:.2f} TB/s; busy {r[0]:.3f} ms ({bound / r[0]:.2f}"
            f" of the bound's rate), unprofiled wall {r[1]:.3f} ms, idle "
            f"{100 * (1 - r[0] / r[1]):.1f}%")
    return r


def looped_family_phase(torch, tag, cfg, params, reqs, max_seq, split, log,
                        launches, plan=None, split_tick=None):
    """``reqs`` served on a 4-slot engine under
    ``decode_fusion="looped"`` (``plan``'s other knobs; launches counted):
    the tokens must be the split run's ``split`` bit for bit, and the
    decode step must have been captured and replayed. With
    ``split_tick`` (the split run's (busy, unprofiled wall) a tick) the
    looped tick is profiled and printed beside it."""
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, num_slots=4, max_seq=max_seq, device="cuda",
                 plan=plan, decode_fusion="looped")
    out, counts = counted_run(torch, eng, reqs, launches)
    check_finished(f"{tag} looped", out, reqs, cfg.vocab_size)
    g = eng.ctx.graphs
    check(ordered(out) == split, f"{tag} looped: tokens differ from the "
          "split run's")
    check(g.captures > 0 and g.replays > 0, f"{tag} looped: the decode "
          "step was never captured and replayed")
    log(f"looped {tag}: {len(out)} requests, tokens bit for bit the split "
        f"run's; {g.captures} graphs captured, {g.replays} replays, "
        f"{g.eager_ticks} eager first ticks; {eng.ticks} decode ticks at "
        f"{1e3 * eng.stats.decode_seconds / max(eng.ticks, 1):.3f} ms/tick; "
        f"launches {json.dumps({n: c for n, c in counts.items() if c})}")
    if split_tick is None:
        return
    r = family_tick(torch, cfg, params, reqs, max_seq, f"{tag} looped", log,
                    decode_fusion="looped", plan=plan)
    if r is not None:
        log(f"tick {tag}: looped busy {r[0]:.3f} ms, unprofiled wall "
            f"{r[1]:.3f} ms a tick against split busy {split_tick[0]:.3f} "
            f"ms, wall {split_tick[1]:.3f} ms (wall {split_tick[1] / r[1]:.2f}"
            "x)")


def slice7b_phase(torch, seed, lengths, log, launches):
    """Runs Y (rwkv6-1.6b, A's prompt lengths, max_seq 1,024), Z
    (hymba-1.5b, A's lengths, max_seq 2,048), Z′ (hymba, 4 prompts of
    1,030-1,600 tokens: the window mask and the ring's wrap) and AA
    (whisper-tiny, 8 prompts of 4-64 tokens, max_seq 448, the engine's
    zero frames): full published widths, FAMILY_LAYERS' depth (the
    eager tick is host bound a layer), random bf16 weights
    from ``seed``, 32 new tokens, 4 slots, the dense cache; each run
    then again under ``decode_fusion="looped"`` (``looped_family_phase``,
    Y, Z and AA profiled beside their split ticks). Each family's
    weights are freed before the next one's are drawn."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.plan import make_plan
    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_leaves

    flash = ("flash_prefill_unified_max", "flash_prefill_sync")
    decode = ("decode_attention_unified_max", "decode_attention_sync")
    for arch, max_seq in (("rwkv6-1.6b", 1024), ("hymba-1.5b", 2048),
                          ("whisper-tiny", 448)):
        t_phase = time.perf_counter()
        cfg = configs.get(arch)
        cfg = dataclasses.replace(
            cfg, num_layers=FAMILY_LAYERS.get(arch, cfg.num_layers))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = get_model(cfg).init_params(gen, device="cuda")
        torch.cuda.synchronize()
        log(f"slice 7b {arch}: {cfg.num_layers} of "
            f"{configs.get(arch).num_layers} layers"
            f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
            f", d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocabulary "
            f"{cfg.vocab_size}; {sum(t.nbytes for t in tree_leaves(params)) / 1e9:.2f}"
            f" GB of weights; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if arch == "rwkv6-1.6b":
            reqs = family_requests(np, cfg, seed + 5, lengths)
            toks = family_serve(torch, "Y rwkv6-1.6b", cfg, params, reqs,
                                max_seq, ("gemv", "flat_gemm"), log,
                                launches)
            family_logits(torch, cfg, params, reqs, max_seq, log)
            chunked_vs_stepwise(torch, cfg, params, reqs[0][0][:64],
                                max_seq, log)
            tick = family_tick(torch, cfg, params, reqs, max_seq,
                               "Y rwkv6-1.6b", log)
            looped_family_phase(torch, "Y rwkv6-1.6b", cfg, params, reqs,
                                max_seq, toks, log, launches,
                                split_tick=tick)
        elif arch == "hymba-1.5b":
            reqs = family_requests(np, cfg, seed + 6, lengths)
            toks = family_serve(torch, "Z hymba-1.5b", cfg, params, reqs,
                                max_seq, ("gemv", "flat_gemm") + flash, log,
                                launches)
            # Z′ also fuses the FFN-up (row 8 on Hymba's MLP)
            long_reqs = family_requests(np, cfg, seed + 7,
                                        (1030, 1600, 1234, 1100))
            fused_ffn = make_plan("cuda", fused_ffn=True)
            long_toks = family_serve(
                torch, "Z' hymba-1.5b long prompts, fused FFN-up", cfg,
                params, long_reqs, max_seq,
                ("gemv", "flat_gemm", "fused_ffn_up") + flash, log,
                launches, plan=fused_ffn)
            family_logits(torch, cfg, params, reqs, max_seq, log,
                          forced=True)
            chunked_vs_stepwise(torch, cfg, params, reqs[0][0][:64],
                                max_seq, log)
            tick = family_tick(torch, cfg, params, reqs, max_seq,
                               "Z hymba-1.5b", log)
            looped_family_phase(torch, "Z hymba-1.5b", cfg, params, reqs,
                                max_seq, toks, log, launches,
                                split_tick=tick)
            looped_family_phase(torch, "Z' hymba-1.5b long prompts", cfg,
                                params, long_reqs, max_seq, long_toks, log,
                                launches, plan=fused_ffn)
        else:
            rng = np.random.default_rng(seed + 8)
            reqs = family_requests(np, cfg, seed + 9,
                                   rng.integers(4, 65, size=8))
            toks = family_serve(torch, "AA whisper-tiny", cfg, params, reqs,
                                max_seq, ("gemv", "flat_gemm") + flash
                                + decode, log, launches)
            frames = (torch.randn((4, 1500, cfg.d_model), generator=gen,
                                  device="cuda") * 0.5).to(torch.bfloat16)
            family_logits(torch, cfg, params, reqs, max_seq, log,
                          frames=frames)
            tick = family_tick(torch, cfg, params, reqs, max_seq,
                               "AA whisper-tiny", log)
            looped_family_phase(torch, "AA whisper-tiny", cfg, params, reqs,
                                max_seq, toks, log, launches,
                                split_tick=tick)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"slice 7b {arch}: phase {time.perf_counter() - t_phase:.1f}s")


TRAIN_STEPS = 20                      # qwen2-0.5b steps at full depth
TRAIN_SHAPE = (512, 8)                # (seq, batch) of those steps
CPU_SHAPE = (128, 2)                  # the 2-layer card-vs-CPU cases


def checkpoint_paths(tree, prefix=""):
    """A tree's leaf paths in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in checkpoint_paths(v, f"{prefix}/{k}")]
    return [prefix]


def grads_cosine(torch, a, b):
    """Cosine of two gradient tensors, in f64."""
    a, b = a.double().flatten(), b.double().flatten()
    den = (a.norm() * b.norm()).item()
    return 1.0 if den == 0 else float((a @ b).item() / den)


def train_profile(torch, cfg, plan, seed, wall_s, log):
    """Where a full-depth train step's time goes: the forward and
    backward pass and the AdamW update timed apart, then one step (after
    a warm one) under torch.profiler, its device busy time against
    ``wall_s`` (the loop's unprofiled median step), the kernels by
    family and the costliest ones; the table lands in
    chiprun_out/train_profile.txt."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import LayerCtx
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticTokens, device_batch
    from repro_torch.training.train_state import (TrainState,
                                                  make_train_step,
                                                  value_and_grad)

    api = get_model(cfg)
    step = make_train_step(api, LayerCtx(cfg=cfg, plan=plan),
                           RunConfig(learning_rate=1e-3, warmup_steps=2))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = TrainState.create(api.init_params(gen, device="cuda"))
    batch = device_batch(SyntheticTokens(cfg, ShapeConfig(
        "smoke", *TRAIN_SHAPE, "train"), seed=seed).batch_at(0), "cuda")
    state, met = step(state, batch)                 # warm
    float(met["loss"])
    # the step's two halves apart, host clock around synchronized work:
    # the forward and backward pass, then the AdamW update
    ctx = LayerCtx(cfg=cfg, plan=plan)
    halves = {"forward + backward": [], "AdamW update": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = value_and_grad(
            lambda p, b: api.train_loss(ctx, p, b, remat=True),
            state.params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.adamw_update(opt.AdamWConfig(), state.params, grads, state.m,
                         state.v, state.step)
        torch.cuda.synchronize()
        halves["forward + backward"].append(t1 - t0)
        halves["AdamW update"].append(time.perf_counter() - t1)
        del grads
    log("profile train step halves (median of 3, host clock, synchronized): "
        + ", ".join(f"{k} {1e3 * statistics.median(v):.1f} ms"
                    for k, v in halves.items()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = step(state, batch)
        float(met["loss"])
    del state
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in evs) / 1e3
    if busy_ms == 0:
        log("profile train step: device time not measured (the profiler "
            "reported none)")
        return
    # cuBLAS / cuBLASLt kernels: nvjet_* (Hopper bf16), *xmma_gemm* and
    # cutlass SIMT sgemm (the f32 attention products)
    kinds = {"GEMM (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass"),
             "reduce": ("reduce",), "copy / cast": ("copy",),
             "index / scatter / gather": ("index", "scatter", "gather")}
    by_kind = {k: 0.0 for k in kinds}
    for e in evs:
        for k, keys in kinds.items():
            if any(x in e.key for x in keys):
                by_kind[k] += e.self_device_time_total / 1e3
                break
    launches = sum(e.count for e in evs)
    log(f"profile train step ({ARCH}, {TRAIN_SHAPE[1]} x {TRAIN_SHAPE[0]},"
        f" one step): device busy {busy_ms:.2f} ms, {launches} kernel "
        f"launches; unprofiled median step {1e3 * wall_s:.2f} ms, idle "
        f"{100 * (1 - busy_ms / 1e3 / wall_s):.1f}%; by kind (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items())
        + f", other {busy_ms - sum(by_kind.values()):.2f}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")
    (OUT_DIR / "train_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))


# The card against the CPU in the train phase. Both sides run the same
# torch code, so these catch numerics that differ by device (an f32
# accumulation dropped to bf16, say). Each limit is about ten times the
# reading of an H100 80GB HBM3 at 700 W (PERF.md, PR 26): qwen2-0.5b on
# 2 layers, loss 4.5e-6, grad norm 5.4e-5, min leaf cosine 0.99994 (the
# cosine's limit ten times its shortfall from 1); the families' smoke
# losses at most 1.3e-4 (dbrx-132b).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
TRAIN_MIN_COSINE = 0.9994
TRAIN_FAMILY_RTOL = 1e-3


def train_phase(torch, seed, log):
    """The trainer on the card (the "torch" plan: library GEMMs and the
    reference attention, with autograd's backward; no kernel of the
    table runs, so no launch is counted):

      1. qwen2-0.5b at its published widths and depth (bf16 params from
         ``seed``, f32 moments, remat on): TRAIN_STEPS steps of
         ``SyntheticTokens`` through ``train_loop``; every loss finite,
         the mean of the last 5 below the first; ms a step, tokens/s and
         ``max_memory_allocated`` printed.
      2. The same widths on 2 layers, one forward and backward on the
         card and on the CPU from the same params and batch: the loss
         within TRAIN_LOSS_RTOL relative, the gradient norm within
         TRAIN_NORM_RTOL, every leaf's gradient at cosine >=
         TRAIN_MIN_COSINE.
      3. 2 layers, 8 steps with a checkpoint every 4: stopped at 4 and
         resumed, the losses bit for bit the uninterrupted run's.
      4. ``python -m repro_torch.launch.train --arch qwen2-0.5b --smoke``
         as a subprocess, SIGTERM after its first logged step: exit 0, a
         committed step, and a rerun resumes from it.
      5. One train step of every other family's smoke config, its loss
         within TRAIN_FAMILY_RTOL relative of the CPU's on the same
         params and batch."""
    import dataclasses
    import math
    import os
    import select
    import shutil
    import signal

    from repro_torch import configs
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import LayerCtx
    from repro_torch.models.stack import tree_leaves, tree_map
    from repro_torch.training import optimizer as opt
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import SyntheticTokens, device_batch
    from repro_torch.training.loop import train_loop
    from repro_torch.training.train_state import (TrainState,
                                                  make_train_step,
                                                  value_and_grad)

    plan = DEFAULT_PLAN.with_overrides(backend="torch")
    root = OUT_DIR / "train"
    shutil.rmtree(root, ignore_errors=True)

    def setup(cfg, steps, every, tag, seq_batch):
        api = get_model(cfg)
        run = RunConfig(learning_rate=1e-3, warmup_steps=2,
                        total_steps=steps, checkpoint_every=every,
                        checkpoint_dir=str(root / tag), seed=seed)
        step = make_train_step(api, LayerCtx(cfg=cfg, plan=plan), run)

        def init():
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return TrainState.create(api.init_params(gen, device="cuda"))

        return dict(model_cfg=cfg, shape=ShapeConfig("smoke", *seq_batch,
                                                     "train"),
                    run=run, train_step=step, init_state=init,
                    device="cuda", log_every=0, install_signals=False)

    try:
        # ---- 1. qwen2-0.5b at full width and depth
        cfg = configs.get(ARCH)
        seq, batch = TRAIN_SHAPE
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_loop(max_steps=TRAIN_STEPS, **setup(
            cfg, TRAIN_STEPS, TRAIN_STEPS, "full", TRAIN_SHAPE))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = res.losses
        med = statistics.median(res.step_times)
        check(len(losses) == TRAIN_STEPS
              and all(math.isfinite(x) for x in losses),
              f"train {ARCH}: a loss is not finite: {losses}")
        tail = sum(losses[-5:]) / 5
        check(tail < losses[0], f"train {ARCH}: the loss did not fall "
              f"({losses[0]:.4f} first, {tail:.4f} the last 5's mean)")
        log(f"train {ARCH}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, vocabulary {cfg.vocab_size}, bf16 params, f32 "
            f"moments, remat; {TRAIN_STEPS} steps of {batch} x {seq} "
            f"tokens: median {1e3 * med:.1f} ms a step (first "
            f"{1e3 * res.step_times[0]:.1f} ms), {batch * seq / med:.0f} "
            f"tokens/s; loss {losses[0]:.4f} -> {losses[-1]:.4f} (last 5 "
            f"mean {tail:.4f}); max_memory_allocated {peak / 2**30:.2f} GiB;"
            f" loop wall {wall:.1f}s with the final checkpoint")
        log(f"train {ARCH}: losses {[round(x, 4) for x in losses]}")
        shutil.rmtree(root / "full", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        train_profile(torch, cfg, plan, seed, med, log)
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 2. the card against the CPU, 2 layers
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        api = get_model(cfg2)
        params = api.init_params(torch.Generator().manual_seed(seed),
                                 device="cpu")
        hb = SyntheticTokens(cfg2, ShapeConfig("smoke", *CPU_SHAPE,
                                               "train"),
                             seed=seed).batch_at(0)
        ctx = LayerCtx(cfg=cfg2, plan=plan)

        def loss_fn(p, b):
            return api.train_loss(ctx, p, b, remat=True)

        t0 = time.perf_counter()
        cpu_l, cpu_g = value_and_grad(loss_fn, params,
                                      device_batch(hb, "cpu"))
        cpu_s = time.perf_counter() - t0
        gpu_l, gpu_g = value_and_grad(
            loss_fn, tree_map(lambda t: t.cuda(), params),
            device_batch(hb, "cuda"))
        # a second forward and backward on the card: the step must be
        # deterministic for a resumed run to repeat the uninterrupted one
        _, again_g = value_and_grad(
            loss_fn, tree_map(lambda t: t.cuda(), params),
            device_batch(hb, "cuda"))
        moved = [p for p, a, b in zip(
            checkpoint_paths(gpu_g), tree_leaves(gpu_g),
            tree_leaves(again_g)) if not torch.equal(a, b)]
        log(f"train 2 layers: a second backward pass on the card gives "
            f"{'every gradient bit for bit' if not moved else 'other bits in ' + str(moved)}")
        del again_g
        cpu_n = float(opt.global_norm(cpu_g))
        gpu_n = float(opt.global_norm(gpu_g))
        cos = [grads_cosine(torch, a.cpu(), b)
               for a, b in zip(tree_leaves(gpu_g), tree_leaves(cpu_g))]
        rel_l = abs(float(gpu_l) - float(cpu_l)) / abs(float(cpu_l))
        rel_n = abs(gpu_n - cpu_n) / cpu_n
        log(f"train 2 layers card vs CPU ({CPU_SHAPE[1]} x {CPU_SHAPE[0]}):"
            f" loss {float(gpu_l):.5f} vs {float(cpu_l):.5f} (rel "
            f"{rel_l:.2e}), grad norm {gpu_n:.5f} vs {cpu_n:.5f} (rel "
            f"{rel_n:.2e}), min leaf cosine {min(cos):.5f} over {len(cos)} "
            f"leaves; the CPU's step {cpu_s:.1f}s")
        check(rel_l <= TRAIN_LOSS_RTOL, "train: the card's loss is not "
              f"within {TRAIN_LOSS_RTOL} of the CPU's")
        check(rel_n <= TRAIN_NORM_RTOL, "train: the card's gradient norm is "
              f"not within {TRAIN_NORM_RTOL} of the CPU's")
        check(min(cos) >= TRAIN_MIN_COSINE, "train: a leaf's gradient on "
              f"the card is at cosine below {TRAIN_MIN_COSINE} to the CPU's")
        del params, cpu_g, gpu_g

        # ---- 3. resume equals uninterrupted, 2 layers
        t0 = time.perf_counter()
        kw = setup(cfg2, 8, 4, "resume", CPU_SHAPE)
        r1 = train_loop(max_steps=8, preempt_after=4, **kw)
        r2 = train_loop(max_steps=8, **kw)
        r3 = train_loop(max_steps=8, **setup(cfg2, 8, 4, "straight",
                                             CPU_SHAPE))
        check(r1.final_step == 4 and r2.restored_from == 4
              and r2.final_step == 8, "train: the resumed run did not stop "
              "at 4 and resume from it")
        same = r1.losses + r2.losses == r3.losses
        log(f"train resume: 8 steps (2 layers), stopped at 4 and resumed: "
            f"losses {'bit for bit' if same else 'NOT'} the uninterrupted "
            f"run's; {[round(x, 5) for x in r3.losses]}; "
            f"{time.perf_counter() - t0:.1f}s with 5 checkpoints")
        check(same, f"train: resumed losses {r1.losses + r2.losses} differ "
              f"from the uninterrupted {r3.losses}")
        shutil.rmtree(root / "resume", ignore_errors=True)
        shutil.rmtree(root / "straight", ignore_errors=True)

        # ---- 4. SIGTERM on the CLI, then resume
        t0 = time.perf_counter()
        ckpt = root / "cli"
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               ARCH, "--smoke", "--checkpoint-dir", str(ckpt),
               "--log-every", "1", "--seed", str(seed)]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        proc = subprocess.Popen(cmd + ["--steps", "100"], env=env,
                                stdout=subprocess.PIPE, text=True,
                                cwd=str(ROOT))
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 300)
            first = proc.stdout.readline() if ready else ""
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        latest = CheckpointManager(str(ckpt)).latest_step()
        check(first.startswith("step") and proc.returncode == 0
              and "preempted=True" in out and latest is not None,
              f"train CLI: SIGTERM gave exit {proc.returncode}, checkpoint "
              f"{latest}, output {first!r} {out[-300:]!r}")
        again = subprocess.run(cmd + ["--steps", str(latest + 2)], env=env,
                               capture_output=True, text=True, timeout=300,
                               cwd=str(ROOT))
        resumed = (f"finished at step {latest + 2} (restored_from={latest},"
                   in again.stdout)
        log(f"train CLI: SIGTERM after {first.strip()!r}: exit "
            f"{proc.returncode}, committed step {latest}; rerun exit "
            f"{again.returncode}: {again.stdout.strip().splitlines()[-1:]};"
            f" {time.perf_counter() - t0:.1f}s")
        check(again.returncode == 0 and resumed,
              f"train CLI: the rerun did not resume from step {latest}: "
              f"{again.stdout[-300:]!r} {again.stderr[-300:]!r}")

        # ---- 5. one step of every family's smoke config
        for arch in ("internvl2-76b", "dbrx-132b", "rwkv6-1.6b",
                     "hymba-1.5b", "whisper-tiny"):
            fcfg = configs.smoke(configs.get(arch))
            api = get_model(fcfg)
            params = api.init_params(torch.Generator().manual_seed(seed),
                                     device="cpu")
            hb = SyntheticTokens(fcfg, ShapeConfig("smoke", 32, 2, "train"),
                                 seed=seed).batch_at(0)
            ctx = LayerCtx(cfg=fcfg, plan=plan)
            with torch.no_grad():
                cpu_l = float(api.train_loss(ctx, params,
                                             device_batch(hb, "cpu")))
            step = make_train_step(api, ctx, RunConfig(learning_rate=1e-3))
            state, met = step(TrainState.create(tree_map(
                lambda t: t.cuda(), params)), device_batch(hb, "cuda"))
            gpu_l = float(met["loss"])
            rel = abs(gpu_l - cpu_l) / abs(cpu_l)
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in tree_leaves(state.params))
            log(f"train {arch} smoke: one step on the card, loss "
                f"{gpu_l:.5f} vs the CPU's {cpu_l:.5f} (rel {rel:.2e}); "
                f"grad norm {float(met['grad_norm']):.4f}; new params "
                f"{'finite' if finite else 'NOT finite'}")
            check(rel <= TRAIN_FAMILY_RTOL and finite, f"train {arch}: the "
                  f"card's loss is not within {TRAIN_FAMILY_RTOL} of the "
                  "CPU's, or a param is not finite")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: qwen2-0.5b x decode_32k on the card beside its dry run, and the
# examples
# ---------------------------------------------------------------------------

D32K = "decode_32k"
EXAMPLES = ("quickstart_torch", "serve_batch_torch", "streaming_serve_torch")


# profiler rows of host <-> device traffic: the copies, and gloo's
# annotations, which repeat the time of the copies they span
HOST_COPY_ROWS = ("Memcpy DtoH", "Memcpy HtoD", "gloo:")


def tick_busy_ms(torch, fn, log, tag="decode_32k", cpu=True,
                 host_copies=True):
    """Device busy (the sum of kernel times) of one call of ``fn`` under
    torch.profiler, in ms, with the costliest kernels logged (and the
    table written to ``chiprun_out/<tag>_profile.txt``); None when the
    profiler reports none. ``cpu=False`` traces the device only (a long
    call's host events take the profiler many seconds to summarise);
    ``host_copies=False`` leaves the HOST_COPY_ROWS out of the sum and
    logs the copies' own ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile {tag} {e.self_device_time_total / 1e3:8.4f} ms "
            f"{e.count:5d} calls  {e.key[:90]}")
    (OUT_DIR / f"{tag}_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25))
    if not host_copies:
        moved = sum(e.self_device_time_total for e in evs
                    if e.key.startswith("Memcpy")
                    and e.key.startswith(HOST_COPY_ROWS))
        log(f"profile {tag} host copies (left out of busy) "
            f"{moved / 1e3:.4f} ms")
        evs = [e for e in evs if not e.key.startswith(HOST_COPY_ROWS)]
    us = sum(e.self_device_time_total for e in evs)
    return us / 1e3 if us > 0 else None


def decode32k_phase(torch, seed, log, launches, rows):
    """The cell qwen2-0.5b x decode_32k (128 rows, every row at 32,767 of
    32,768 positions) on the card beside its dry run (run here, in
    process, on the meta device): the card's params and cache must come
    to the dry run's argument bytes exactly; one split decode tick on the
    "cuda" plan is timed (median of 5 CUDA-event walls after 2 warm-ups)
    and profiled (device busy); busy must not be below the floor
    (argument bytes over the card's memory rate) and the card's peak
    memory not above the dry run's per_device_bytes (the plain program's
    temporaries bound the kernel path's). Row 3 is held to its plain
    version on layer 0's cache and timed beside SDPA (the kernel table's
    "s32k" line); the tick's logits are held to the "torch" plan's."""
    import torch.nn.functional as F

    from repro_torch import configs, hardware
    from repro_torch.config import SHAPES
    from repro_torch.core.plan import make_plan
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import dryrun
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout
    from repro_torch.models.layers import LayerCtx
    from repro_torch.models.stack import tree_leaves

    spec = hardware.H100_SXM
    cfg = configs.get(ARCH)
    shape = SHAPES[D32K]
    b, s = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    rec = dryrun.run_cell(ARCH, D32K)
    check(rec["ok"], f"dry run of {ARCH} x {D32K} failed: "
          f"{rec.get('error', '')[-2000:]}")
    full, terms = rec["full"], rec["terms"]
    log(f"decode_32k dry run ({time.perf_counter() - t0:.1f}s on the CPU, "
        f"meta device, the plain program): arguments "
        f"{full['argument_size_in_bytes']} B, peak temporaries "
        f"{full['temp_size_in_bytes']} B, per_device_bytes "
        f"{full['per_device_bytes']} B, fits {full['fits']} in "
        f"{full['hbm_bytes']} B; counted {terms['hlo_flops']:.6e} FLOPs, "
        f"{terms['hlo_bytes']:.6e} bytes; model FLOPs "
        f"{terms['model_flops']:.6e}")
    check(full["fits"], f"{ARCH} x {D32K}: the dry run says it does not fit "
          "one card")

    gc.collect()
    torch.cuda.empty_cache()
    log(f"decode_32k: {torch.cuda.memory_allocated()} B allocated before "
        "the cell's tensors")
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = api.init_params(gen, device="cuda")
    cache = api.init_cache(DenseLayout(b, s), device="cuda")
    for leaf in cache.values():                # layer by layer, seeded
        for i in range(leaf.shape[0]):
            leaf[i] = torch.randn(leaf.shape[1:], generator=gen,
                                  device="cuda", dtype=leaf.dtype)
    tokens = torch.randint(1, cfg.vocab_size, (b,), generator=gen,
                           device="cuda", dtype=torch.int32)
    lengths = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    arg_bytes = sum(t.nbytes for t in tree_leaves(params)
                    + tree_leaves(cache) + [tokens, lengths])
    log(f"decode_32k: the card's params, cache, tokens and lengths "
        f"{arg_bytes} B; the dry run's argument_size_in_bytes "
        f"{full['argument_size_in_bytes']} B")
    check(arg_bytes == full["argument_size_in_bytes"],
          "decode_32k: the card's argument bytes differ from the dry run's")

    ctx = LayerCtx(cfg, make_plan("cuda"))

    def tick():
        with torch.no_grad():
            return api.decode_step(ctx, params, tokens, cache, lengths)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        tick()
    walls = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tick()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    wall = statistics.median(walls)
    for fn in counters().values():
        fn.launches = 0
    busy = tick_busy_ms(torch, tick, log)
    per_tick = {n: fn.launches for n, fn in counters().items()
                if fn.launches}
    for n, c in per_tick.items():
        launches[n] = launches.get(n, 0) + c
    peak = torch.cuda.max_memory_allocated()
    floor = 1e3 * full["argument_size_in_bytes"] / spec.hbm_bw
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
    log(f"decode_32k tick ({smi}): busy {busy_s}, wall {wall:.3f} ms "
        f"(median of 5 CUDA-event walls: "
        f"{', '.join(f'{w:.3f}' for w in walls)}); floor (argument bytes / "
        f"{spec.hbm_bw / 1e12:.2f} TB/s) {floor:.3f} ms"
        + ("" if busy is None else f", busy at {floor / busy:.3f} of it"))
    log(f"decode_32k tick: max_memory_allocated {peak} B against the dry "
        f"run's per_device_bytes {full['per_device_bytes']} B")
    log(f"decode_32k dry-run terms (datasheet peaks, the plain program's "
        f"unfused counts): memory {1e3 * terms['memory_s']:.3f} ms, compute "
        f"{1e3 * terms['compute_s']:.3f} ms; model FLOPs / peak bf16 "
        f"{1e3 * terms['model_flops'] / spec.peak_flops_bf16:.4f} ms")
    log(f"decode_32k tick: kernel launches per tick {json.dumps(per_tick)}")
    check(busy is None or busy >= floor,
          f"decode_32k: busy {busy} ms below the floor {floor} ms")
    check(wall >= floor, f"decode_32k: wall {wall} ms below the floor "
          f"{floor} ms")
    check(peak <= full["per_device_bytes"],
          f"decode_32k: peak memory {peak} B above the dry run's "
          f"per_device_bytes {full['per_device_bytes']} B")
    check(per_tick.get("decode_attention_unified_max", 0)
          == cfg.num_layers, "decode_32k: row 3 did not launch once a layer")
    logits = tick().clone()

    # row 3 on layer 0's cache against its plain version, beside SDPA
    timer = Timer(torch)
    hd, hq, hk = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (torch.randn((b, hq, hd), generator=gen, device="cuda")).to(
        torch.bfloat16)
    kt, vt = cache["k"][0].transpose(1, 2), cache["v"][0].transpose(1, 2)
    phi = cfg.softmax_phi.phi
    out, stat = da.decode_attention_unified_max(q, kt, vt, lengths, phi=phi)
    want, want_stat = da.decode_attention_unified_max_plain(q, kt, vt,
                                                            lengths, phi=phi)
    err = (out.float() - want.float()).abs().max().item()
    serr = (stat - want_stat).abs().max().item()
    ok, tol = attn_close(out, want)
    del want, want_stat
    q4 = q[:, :, None, :]
    try:
        lib = lambda: F.scaled_dot_product_attention(q4, kt, vt,
                                                     enable_gqa=True)
        lib()
    except (TypeError, RuntimeError) as e:   # no GQA in this torch's SDPA
        log(f"decode_32k: SDPA not timed ({e!r:.200})")
        lib = None
    n_valid = b * (s - 1)
    b_ms, b_by = bound_ms(2 * (2 * b * hq * hd + 2 * n_valid * hk * hd)
                          + 4 * b * hk, 4 * n_valid * hq * hd, spec)
    k_ms = timer.ms(lambda: da.decode_attention_unified_max(
        q, kt, vt, lengths, phi=phi))
    p_ms = timer.ms(lambda: da.decode_attention_unified_max_plain(
        q, kt, vt, lengths, phi=phi), reps=5)
    l_ms = timer.ms(lib) if lib is not None else None
    del timer
    case = f"B={b} S={s} every row at {s - 1} ({s // 64} splits)"
    log(f"kernel decode_attention_unified_max {case:34s} max_abs_err="
        f"{err:.3e} ({tol}) stat max_abs_err={serr:.3e} kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} library_ms="
        f"{'n/a' if l_ms is None else f'{l_ms:.4f}'} bound_ms={b_ms:.4f} "
        f"({b_by}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"decode_attention_unified_max {case}: kernel disagrees with "
          "its plain version")
    check(serr <= 1e-2 * max(1.0, stat.abs().max().item()),
          f"decode_attention_unified_max {case}: stat disagrees")
    row = rows.setdefault("decode_attention_unified_max",
                          {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["s32k"] = dict(case=case, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=b_ms, bound_by=b_by)

    # the tick against the "torch" plan on the same inputs
    tctx = LayerCtx(cfg, make_plan("torch"))
    with torch.no_grad():
        want = api.decode_step(tctx, params, tokens, cache, lengths)[0]
    a = logits[:, :cfg.vocab_size].float()
    w = want[:, :cfg.vocab_size].float()
    row_err = (a - w).abs().amax(-1)
    lerr = row_err.max().item()
    tok = a.argmax(-1)
    agree = tok == w.argmax(-1)
    # where the greedy tokens differ, the "cuda" token's "torch" logit must
    # lie within twice the row's error of the "torch" maximum: a near tie
    # that the two roundings break apart, not a wrong token
    gap = w.amax(-1) - w.gather(1, tok[:, None])[:, 0]
    near = gap <= 2 * row_err
    log(f"decode_32k logits: cuda plan vs torch plan max_abs_err={lerr:.4f} "
        f"(tol {LOGITS_TOL}; logit range {w.abs().max().item():.2f}); greedy "
        f"tokens agree {int(agree.sum())}/{b}; of the {int((~agree).sum())} "
        f"that differ, {int((near & ~agree).sum())} are near ties (the "
        f"token's torch logit within twice the row's error of the row's "
        f"max; largest gap {gap.max().item():.4f})")
    check(lerr <= LOGITS_TOL, f"decode_32k: logits differ by {lerr} > "
          f"{LOGITS_TOL}")
    check(bool((agree | near).all()),
          "decode_32k: a greedy token differs from the torch plan's by more "
          "than a near tie")
    del params, cache, logits, want, q, out, stat
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 8a: T1's sequence-split decode over torch.distributed
# ---------------------------------------------------------------------------

S8A_B, S8A_S = 4, 32768               # qwen2-0.5b, 4 rows of 32k positions
# some rows have no key on some slices; row 1 crosses the W = 2 boundary
# (position 16,384) at its fifth tick
S8A_LENGTHS = (31000, 16380, 9000, 40)
S8A_TICKS = 16
S8A_WATCH_ROW = 1
S8A_SCHEMES = ("unified_max", "sync")
S8A_PARTIALS = {"unified_max": "decode_attention_partial_unified_max",
                "sync": "decode_attention_partial_sync"}
S8A_TIMEOUT = 300                     # seconds, each rank of the gloo run


def partial_close(torch, got, want):
    """A shard partial (num, den, aux) against its plain version: the
    slice's attention output num / den within ATTN_REL x each row's RMS
    (attn_close), den within ATTN_REL of itself, aux (a max of f32
    scores) within 1e-2, and a row with no key on the slice exactly 0, 0
    and -inf in both. Returns (ok, tolerance text, max |Δ(num / den)|)."""
    (gn, gd, ga), (wn, wd, wa) = got, want
    empty = wd == 0
    one = torch.ones_like(wd)
    go = gn / torch.where(empty, one, gd)[..., None]
    wo = wn / torch.where(empty, one, wd)[..., None]
    live = ~empty
    ok_out, tol = attn_close(go[live], wo[live])
    ok = (ok_out
          and bool(((gd - wd).abs() <= ATTN_REL * wd).all())
          and bool(((ga - wa).abs()[live] <= 1e-2).all())
          and bool((gd[empty] == 0).all() and (gn[empty] == 0).all())
          and bool((ga[empty] == -torch.inf).all()
                   and (wa[empty] == -torch.inf).all()))
    err = (go - wo).abs().max().item()
    return ok, (f"{tol}; den within {ATTN_REL} of itself, aux within "
                f"1e-2, {int(empty.sum())} empty rows 0 / 0 / -inf"), err


def slice8a_kernel_checks(torch, timer, cfg, log, rows):
    """Rows 3 and 4 as shard partials at qwen2-0.5b's width, B 4 x S
    32,768 cut into W = 2 and 4 slices: each slice's partial against its
    plain version, timed beside SDPA (GQA, the slice's length mask) and
    the bound on the slice's bytes; the slices joined by
    core.softmax.combine_async / combine_sync against the unsharded row
    3 / row 4 kernel."""
    import torch.nn.functional as F

    from repro_torch import hardware
    from repro_torch.core import softmax as smx
    from repro_torch.kernels import decode_attention as da

    spec = hardware.H100_SXM
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b, s = S8A_B, S8A_S
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b, s, hk, hd), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    lengths = torch.tensor(S8A_LENGTHS, dtype=torch.int32, device="cuda")
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    phi = cfg.softmax_phi.phi
    whole = {"unified_max": da.decode_attention_unified_max(
        q, kt, vt, lengths, phi=phi)[0],
        "sync": da.decode_attention_sync(q, kt, vt, lengths)}
    kern = {"unified_max": lambda *a: da.decode_attention_partial_unified_max(
        *a, phi=phi), "sync": da.decode_attention_partial_sync}
    plain = {"unified_max": lambda *a: da.decode_attention_partial_plain(
        *a, unified_max=True, phi=phi),
        "sync": lambda *a: da.decode_attention_partial_plain(
            *a, unified_max=False)}
    q4 = q[:, :, None, :]
    for w in (2, 4):
        sl = s // w
        parts = {sch: [] for sch in S8A_SCHEMES}
        for i in range(w):
            args = (q, kt[:, :, i * sl:(i + 1) * sl],
                    vt[:, :, i * sl:(i + 1) * sl], lengths, i * sl)
            loc = da.local_lengths(lengths, i * sl, sl)
            n_valid = int(loc.sum())
            mask = (torch.arange(sl, device="cuda")[None, :]
                    < loc[:, None])[:, None, None, :]
            try:
                lib = lambda a=args, m=mask: F.scaled_dot_product_attention(
                    q4, a[1], a[2], attn_mask=m, enable_gqa=True)
                lib()
            except (TypeError, RuntimeError) as e:   # no GQA in this SDPA
                log(f"slice 8a: SDPA not timed ({e!r:.200})")
                lib = None
            b_ms, b_by = bound_ms(
                2 * b * hq * hd + 2 * 2 * n_valid * hk * hd + 4 * b
                + 4 * b * hq * hd + 2 * 4 * b * hq, 4 * n_valid * hq * hd,
                spec)
            for sch in S8A_SCHEMES:
                got = kern[sch](*args)
                want = plain[sch](*args)
                parts[sch].append(got)
                ok, tol, err = partial_close(torch, got, want)
                name = S8A_PARTIALS[sch]
                case = (f"W={w} slice {i} (keys {i * sl}..{(i + 1) * sl - 1}"
                        f", {n_valid} valid)")
                k_ms = timer.ms(lambda: kern[sch](*args))
                p_ms = timer.ms(lambda: plain[sch](*args), reps=3)
                l_ms = timer.ms(lib) if lib is not None else None
                log(f"kernel {name:36s} {case:44s} max_abs_err={err:.3e} "
                    f"({tol}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={'n/a' if l_ms is None else f'{l_ms:.4f}'} "
                    f"bound_ms={b_ms:.4f} ({b_by}) "
                    f"{'ok' if ok else 'MISMATCH'}")
                check(ok, f"{name} {case}: kernel disagrees with its plain "
                      "version")
                row = rows.setdefault(name, {"max_abs_err": 0.0})
                row["max_abs_err"] = max(row["max_abs_err"], err)
                entry = dict(case=case, ms=k_ms, plain_ms=p_ms,
                             library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
                if (w, i) == (2, 0):
                    row.update(entry)
                else:
                    row[f"W{w}_slice{i}"] = entry
        joined = {"unified_max": smx.combine_async(
            [smx.AsyncPartial(*p) for p in parts["unified_max"]])[0],
            "sync": smx.combine_sync(
                [smx.SyncPartial(*p) for p in parts["sync"]])}
        for sch in S8A_SCHEMES:
            ok, tol = attn_close(joined[sch], whole[sch])
            log(f"slice 8a: W={w} {sch} partials joined by core.softmax vs "
                f"the unsharded kernel: {tol} {'ok' if ok else 'MISMATCH'}")
            check(ok, f"slice 8a: W={w} {sch} joined partials disagree with "
                  "the unsharded kernel")
    del q, k, v, kt, vt, whole, parts, joined


def s8a_model(torch, cfg, seed, w=1, rank=0):
    """qwen2-0.5b's params from ``seed`` and this rank's slice of the 4 x
    32,768 cache (every rank draws the whole cache layer by layer from
    ``seed + 1`` and keeps its slice, so the slices join to the unsharded
    cache bit for bit); tokens from ``seed``, the S8A_LENGTHS."""
    import numpy as np

    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import DenseLayout

    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = api.init_params(gen, device="cuda")
    s_loc = S8A_S // w
    cache = api.init_cache(DenseLayout(S8A_B, s_loc), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for leaf in cache.values():
        for i in range(leaf.shape[0]):
            full = torch.randn((S8A_B, S8A_S) + tuple(leaf.shape[3:]),
                               generator=gen, device="cuda",
                               dtype=leaf.dtype)
            leaf[i] = full[:, rank * s_loc:(rank + 1) * s_loc]
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=S8A_B).astype(np.int32)).cuda()
    lengths = torch.tensor(S8A_LENGTHS, dtype=torch.int32, device="cuda")
    return api, params, cache, tokens, lengths


def slice8a_rank(rank, world, out_dir, seed):
    """One rank of the gloo run (a process of its own on cuda:0): 16
    greedy ticks of qwen2-0.5b with its 32k cache split over ``world``
    ranks, under each scheme; writes ``rank<r>.pt`` into ``out_dir``:
    logits (rank 0), tokens, each tick's wall, one tick's device busy,
    the all-reduces of one tick, the kernels' launches and the KV
    placement of the watched row."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.core.attention import make_decode_attention_fn
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import make_rules
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.layers import LayerCtx

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def log(line):
        lines.append(line)

    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=S8A_TIMEOUT // 2))
    try:
        mesh_cfg = MeshConfig((1, world), ("data", "model"))
        mesh = make_mesh_from_config(mesh_cfg, backend="gloo")
        rules = make_rules(mesh_cfg)
        cfg = configs.get(ARCH)
        s_loc = S8A_S // world
        start = rank * s_loc
        res = {}
        for scheme in S8A_SCHEMES:
            api, params, cache, tokens, lengths = s8a_model(
                torch, cfg, seed, world, rank)
            fn = make_decode_attention_fn(mesh, rules, cfg.softmax_phi,
                                          scheme=scheme, backend="cuda")
            ctx = LayerCtx(cfg, make_plan("cuda", scheme=scheme),
                           decode_attention_fn=fn)
            watch = [(leaf, i) for leaf in (cache["k"], cache["v"])
                     for i in (0, cfg.num_layers - 1)]
            for c in counters().values():
                c.launches = 0
            logits, toks, walls, placement = [], [], [], []
            busy = n_ar = None
            for t in range(S8A_TICKS):
                before = [leaf[i, S8A_WATCH_ROW].clone() for leaf, i in watch]
                pos = int(lengths[S8A_WATCH_ROW])

                def tick():
                    with torch.no_grad():
                        return api.decode_step(ctx, params, tokens, cache,
                                               lengths)[0]

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if t == 1:
                    with CostCounter() as cc:
                        lg = tick()
                    n_ar = cc.collectives.counts.get("all-reduce", 0)
                elif t == S8A_TICKS - 1:
                    box = []
                    busy = tick_busy_ms(torch, lambda: box.append(tick()),
                                        log, tag=f"slice8a_{scheme}_rank"
                                        f"{rank}")
                    lg = box[0]
                else:
                    lg = tick()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
                # which local positions of the watched row this tick wrote
                wrote = set()
                for (leaf, i), old in zip(watch, before):
                    diff = (leaf[i, S8A_WATCH_ROW] != old).flatten(1).any(-1)
                    wrote |= set(diff.nonzero().flatten().tolist())
                placement.append((pos, sorted(wrote)))
                if rank == 0:
                    logits.append(lg.float().cpu())
                tokens = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                toks.append(tokens.cpu())
                lengths = lengths + 1
            res[scheme] = dict(
                logits=logits, tokens=toks, walls=walls, busy=busy,
                allreduces=n_ar, placement=placement, start=start,
                launches={n: c.launches for n, c in counters().items()
                          if c.launches})
            del params, cache
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    res["log"] = lines
    torch.save(res, out_dir / f"rank{rank}.pt")


def s8a_spawn(seed, out_dir, world=2):
    """The gloo ranks as subprocesses; each is joined with S8A_TIMEOUT,
    and a rank that fails or passes it kills the others and fails the
    phase."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    logs = [open(out_dir / f"rank{r}.out", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.slice8a_rank("
         f"{r}, {world}, {str(out_dir)!r}, {seed})"], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + S8A_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        out = (out_dir / f"rank{r}.out").read_text()
        check(p.returncode == 0, f"slice 8a: gloo rank {r} exited "
              f"{p.returncode}: {out[-3000:]}")


def slice8a_phase(torch, seed, log, launches, rows):
    """Slice 8a on the card. (1) Rows 3 and 4 as shard partials
    (slice8a_kernel_checks). (2) NCCL at world size 1, in this process:
    a full-width qwen2-0.5b tick through decode_attention_sharded on a
    one-rank model group, both schemes, within LOGITS_TOL of the
    unsharded "cuda" tick. (3) Two gloo ranks on cuda:0 (NCCL refuses two
    ranks on one card), qwen2-0.5b at its published widths and depth
    with the 32k cache split into two 16,384-position slices: 16 greedy
    ticks per scheme; every tick's logits within LOGITS_TOL of the same
    ticks run unsharded here (fed the ranks' tokens), tokens equal or
    near ties, the watched row's new KV on the rank that holds its
    position and nowhere else, 24 all-reduces a tick under unified_max
    and 48 under sync. The ranks' walls pass through gloo's host copies:
    not a multi-card number."""
    import datetime
    import os
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.config import MeshConfig
    from repro_torch.core.attention import make_decode_attention_fn
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import make_rules
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.layers import LayerCtx

    cfg = configs.get(ARCH)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    timer = Timer(torch)
    slice8a_kernel_checks(torch, timer, cfg, log, rows)
    del timer
    gc.collect()
    torch.cuda.empty_cache()

    def diff(a, w):
        """max |Δ| over the vocabulary, each row's, and the near-tie
        rule of decode32k_phase for the greedy tokens of ``a``."""
        a = a[:, :cfg.vocab_size].float()
        w = w[:, :cfg.vocab_size].float()
        row_err = (a - w).abs().amax(-1)
        tok = a.argmax(-1)
        gap = w.amax(-1) - w.gather(1, tok[:, None])[:, 0]
        agree = tok == w.argmax(-1)
        return row_err.max().item(), agree, gap <= 2 * row_err

    # (2) NCCL at world size 1, in this process
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh_cfg = MeshConfig((1, 1), ("data", "model"))
        mesh = make_mesh_from_config(mesh_cfg)
        check(mesh.backend == "nccl", "slice 8a: the cuda mesh is not NCCL")
        rules = make_rules(mesh_cfg)
        api, params, cache, tokens, lengths = s8a_model(torch, cfg, seed)
        for scheme in S8A_SCHEMES:
            fn = make_decode_attention_fn(mesh, rules, cfg.softmax_phi,
                                          scheme=scheme, backend="cuda")
            sharded = LayerCtx(cfg, make_plan("cuda", scheme=scheme),
                               decode_attention_fn=fn)
            whole = LayerCtx(cfg, make_plan("cuda", scheme=scheme))
            for c in counters().values():
                c.launches = 0
            with torch.no_grad():
                got = api.decode_step(sharded, params, tokens, cache,
                                      lengths)[0].clone()
            torch.cuda.synchronize()
            per_tick = {n: c.launches for n, c in counters().items()
                        if c.launches}
            for n, c in per_tick.items():
                launches[n] = launches.get(n, 0) + c
            with torch.no_grad():
                want = api.decode_step(whole, params, tokens, cache,
                                       lengths)[0]
            err, agree, near = diff(got, want)
            log(f"slice 8a NCCL world size 1 ({scheme}): logits vs the "
                f"unsharded cuda tick max_abs_err={err:.4f} (tol "
                f"{LOGITS_TOL}); greedy tokens agree {int(agree.sum())}/"
                f"{S8A_B}, near ties {int((near & ~agree).sum())}; "
                f"launches {json.dumps(per_tick)}")
            check(err <= LOGITS_TOL, f"slice 8a NCCL {scheme}: logits differ "
                  f"by {err}")
            check(bool((agree | near).all()), f"slice 8a NCCL {scheme}: a "
                  "greedy token differs by more than a near tie")
            check(per_tick.get(S8A_PARTIALS[scheme], 0) == cfg.num_layers,
                  f"slice 8a NCCL {scheme}: the partial kernel did not "
                  "launch once a layer")
    finally:
        dist.destroy_process_group()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # (3) two gloo ranks on cuda:0, then the same ticks unsharded here
    out_dir = Path(tempfile.mkdtemp(prefix="slice8a_"))
    try:
        t0 = time.perf_counter()
        s8a_spawn(seed, out_dir)
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"slice 8a gloo run: 2 ranks on cuda:0, {S8A_TICKS} ticks per "
            f"scheme, {time.perf_counter() - t0:.1f}s with the ranks' start")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        for line in res["log"]:
            log(f"slice 8a rank {r}: {line}")
    api, params, cache, tokens0, lengths0 = s8a_model(torch, cfg, seed)
    s_loc = S8A_S // 2
    for scheme in S8A_SCHEMES:
        if scheme != S8A_SCHEMES[0]:        # the first scheme's ticks wrote
            del cache
            api, params, cache, tokens0, lengths0 = s8a_model(torch, cfg,
                                                              seed)
        ctx = LayerCtx(cfg, make_plan("cuda", scheme=scheme))
        r0, r1 = ranks[0][scheme], ranks[1][scheme]
        tokens, lengths = tokens0, lengths0
        worst, ties = 0.0, 0
        for t in range(S8A_TICKS):
            with torch.no_grad():
                want = api.decode_step(ctx, params, tokens, cache,
                                       lengths)[0].float().cpu()
            err, agree, near = diff(r0["logits"][t], want)
            worst = max(worst, err)
            ties += int((near & ~agree).sum())
            check(err <= LOGITS_TOL, f"slice 8a gloo {scheme} tick {t}: "
                  f"logits differ by {err}")
            check(bool((agree | near).all()), f"slice 8a gloo {scheme} tick "
                  f"{t}: a greedy token differs by more than a near tie")
            check(torch.equal(r0["tokens"][t], r1["tokens"][t]),
                  f"slice 8a gloo {scheme} tick {t}: the ranks' tokens "
                  "differ")
            # the unsharded run takes the ranks' tokens (teacher forcing)
            tokens = r0["tokens"][t].cuda()
            lengths = lengths + 1
        # the watched row's KV: on the rank that holds each position only
        for r, res in enumerate((r0, r1)):
            for pos, wrote in res["placement"]:
                own = res["start"] <= pos < res["start"] + s_loc
                check(wrote == ([pos - res["start"]] if own else []),
                      f"slice 8a gloo {scheme}: rank {r} wrote local "
                      f"positions {wrote} of row {S8A_WATCH_ROW} for "
                      f"position {pos}")
        crossing = [(pos, wrote) for pos, wrote in r1["placement"] if wrote]
        per_layer = 1 if scheme == "unified_max" else 2
        for r, res in enumerate((r0, r1)):
            check(res["allreduces"] == per_layer * cfg.num_layers,
                  f"slice 8a gloo {scheme}: rank {r} issued "
                  f"{res['allreduces']} all-reduces in a tick, not "
                  f"{per_layer * cfg.num_layers}")
            for n, c in res["launches"].items():
                launches[n] = launches.get(n, 0) + c
            check(res["launches"].get(S8A_PARTIALS[scheme], 0)
                  == S8A_TICKS * cfg.num_layers,
                  f"slice 8a gloo {scheme}: rank {r}'s partial kernel did "
                  "not launch once a layer a tick")
        walls = [statistics.median(res["walls"]) for res in (r0, r1)]
        busy = ["not measured" if res["busy"] is None
                else f"{res['busy']:.3f} ms" for res in (r0, r1)]
        log(f"slice 8a gloo {scheme} ({smi}): {S8A_TICKS} ticks, logits vs "
            f"unsharded max_abs_err={worst:.4f} (tol {LOGITS_TOL}), near "
            f"ties {ties}; row {S8A_WATCH_ROW}'s KV on rank 1 at local "
            f"{[w[0] for _, w in crossing]} for positions "
            f"{[p for p, _ in crossing]}; all-reduces a tick "
            f"{r0['allreduces']} / {r1['allreduces']}; per rank wall "
            f"(median of {S8A_TICKS}) {walls[0]:.3f} / {walls[1]:.3f} ms, "
            f"busy {busy[0]} / {busy[1]} (one tick, profiled); the walls "
            "carry gloo's host copies and both ranks share one card: not a "
            "multi-card number")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()


# slice 8b-1: the sharded trainer, qwen2-0.5b at full width and depth
S8B_STEPS = 3
# the CLI's flags of every slice 8b-1 run (seq 512, batch 8, lr 1e-3;
# RunConfig from launch/train.py's run_config, warmup 1 step)
S8B_ARGS = ["--arch", ARCH, "--steps", str(S8B_STEPS), "--batch", "8",
            "--seq", "512", "--lr", "1e-3"]
# (mesh, gradient compression) of the two gloo ranks' runs
S8B_MESHES = (((1, 2), "none"), ((2, 1), "none"), ((2, 1, 1), "int8_ef"))
S8B_RTOL = 2e-3                       # sharded losses vs the one-rank run
S8B_EF_FIRST_RTOL = 1e-4              # int8-EF: the first loss, then
S8B_EF_RTOL = 5e-3                    # the later ones (read: 1.93e-3)
S8B_NCCL_RTOL = 1e-4                  # mesh (1, 1) on NCCL vs unsharded
# each step's grad norm, and the params after the last step (the norm of
# their difference over the norm of the one-rank run's update), against
# the one-rank run; int8-EF apart (its applied gradient is quantized).
# Sound readings on the card: norms 5.6e-3 (1, 2), 1.7e-4 (2, 1), 1.3e-2
# int8-EF; params 0.053, 0.019, 0.61. With FSDP's reduce-scatter left
# without its sum, (2, 1) read norms 0.39 and params 0.84 while its
# losses stayed within 4.4e-4.
S8B_NORM_RTOL = 2e-2
S8B_PARAM_RTOL = 0.2
S8B_EF_NORM_RTOL = 3e-2
S8B_EF_PARAM_RTOL = 0.8
S8B_LEAF = (24, 896, 4864)            # qwen2-0.5b's stacked w_gate
S8B_TIMEOUT = 300                     # seconds, each gloo run of two ranks


def s8b_names(dims):
    return ("data", "model") if len(dims) == 2 else ("pod", "data", "model")


def s8b_flags(compression="none", seed=0, args=None):
    """``args`` (S8B_ARGS by default) as the CLI parses them."""
    from repro_torch.launch import train as cli

    return cli._parse((args or S8B_ARGS) + ["--grad-compression",
                                            compression, "--seed",
                                            str(seed)])


def s8b_layer_collectives(cfg, m):
    """(all-reduces, all-gathers) of one layer of a train step at model
    m > 1 (remat on), derived from the code (``models/layers.py``,
    ``ssm.py``, ``hybrid.py``). Forward, a row-parallel product's
    all-reduce; backward, one all-reduce a copy into the TP region; the
    remat recompute re-issues the forward's collectives up to the last
    saved tensor (not the MLP's: it feeds none). Attention: wo, the copy,
    wo again; where the heads do not split evenly, the projections'
    all-gather (forward, again in the recompute) and the cut before wo's
    (backward). MLP: w_down, the copy. RWKV6 on whole heads a rank: w_o,
    the channel mix's w_v and its receptance's all-gather (each again
    in the recompute); backward the copies of the time mix's x, its mus
    and the decay LoRA's hidden, the channel mix's x and mus, and the
    cut of the replicated leaves (an all-gather); where a head is cut,
    the projections' all-gather (and again) and the cut before w_o
    instead of the hidden's copy and the leaves' cut. Hymba's SSM on
    whole heads: w_out (and again), w_bc's all-gather (and again) and
    its reduce-scatter (an all-reduce; a whole w_bc: its output's copy),
    the copy of x, the cut of a_log / d_skip; where a head is cut, the
    projections' all-gather (and again) and the cut before w_out instead
    of w_bc's sum and the leaves' cut."""
    def attention():
        return 3, 3 if cfg.num_heads % m or cfg.num_kv_heads % m else 0

    if cfg.family == "ssm":
        return (9, 3) if (cfg.d_model // cfg.ssm.head_dim) % m == 0 \
            else (8, 5)
    ar, ag = attention()
    if cfg.family == "hybrid":
        hm = cfg.ssm.expand * cfg.d_model // 64     # hybrid.SSM_HEAD
        bc_cut = (2 * cfg.ssm.state_size) % m == 0
        sr, sg = (4, 1 + 2 * bc_cut) if hm % m == 0 else (3, 3)
        return ar + 2 + sr, ag + sg
    return ar + 2, ag


def s8b_dtype_groups(cfg, dims, compression):
    """The dtypes of the leaves some FSDP axis cuts, and of the others
    (each group one FSDP gather / one batch sum), under the rules the
    train step keeps on ``dims``."""
    from repro_torch.config import MeshConfig
    from repro_torch.distributed import make_rules
    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_leaves
    from repro_torch.distributed.sharding import fsdp_dim as _fsdp_dim

    plain = compression == "none"
    rules = make_rules(MeshConfig(dims, s8b_names(dims)),
                       fsdp_over_pod=plain, act_over_pod=plain)
    meta = get_model(cfg).init_params(device="meta")
    pairs = list(zip(tree_leaves(meta),
                     tree_leaves(rules.param_spec_tree(meta))))
    return ({t.dtype for t, sp in pairs if _fsdp_dim(sp, "model") is not None},
            {t.dtype for t, sp in pairs if _fsdp_dim(sp, "model") is None})


def s8b_collectives(cfg, dims, compression, seq):
    """The collectives of one sharded train step, by kind, derived from
    the code (``training/train_state.py``, ``models/layers.py``; the
    "torch" plan, remat on). f: the FSDP group (pod and data; data only
    under int8-EF), m: model. With f > 1: an FSDP all-gather and its
    reduce-scatter (an all-reduce) a dtype of the FSDP-cut leaves, the
    loss's batch mean and one batch sum a dtype of the other leaves.
    With m > 1: the embedding's all-reduce, each layer's
    (``s8b_layer_collectives``), each of the nc loss chunks two forward
    (max; exponent sum with the label's logit), two again recomputed,
    one backward (the head's copy). Over more than one rank the global
    norm; int8-EF across pods: the codes' and the scales' all-gathers
    and the loss's pod mean, and the leaves' maxima inside a pod of more
    than one rank."""
    sizes = dict(zip(s8b_names(dims), dims))
    m = sizes["model"]
    ef = compression == "int8_ef" and sizes.get("pod", 1) > 1
    f = sizes["data"] * (1 if ef else sizes.get("pod", 1))
    nl, nc = cfg.num_layers, min(8, seq)
    ar = ag = 0
    if f > 1:
        cut, rest = s8b_dtype_groups(cfg, dims, compression)
        ag += len(cut)
        ar += len(cut) + 1 + len(rest)
    if m > 1:
        lar, lag = s8b_layer_collectives(cfg, m)
        ar += 1 + lar * nl + 5 * nc
        ag += lag * nl
    world = 1
    for d in dims:
        world *= d
    if world > 1:
        ar += 1
    if ef:
        ag += 2
        ar += 1
        if world // sizes["pod"] > 1:
            ar += 1
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


def s8b_train(torch, cfg, seed, mesh=None, compression="none",
              on_step=None, args=None):
    """``flags.steps`` steps of ``cfg`` (params from ``seed``, the batches
    ``SyntheticTokens`` 0.. from ``seed``: the CLI's on ``args``,
    S8B_ARGS by default: qwen2-0.5b) on the "torch"
    plan, set up as the CLI sets it up (``train_state.mesh_setup``,
    ``initial_state``): unsharded, or this rank's shards on ``mesh``.
    ``on_step(i, run)`` runs step i (``run()`` does it). Returns each
    step's loss and grad norm and the final params (global, on the
    card; gathered under a mesh)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.distributed import gather_tree
    from repro_torch.models.api import get_model
    from repro_torch.training.data import SyntheticTokens, device_batch
    from repro_torch.training.train_state import (initial_state, local_batch,
                                                  make_train_step, mesh_setup)

    from repro_torch.launch.train import run_config

    api = get_model(cfg)
    flags = s8b_flags(compression, seed, args)
    run = run_config(flags)
    ctx, rules, specs = mesh_setup(api, mesh, compression)
    step = make_train_step(api, ctx, run, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = initial_state(api.init_params(gen, device="cuda"), run, mesh,
                          specs)
    torch.cuda.empty_cache()
    source = SyntheticTokens(cfg, ShapeConfig("s8b", flags.seq, flags.batch,
                                              "train"), seed=seed)
    losses, norms = [], []
    for i in range(flags.steps):
        batch = device_batch(source.batch_at(i), "cuda")
        if mesh is not None:
            batch = local_batch(batch, rules, mesh)
        box = {}

        def run_step():
            box["state"], box["metrics"] = step(state, batch)

        (on_step or (lambda _, f: f()))(i, run_step)
        state = box["state"]
        losses.append(float(box["metrics"]["loss"]))
        norms.append(float(box["metrics"]["grad_norm"]))
    params = (state.params if mesh is None
              else gather_tree(state.params, specs.params, mesh))
    del state
    return dict(losses=losses, norms=norms, params=params)


def s8b_param_err(torch, got, want):
    """(the L2 norm of got - want, over every leaf, in f32)."""
    from repro_torch.models.stack import tree_leaves

    sq = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        sq += float(torch.sum(torch.square(g.float() - w.to(g.device)
                                           .float())))
    return sq ** 0.5


def slice8b1_rank(rank, world, out_dir, seed):
    """One rank of the gloo run (a process of its own on cuda:0): the
    S8B_MESHES runs in turn over one world of two ranks; writes
    ``rank<r>.pt``: each run's losses and grad norms, the distance of
    its final params from the one-rank run's (``ref_params.pt``, rank 0),
    the collectives of its first step (CostCounter), the wall of its
    second, the device busy of its third (profiled) and the peak
    memory."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=S8B_TIMEOUT // 2))
    res = {}
    try:
        cfg = configs.get(ARCH)
        ref = (torch.load(out_dir / "ref_params.pt", weights_only=True)
               if rank == 0 else None)
        for dims, compression in S8B_MESHES:
            mesh = make_mesh_from_config(MeshConfig(dims, s8b_names(dims)),
                                         device="cuda", backend="gloo")
            tag = "x".join(map(str, dims))
            rec = {}

            def on_step(i, run_step):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0:
                    with CostCounter() as cc:
                        run_step()
                    rec["collectives"] = dict(cc.collectives.counts)
                elif i == 1:
                    run_step()
                else:
                    rec["busy"] = tick_busy_ms(
                        torch, run_step, lines.append,
                        tag=f"slice8b1_{tag}_rank{rank}")
                torch.cuda.synchronize()
                rec.setdefault("walls", []).append(
                    1e3 * (time.perf_counter() - t0))

            if not res:
                res["tensor_forms"] = s8b_tensor_forms(torch, mesh)
            torch.cuda.reset_peak_memory_stats()
            out = s8b_train(torch, cfg, seed, mesh, compression, on_step)
            rec["peak"] = torch.cuda.max_memory_allocated()
            rec.update(losses=out["losses"], norms=out["norms"])
            if ref is not None:
                rec["param_err"] = s8b_param_err(torch, out["params"], ref)
            del out
            res[tag] = rec
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    res["log"] = lines
    torch.save(res, out_dir / f"rank{rank}.pt")


def s8b_tensor_forms(torch, mesh):
    """Whether gloo takes the tensor forms of all-gather and
    reduce-scatter on CUDA tensors (distributed/collectives.py gathers
    with all_gather_into_tensor on a host copy under gloo, and composes
    the reduce-scatter from an all_reduce). A probe
    for the record, not a check: the error text, or "ok"."""
    import torch.distributed as dist

    group = mesh.group(mesh.axis_names)
    n = mesh.axes_size(mesh.axis_names)
    x = torch.ones(8, device="cuda")
    out = {}
    for name, call in (
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(8 * n, device="cuda"), x, group=group)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // n, device="cuda"), x, group=group))):
        try:
            call()
            out[name] = "ok"
        except (RuntimeError, NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def s8b_spawn(seed, out_dir, world=2):
    """The gloo ranks as subprocesses (``launch.mesh.run_ranks``, as the
    CLI starts its ranks), within S8B_TIMEOUT; a rank that fails or
    passes it kills the others and fails the phase."""
    import os

    from repro_torch.launch.mesh import run_ranks

    env = dict(os.environ, PYTHONPATH=str(SRC))
    logs = [open(out_dir / f"rank{r}.out", "w") for r in range(world)]
    try:
        codes = run_ranks(
            [[sys.executable, "-c", f"import chip_smoke; chip_smoke."
              f"slice8b1_rank({r}, {world}, {str(out_dir)!r}, {seed})"]
             for r in range(world)], env=env, cwd=str(ROOT),
            timeout=S8B_TIMEOUT, outputs=logs)
    finally:
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        out = (out_dir / f"rank{r}.out").read_text()
        check(code == 0, f"slice 8b-1: gloo rank {r} exited {code}: "
              f"{out[-3000:]}")


def s8b_cli(seed, out_dir):
    """The CLI's own mesh path: ``python -m repro_torch.launch.train``
    with S8B_ARGS, ``--devices 2 --backend gloo`` (two ranks sharing the
    card) at ``--mesh 1x2``, sent SIGTERM once rank 0 has logged its
    first step (the CLI passes it to its ranks, they agree to stop and
    checkpoint), then the same command at ``--mesh 2x1``, which restores
    the checkpoint's shards at its mesh and trains to the end. Returns
    (exit codes, the committed step, each run's last line, {step: loss}
    over both runs, seconds)."""
    import os
    import select
    import signal

    from repro_torch.training.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    ckpt = out_dir / "cli_ckpt"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *S8B_ARGS,
           "--seed", str(seed), "--device", "cuda", "--backend", "gloo",
           "--devices", "2", "--checkpoint-dir", str(ckpt),
           "--checkpoint-every", "100", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    outs, codes = [], []
    with open(out_dir / "cli.err", "w") as err:
        proc = subprocess.Popen(cmd + ["--mesh", "1x2"], env=env,
                                stdout=subprocess.PIPE, stderr=err,
                                text=True, cwd=str(ROOT))
        try:
            first, deadline = [], time.monotonic() + S8B_TIMEOUT
            while time.monotonic() < deadline:
                ready, _, _ = select.select([proc.stdout], [], [], 5)
                line = proc.stdout.readline() if ready else ""
                if ready and not line:
                    break                          # the CLI has exited
                first.append(line)
                if line.startswith("step"):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=S8B_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        outs.append("".join(first) + rest)
        codes.append(proc.returncode)
        latest = CheckpointManager(str(ckpt)).latest_step()
        again = subprocess.run(cmd + ["--mesh", "2x1"], env=env,
                               stdout=subprocess.PIPE, stderr=err, text=True,
                               timeout=S8B_TIMEOUT, cwd=str(ROOT))
        outs.append(again.stdout)
        codes.append(again.returncode)
    losses = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("step "):
                losses[int(line.split()[1])] = float(line.split()[3])
    last = [(out.strip().splitlines() or [""])[-1] for out in outs]
    if codes != [0, 0]:
        last.append((out_dir / "cli.err").read_text()[-3000:])
    return codes, latest, last, losses, time.perf_counter() - t0


def s8b_rel(got, want):
    return [abs(a - w) / abs(w) for a, w in zip(got, want)]


def slice8b1_phase(torch, seed, log):
    """Slice 8b-1 on the card, the sharded trainer (the "torch" plan: no
    kernel of the table runs), set up as the CLI sets it up. (1) One
    full-width gradient leaf (S8B_LEAF, bf16, with an f32 residual)
    through ef_quantize_leaf on the card and on the CPU: codes, scale and
    residual bitwise. (2) An NCCL world of one rank in this process:
    qwen2-0.5b at its published widths and depth, S8B_STEPS steps of
    S8B_ARGS through the sharded step at mesh (1, 1) against the
    unsharded step, losses within S8B_NCCL_RTOL. (3) Two gloo ranks on
    cuda:0 (subprocesses; NCCL refuses two ranks on one card) run
    S8B_MESHES: losses within S8B_RTOL of the unsharded run (int8-EF:
    the first within S8B_EF_FIRST_RTOL, the later within S8B_EF_RTOL),
    each step's grad norm within S8B_NORM_RTOL and the final params
    within S8B_PARAM_RTOL of the unsharded update (int8-EF: the _EF_
    bounds), the ranks' losses alike, the collectives of a step equal to
    s8b_collectives; each rank's wall a step, busy and peak memory. The
    walls carry gloo's host copies and two ranks share one card: not
    multi-card numbers. (4) The CLI itself (``s8b_cli``): preempted at
    (1, 2), resumed at (2, 1), every step's loss within S8B_RTOL of the
    unsharded run. Every reading is logged before any check."""
    import datetime
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.config import MeshConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_map

    cfg = configs.get(ARCH)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    checks = []

    # (1) one gradient leaf, on the card and on the CPU
    gen = torch.Generator().manual_seed(seed)
    g = (torch.randn(S8B_LEAF, generator=gen) * 1e-3).to(torch.bfloat16)
    err = torch.randn(S8B_LEAF, generator=gen) * 1e-6
    want = C.ef_quantize_leaf(g, err)
    t0 = time.perf_counter()
    got = [t.cpu() for t in C.ef_quantize_leaf(g.cuda(), err.cuda())]
    secs = time.perf_counter() - t0
    same = [torch.equal(got[0], want[0]),
            got[1].numpy().tobytes() == want[1].numpy().tobytes(),
            torch.equal(got[2], want[2])]
    log(f"slice 8b-1 leaf {S8B_LEAF} bf16: codes / scale / residual on the "
        f"card bitwise the CPU's: {same} (scale {float(want[1]):.6e}, "
        f"{secs:.3f}s with the copies)")
    checks.append((all(same), "slice 8b-1: the int8-EF leaf differs on the "
                   "card"))
    del g, err, want, got

    # (2) NCCL at world size 1, in this process, against unsharded; the
    # one-rank run's update (final params - initial) is the scale of the
    # params' distances
    one = s8b_train(torch, cfg, seed)
    p0 = get_model(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    update = s8b_param_err(torch, one["params"], p0)
    del p0
    ref_params = tree_map(lambda t: t.cpu(), one.pop("params"))
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh_from_config(MeshConfig((1, 1), ("data", "model")))
        # the collectives the trainer composes, on NCCL (the step skips a
        # group of one rank): int8 codes gathered, bf16 summed
        q = torch.arange(-127, 128, dtype=torch.int8, device="cuda")
        got_q = C.all_gather_flat([q], mesh, "model")[0][0]
        x = torch.randn(1024, device="cuda").to(torch.bfloat16)
        got_x = x.clone()
        dist.all_reduce(got_x, group=mesh.group("model"))
        checks.append((mesh.backend == "nccl" and torch.equal(got_q, q)
                       and torch.equal(got_x, x), "slice 8b-1: the cuda "
                       "mesh is not NCCL, or NCCL's int8 all_gather or bf16 "
                       "all_reduce changed its input"))
        nccl = s8b_train(torch, cfg, seed, mesh)
    finally:
        dist.destroy_process_group()
    nccl_perr = s8b_param_err(torch, nccl.pop("params"), ref_params) / update
    torch.cuda.empty_cache()
    rel = max(s8b_rel(nccl["losses"], one["losses"]))
    nrel = max(s8b_rel(nccl["norms"], one["norms"]))
    log(f"slice 8b-1 NCCL world size 1, mesh (1, 1): losses "
        f"{nccl['losses']} vs unsharded {one['losses']}, max rel {rel:.2e} "
        f"(tol {S8B_NCCL_RTOL}); grad norms {nccl['norms']} vs "
        f"{one['norms']}, max rel {nrel:.2e}; params {nccl_perr:.3e} of the "
        f"update ({update:.4f})")
    checks.append((rel <= S8B_NCCL_RTOL and nrel <= S8B_NORM_RTOL
                   and nccl_perr <= S8B_PARAM_RTOL,
                   f"slice 8b-1 NCCL: losses differ by {rel}, grad norms by "
                   f"{nrel}, params by {nccl_perr}"))

    # (3) two gloo ranks on cuda:0, then (4) the CLI
    out_dir = Path(tempfile.mkdtemp(prefix="slice8b1_"))
    try:
        torch.save(ref_params, out_dir / "ref_params.pt")
        del ref_params
        t0 = time.perf_counter()
        s8b_spawn(seed, out_dir)
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"slice 8b-1 gloo run: 2 ranks on cuda:0, {len(S8B_MESHES)} "
            f"meshes x {S8B_STEPS} steps, {time.perf_counter() - t0:.1f}s "
            "with the ranks' start")
        cli = s8b_cli(seed, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        for line in res["log"]:
            log(f"slice 8b-1 rank {r}: {line}")
    log(f"slice 8b-1 gloo on CUDA tensors, the tensor forms (the port "
        f"gathers into a tensor): "
        f"{ranks[0]['tensor_forms']}")
    seq, b = s8b_flags().seq, s8b_flags().batch
    for dims, compression in S8B_MESHES:
        tag = "x".join(map(str, dims))
        r0, r1 = ranks[0][tag], ranks[1][tag]
        rels = s8b_rel(r0["losses"], one["losses"])
        nrels = s8b_rel(r0["norms"], one["norms"])
        perr = r0["param_err"] / update
        if compression == "none":
            ok = (max(rels) <= S8B_RTOL and max(nrels) <= S8B_NORM_RTOL
                  and perr <= S8B_PARAM_RTOL)
        else:
            ok = (rels[0] <= S8B_EF_FIRST_RTOL and max(rels) <= S8B_EF_RTOL
                  and max(nrels) <= S8B_EF_NORM_RTOL
                  and perr <= S8B_EF_PARAM_RTOL)
        want = s8b_collectives(cfg, dims, compression, seq)
        busy = ["not measured" if r["busy"] is None else
                f"{r['busy']:.2f} ms" for r in (r0, r1)]
        log(f"slice 8b-1 gloo ({tag}, {compression}; {smi}): losses "
            f"{r0['losses']} vs one rank {one['losses']}, rel "
            f"{', '.join(f'{x:.2e}' for x in rels)}; grad norms "
            f"{r0['norms']} vs {one['norms']}, rel "
            f"{', '.join(f'{x:.2e}' for x in nrels)}; params {perr:.3e} of "
            f"the one-rank update; collectives a step "
            f"{r0['collectives']} / {r1['collectives']} (derived {want}); "
            f"per rank wall a step {r0['walls'][1]:.1f} / "
            f"{r1['walls'][1]:.1f} ms (second step; first "
            f"{r0['walls'][0]:.1f} / {r1['walls'][0]:.1f} with the "
            f"counter), busy {busy[0]} / {busy[1]} (third, profiled), "
            f"peak {r0['peak'] / 2**30:.2f} / {r1['peak'] / 2**30:.2f} GiB; "
            f"{b * seq} tokens a step over both ranks; the walls carry "
            "gloo's host copies and both ranks share one card: not a "
            "multi-card number")
        checks.append((ok, f"slice 8b-1 gloo {tag}: losses {r0['losses']}, "
                       f"norms {r0['norms']}, params {perr} against the "
                       f"one-rank {one['losses']}, {one['norms']}"))
        checks.append((r0["losses"] == r1["losses"], f"slice 8b-1 gloo "
                       f"{tag}: the ranks' losses differ"))
        for r, res in enumerate((r0, r1)):
            checks.append((res["collectives"] == want, f"slice 8b-1 gloo "
                           f"{tag}: rank {r} issued {res['collectives']} "
                           f"collectives in a step, not {want}"))
    codes, latest, last, losses, secs = cli
    crel = {n: abs(x - one["losses"][n - 1]) / abs(one["losses"][n - 1])
            for n, x in losses.items() if 1 <= n <= S8B_STEPS}
    log(f"slice 8b-1 CLI ({' '.join(S8B_ARGS)} --devices 2 --backend gloo): "
        f"--mesh 1x2 sent SIGTERM after its first step, exit {codes[0]}, "
        f"committed step {latest}; rerun at --mesh 2x1 exit {codes[1]}; "
        f"last lines {last}; losses by step {losses}, rel to one rank "
        f"{ {n: f'{x:.2e}' for n, x in crel.items()} }; {secs:.1f}s")
    checks.append((
        codes == [0, 0] and latest is not None and "preempted=True" in last[0]
        and last[1].startswith(f"finished at step {S8B_STEPS} (restored_from"
                               f"={latest}, preempted=False)")
        and sorted(losses) == list(range(1, S8B_STEPS + 1))
        and max(crel.values(), default=1.0) <= S8B_RTOL,
        f"slice 8b-1 CLI: exits {codes}, committed {latest}, {last}, "
        f"losses {losses} against the one-rank {one['losses']}"))
    gc.collect()
    torch.cuda.empty_cache()
    for ok, msg in checks:
        check(ok, msg)


# slice 8b-2: the GPipe pipeline over pod, MoE on a data mesh and under TP,
# whisper-tiny under TP and with the int8-EF pod hop (two gloo ranks on
# the card, the "torch" plan)
S8B2_PIPE = (4, 2, 512)               # AM: M microbatches of mb x seq tokens
S8B2_STAGES = 2                       # qwen2-0.5b's 24 layers, 12 a stage
S8B2_MOE_LAYERS = 1                   # dbrx-132b at its published widths
S8B2_MOE_BATCH = (4, 64)              # (batch, seq): the JAX test's
# (cell, (data, model), moe_groups): AN the manual path (each rank routes
# its own group), AN′ the fallback (one group over both ranks' rows), AO
# the experts' F over model
S8B2_MOE_RUNS = (("AN", (2, 1), 2), ("AN′", (2, 1), 1), ("AO", (1, 2), 1))
S8B2_WHISPER_ARGS = ["--arch", "whisper-tiny", "--steps", str(S8B_STEPS),
                     "--batch", "8", "--seq", "512", "--lr", "1e-3"]
S8B2_WHISPER_RUNS = (("AP", (1, 2), "none"), ("AQ", (2, 1, 1), "int8_ef"))
# AN-AO: the loss (the JAX package's bound for its manual dispatch), each
# leaf's gradient: the norm's relative error and the projection onto a
# seeded rank-1 direction, its error over the norm times the direction's
# norm, against the one-rank run
# at the same moe_groups; AN's aux is the mean of the ranks' own (the JAX
# package's pmean), not the one-rank aux
S8B2_MOE_LOSS_RTOL = 2e-3
S8B2_MOE_GRAD_RTOL = 5e-2
S8B2_TIMEOUT = 420                    # seconds, the gloo run of two ranks
PDM = ("pod", "data", "model")


def s8b2_dbrx():
    """dbrx-132b at its published widths, 40 -> S8B2_MOE_LAYERS layers."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get(MOE_ARCH),
                               num_layers=S8B2_MOE_LAYERS)


def s8b2_batch(cfg, seed, b, s, step=0):
    from repro_torch.config import ShapeConfig
    from repro_torch.training.data import SyntheticTokens, device_batch

    return device_batch(SyntheticTokens(cfg, ShapeConfig("s8b2", s, b,
                                                         "train"),
                                        seed=seed).batch_at(step), "cuda")


def s8b2_summary(torch, tree, tag, mesh=None, specs=None):
    """Per leaf (its path): the sum of squares and the projection onto a
    rank-1 direction (one seeded normal vector a dim, from the path and
    ``tag``) of the global tensor, this rank's part of them under
    ``specs`` on ``mesh``: a rank counts a leaf's shard when its
    coordinate is 0 on every axis the spec does not name (so the ranks'
    parts add up to the global values). Also each direction's norm."""
    from repro_torch.distributed import P, local_shard
    from repro_torch.models.stack import tree_leaves

    out = {}
    for path, g in zip(checkpoint_paths(tree), tree_leaves(tree)):
        spec = (tuple(_at_path(specs, path)) if specs is not None
                else (None,) * g.dim())
        named = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        mine = mesh is None or all(mesh.coord(a) == 0 for a in
                                   mesh.axis_names if a not in named)
        gen = torch.Generator().manual_seed(int(hashlib.sha256(
            f"{path}/{tag}".encode()).hexdigest()[:8], 16))
        shape = [g.shape[d] * (1 if spec[d] is None or mesh is None
                               else mesh.axes_size(spec[d]))
                 for d in range(g.dim())]
        whole = [torch.randn(n, generator=gen) for n in shape]
        vnorm = 1.0
        for v in whole:
            vnorm *= float(v.norm())
        vecs = [(v if mesh is None or spec[d] is None
                 else local_shard(v, P(spec[d]), mesh)).to(g.device)
                for d, v in enumerate(whole)]
        sq = proj = 0.0
        if mine:
            # rows of the leaf as (every index but the last, the last):
            # the leading directions' outer product weights each row
            lead = torch.ones(1, device=g.device)
            for v in vecs[:-1]:
                lead = (lead[:, None] * v[None, :]).reshape(-1)
            rows = g.reshape(-1, g.shape[-1])
            step = max(1, (1 << 26) // rows.shape[1])
            for i in range(0, rows.shape[0], step):
                x = rows[i:i + step].float()
                sq += float(torch.sum(x * x))
                proj += float(torch.dot(x @ vecs[-1], lead[i:i + step]))
        out[path] = (sq, proj, vnorm)
    return out


def _at_path(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def s8b2_add(parts):
    """The ranks' summaries added leaf by leaf."""
    out = {}
    for part in parts:
        for k, (sq, proj, vn) in part.items():
            a = out.get(k, (0.0, 0.0, vn))
            out[k] = (a[0] + sq, a[1] + proj, vn)
    return out


def s8b2_grad_errs(got, want):
    """Per leaf: (the norm's relative error, the projection's error over
    the reference norm times the direction's norm); and the worst of
    each."""
    errs = {}
    for k, (sq, proj, vn) in want.items():
        g = got[k]
        n_ref = sq ** 0.5
        scale = max(n_ref, 1e-30)
        errs[k] = (abs(g[0] ** 0.5 - n_ref) / scale,
                   abs(g[1] - proj) / (scale * vn))
    worst = (max(e[0] for e in errs.values()),
             max(e[1] for e in errs.values()))
    return errs, worst


def s8b2_pipe_setup(torch, seed):
    """qwen2-0.5b at its published widths and depth from ``seed``, its
    "torch"-plan context, and AM's batch as (M, mb, S) tokens and
    labels."""
    from repro_torch import configs
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import LayerCtx

    cfg = configs.get(ARCH)
    m, mb, s = S8B2_PIPE
    params = get_model(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    batch = s8b2_batch(cfg, seed, m * mb, s)
    ctx = LayerCtx(cfg, DEFAULT_PLAN.with_overrides(backend="torch"))
    return cfg, ctx, params, {k: v.reshape(m, mb, s)
                              for k, v in batch.items()}


def s8b2_lm_loss(ctx, params, outs, labels):
    """The LM loss on (M, mb, S, D) stack outputs: the final norm, then
    the chunked cross-entropy, averaged over the microbatches."""
    from repro_torch.models import layers as L

    losses = [L.cross_entropy_loss(ctx, params, L.norm(
        ctx.cfg, params["final_norm"], outs[i]), labels[i])
        for i in range(outs.shape[0])]
    return sum(losses) / len(losses)


def s8b2_stage_fn(torch, ctx, mb, s):
    from repro_torch.models import stack
    from repro_torch.models import transformer as T

    positions = torch.arange(s, device="cuda")[None].expand(mb, s)
    return lambda sp, x: stack.run_stack(sp, x, lambda p_i, xx: T.block(
        ctx, p_i, xx, positions)[0])


def s8b2_digests(torch, tree):
    """Per leaf (its path): the sha256 of its bytes."""
    from repro_torch.models.stack import tree_leaves

    return {path: hashlib.sha256(t.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy()).hexdigest()
        for path, t in zip(checkpoint_paths(tree), tree_leaves(tree))}


def s8b2_pipe_reference(torch, seed):
    """AM's reference: the unpipelined stack applied microbatch by
    microbatch; (outputs on the host, the loss, each stage's layer
    gradients' and the other leaves' digests)."""
    from repro_torch.models import layers as L
    from repro_torch.models.stack import tree_map

    cfg, ctx, params, batch = s8b2_pipe_setup(torch, seed)
    m, mb, s = S8B2_PIPE
    params = tree_map(lambda t: t.requires_grad_(True), params)
    x = L.embed(ctx, params, batch["tokens"].reshape(m * mb, s)).reshape(
        m, mb, s, -1)
    stage = s8b2_stage_fn(torch, ctx, mb, s)
    outs = torch.stack([stage(params["layers"], x[i]) for i in range(m)])
    loss = s8b2_lm_loss(ctx, params, outs, batch["labels"])
    loss.backward()
    n = cfg.num_layers // S8B2_STAGES
    grads = tree_map(lambda t: t.grad, params)
    digests = {f"stage{r}": s8b2_digests(torch, tree_map(
        lambda g: g[r * n:(r + 1) * n], grads["layers"]))
        for r in range(S8B2_STAGES)}
    digests["other"] = s8b2_digests(torch, {k: v for k, v in grads.items()
                                            if k != "layers"})
    out = outs.detach().cpu()
    del params, grads, outs, x
    return out, float(loss.detach()), digests


def s8b2_pipe_rank(torch, seed, mesh, rec):
    """AM on this rank: its stage of the split stack, the pipeline
    forward of the microbatches' embeddings, the LM loss on the
    pipelined outputs and its backward pass (``s8b2_measured``, timed
    again alone). Fills ``rec``."""
    from repro_torch.distributed import P, shard_tree
    from repro_torch.distributed import pipeline as PP
    from repro_torch.models import layers as L
    from repro_torch.models.stack import tree_map

    cfg, ctx, params, batch = s8b2_pipe_setup(torch, seed)
    m, mb, s = S8B2_PIPE
    staged = PP.split_stages(params.pop("layers"), S8B2_STAGES)
    local = shard_tree(staged, tree_map(lambda _: P("pod"), staged), mesh)
    del staged
    torch.cuda.empty_cache()
    stage = s8b2_stage_fn(torch, ctx, mb, s)
    r = mesh.coord("pod")

    def run():
        sp = tree_map(lambda t: t.detach().requires_grad_(True), local)
        other = tree_map(lambda t: t.detach().requires_grad_(True), params)
        x = L.embed(ctx, other, batch["tokens"].reshape(m * mb, s))
        outs = PP.pipeline_forward(mesh, sp, x.reshape(m, mb, s, -1), stage)
        loss = s8b2_lm_loss(ctx, other, outs, batch["labels"])
        loss.backward()
        return outs.detach(), float(loss.detach()), sp, other

    torch.cuda.reset_peak_memory_stats()
    print(f"AM set up, host {host_peak_gib():.1f} GiB", flush=True)
    outs, loss, sp, other = s8b2_measured(torch, run, rec,
                                          f"slice8b2_AM_rank{r}", again=True)
    rec["out"] = outs.cpu()
    rec["loss"] = loss
    rec["digests"] = {
        f"stage{r}": s8b2_digests(torch, tree_map(lambda t: t.grad[0], sp)),
        "other": s8b2_digests(torch, tree_map(lambda t: t.grad, other))}
    rec["peak"] = torch.cuda.max_memory_allocated()
    rec["host_peak"] = host_peak_gib()


def s8b2_measured(torch, fn, rec, tag, again=False):
    """``fn()`` under the collective counter and the profiler (the first
    call of its shapes in the process), then with ``again`` a second
    time alone: returns the last call's result. ``rec`` gets the
    collectives by kind and the device busy of the first call (its
    kernels: the host copies left out), and the wall in ms of the last,
    with ``profiled`` whether that call ran under both. The dbrx cells
    on a data mesh run once: each call moves 9 GB through the host each
    way."""
    from repro_torch.analysis.cost import CostCounter

    box = {}

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["out"] = fn()
        torch.cuda.synchronize()
        rec["wall"] = 1e3 * (time.perf_counter() - t0)

    with CostCounter() as cc:
        rec["busy"] = tick_busy_ms(torch, timed,
                                   rec.setdefault("log", []).append, tag=tag,
                                   cpu=False, host_copies=False)
    rec["collectives"] = dict(cc.collectives.counts)
    rec["profiled"] = not again
    if again:
        box.clear()
        timed()
    return box["out"]


def host_peak_gib():
    """This process's peak resident host memory so far, in GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def s8b2_moe_grads(torch, seed, groups, mesh=None):
    """One loss of dbrx-132b (S8B2_MOE_LAYERS layers, published widths,
    params from ``seed``) on S8B2_MOE_BATCH and its gradients through
    the train step's ``make_grad_fn`` ("torch" plan, remat), at
    ``moe_groups`` = ``groups``: unsharded, or this rank's shards on
    ``mesh``. Returns (run(), the specs or None) where run() -> (loss,
    grads, the forward's routing choices layer by layer)."""
    import dataclasses

    from repro_torch.config import RunConfig
    from repro_torch.distributed import shard_tree
    from repro_torch.models import moe
    from repro_torch.models.api import get_model
    from repro_torch.training.train_state import (local_batch, make_grad_fn,
                                                  mesh_setup)

    cfg = s8b2_dbrx()
    api = get_model(cfg)
    ctx, rules, specs = mesh_setup(api, mesh)
    ctx = dataclasses.replace(ctx, moe_groups=groups)
    grads_fn = make_grad_fn(api, ctx, RunConfig(learning_rate=1e-3),
                            mesh=mesh)
    params = api.init_params(torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    if mesh is not None:
        params = shard_tree(params, specs.params, mesh)
    torch.cuda.empty_cache()
    b, s = S8B2_MOE_BATCH
    batch = s8b2_batch(cfg, seed, b, s)
    if mesh is not None:
        batch = local_batch(batch, rules, mesh)

    def run():
        routes, route = [], moe.route

        def recording(*a, **kw):
            res = route(*a, **kw)
            routes.append(res[2].cpu())
            return res

        moe.route = recording
        try:
            loss, grads = grads_fn(params, batch)
        finally:
            moe.route = route
        return float(loss), grads, routes[:cfg.num_layers]

    return run, (None if specs is None else specs.params)


def s8b2_moe_collectives(dims, groups, nc):
    """The collectives of one loss and its gradients of the dbrx layer
    (``make_grad_fn``, remat on), by kind, derived from the code: with
    data f > 1 one FSDP all-gather a dtype of the FSDP-cut leaves and
    their reduce-scatter (an all-reduce), the loss's batch mean, one
    batch sum a dtype of the other leaves (bf16 norms, the f32 router);
    where the groups do not divide over f, each layer's activation
    gather (forward, again in the remat recompute) and its
    reduce-scatter. With model m > 1: the embedding's all-reduce; a
    layer's wo and combine all-reduces forward, the attention's, the
    slots' and the routing weights' copies backward, wo's again in the
    recompute (which stops at the aux, the last tensor saved, before the
    combine's all-reduce); each loss chunk two forward, two recomputed,
    one backward (the head's copy)."""
    cfg = s8b2_dbrx()
    cut, rest = s8b_dtype_groups(cfg, dims, "none")
    f, m = dims
    nl = cfg.num_layers
    ar = ag = 0
    if f > 1:
        ag += len(cut)
        ar += len(cut) + 1 + len(rest)
        if groups % f:
            ag += 2 * nl
            ar += nl
    if m > 1:
        ar += 1 + 6 * nl + 5 * nc
    return {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}


def s8b2_whisper_collectives(cfg, dims, compression, seq):
    """A whisper-tiny train step's collectives: at (1, 2) the embedding's
    all-reduce, each encoder layer's four (wo, w_down forward, two
    copies backward; no remat), each decoder layer's nine (the dense
    block's five, cross-attention's wo forward and again in the
    recompute, the copies of its queries' and of the encoder output's
    inputs backward), each of the nc loss chunks five, the global norm;
    the int8-EF pod hop as ``s8b_collectives`` counts it."""
    if dims == (1, 2):
        nc = min(8, seq)
        return {"all-reduce": 1 + 4 * cfg.encoder_layers
                + 9 * cfg.num_layers + 5 * nc + 1}
    return s8b_collectives(cfg, dims, compression, seq)


def slice8b2_rank(rank, world, out_dir, seed):
    """One rank of the slice 8b-2 gloo run (a process of its own on
    cuda:0): AM, then AN, AN′, AO, then AP and AQ, each on a mesh of its
    own over one world of two ranks; writes ``rank<r>.pt``."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=S8B2_TIMEOUT // 2))

    def mesh_of(dims):
        names = s8b_names(dims)
        return make_mesh_from_config(MeshConfig(dims, names), device="cuda",
                                     backend="gloo")

    res = {}
    try:
        t0 = time.perf_counter()
        rec = res["AM"] = {}
        s8b2_pipe_rank(torch, seed, mesh_of((S8B2_STAGES, 1, 1)), rec)
        rec["secs"] = time.perf_counter() - t0
        print(f"AM {rec['secs']:.1f}s host {rec['host_peak']:.1f} GiB",
              flush=True)
        torch.cuda.empty_cache()
        for cell, dims, groups in S8B2_MOE_RUNS:
            t0 = time.perf_counter()
            rec = res[cell] = {}
            mesh = mesh_of(dims)
            torch.cuda.reset_peak_memory_stats()
            run, specs = s8b2_moe_grads(torch, seed, groups, mesh)
            print(f"{cell} set up, host {host_peak_gib():.1f} GiB",
                  flush=True)
            # without the data mesh's 9 GB gather (AO) the cell runs
            # again, timed alone
            loss, grads, routes = s8b2_measured(
                torch, run, rec, f"slice8b2_{cell}_rank{rank}",
                again=dims[0] == 1)
            rec.update(loss=loss, routes=routes,
                       summary=s8b2_summary(torch, grads, "moe", mesh,
                                            specs))
            del grads
            rec["peak"] = torch.cuda.max_memory_allocated()
            rec["host_peak"] = host_peak_gib()
            del run
            torch.cuda.empty_cache()
            rec["secs"] = time.perf_counter() - t0
            print(f"{cell} {rec['secs']:.1f}s host {rec['host_peak']:.1f} "
                  "GiB", flush=True)
        wcfg = configs.get("whisper-tiny")
        ref = (torch.load(out_dir / "whisper_ref.pt", weights_only=True)
               if rank == 0 else None)
        for cell, dims, compression in S8B2_WHISPER_RUNS:
            t0 = time.perf_counter()
            rec = res[cell] = {}
            mesh = mesh_of(dims)

            def on_step(i, run_step):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if i == 0:
                    with CostCounter() as cc:
                        run_step()
                    rec["collectives"] = dict(cc.collectives.counts)
                elif i == 1:
                    run_step()
                else:
                    rec["busy"] = tick_busy_ms(
                        torch, run_step, rec.setdefault("log", []).append,
                        tag=f"slice8b2_{cell}_rank{rank}", host_copies=False)
                torch.cuda.synchronize()
                rec.setdefault("walls", []).append(
                    1e3 * (time.perf_counter() - t1))

            torch.cuda.reset_peak_memory_stats()
            out = s8b_train(torch, wcfg, seed, mesh, compression, on_step,
                            args=S8B2_WHISPER_ARGS)
            rec["peak"] = torch.cuda.max_memory_allocated()
            rec["host_peak"] = host_peak_gib()
            rec.update(losses=out["losses"], norms=out["norms"])
            if ref is not None:
                rec["param_err"] = s8b_param_err(torch, out["params"], ref)
            del out
            torch.cuda.empty_cache()
            rec["secs"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


def s8b2_spawn(seed, out_dir, world=2):
    """The slice 8b-2 gloo ranks as subprocesses, within S8B2_TIMEOUT."""
    import os

    from repro_torch.launch.mesh import run_ranks

    # two ranks' dbrx-132b layers (a whole FSDP gather, its gradients
    # and their all-reduce each) share the card: segments that grow keep
    # freed blocks usable for the next, larger request
    env = dict(os.environ, PYTHONPATH=str(SRC),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    logs = [open(out_dir / f"rank{r}.out", "w") for r in range(world)]
    try:
        codes = run_ranks(
            [[sys.executable, "-c", f"import chip_smoke; chip_smoke."
              f"slice8b2_rank({r}, {world}, {str(out_dir)!r}, {seed})"]
             for r in range(world)], env=env, cwd=str(ROOT),
            timeout=S8B2_TIMEOUT, outputs=logs)
    finally:
        for f in logs:
            f.close()
    check(codes == [0] * world, "slice 8b-2: gloo ranks exited "
          f"{codes}: " + " ".join(
              f"--- rank {r}: {(out_dir / f'rank{r}.out').read_text()[-2000:]}"
              for r in range(world)) + f" (cgroup memory: {cgroup_memory()})")


def cgroup_memory():
    """This machine's cgroup memory peak and current use, in GiB, where
    the files are there to read."""
    out = {}
    for name in ("memory.peak", "memory.current"):
        try:
            out[name] = round(int(Path("/sys/fs/cgroup", name).read_text())
                              / 2**30, 2)
        except (OSError, ValueError):
            pass
    return out


def s8b2_flips(got, want):
    """(routing choices that differ, all of them) over the layers."""
    flips = sum(int((g != w).sum()) for g, w in zip(got, want))
    return flips, sum(w.numel() for w in want)


def slice8b2_phase(torch, seed, log):
    """Slice 8b-2 on the card (the "torch" plan: no kernel of the table
    runs). The references first, on one card in this process: AM's
    unpipelined stack (qwen2-0.5b, 24 layers, S8B2_PIPE), the dbrx layer's
    loss and gradients at moe_groups 2 and 1 (about 18 GB: freed before
    the ranks start), whisper-tiny's S8B_STEPS steps. Then two gloo ranks
    on cuda:0 (subprocesses, spawned once): AM, the pipeline over pod
    (outputs, the loss and every gradient leaf bit for bit the
    reference's, the leaves by sha256); AN / AN′ / AO, the dbrx layer at
    (data, model) = (2, 1) manual and fallback and (1, 2) TP (loss within
    S8B2_MOE_LOSS_RTOL, each leaf's gradient within S8B2_MOE_GRAD_RTOL,
    the routing choices that differ counted); AP / AQ, whisper-tiny's
    steps at (1, 2) and (2, 1, 1) int8-EF (phase 11's bounds). Each run's
    collectives (CostCounter) against the count derived from the code,
    each rank's wall (AM and AO: a second call alone; AN / AN′: their one
    call, profiled and counted), busy (the profiled call's kernels, the
    host copies left out) and peak memory beside the card's name and
    power limit; the walls carry gloo's host copies and both ranks share
    one card: not multi-card numbers. Every reading is logged before any
    check."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_map

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    checks = []
    t0 = time.perf_counter()
    pipe_out, pipe_loss, pipe_digests = s8b2_pipe_reference(torch, seed)
    gc.collect()
    torch.cuda.empty_cache()
    moe_ref = {}
    for groups in sorted({g for _, _, g in S8B2_MOE_RUNS}):
        run, _ = s8b2_moe_grads(torch, seed, groups)
        loss, grads, routes = run()
        moe_ref[groups] = (loss, s8b2_summary(torch, grads, "moe"), routes)
        del run, grads
        gc.collect()
        torch.cuda.empty_cache()
    wcfg = configs.get("whisper-tiny")
    wone = s8b_train(torch, wcfg, seed, args=S8B2_WHISPER_ARGS)
    w0 = get_model(wcfg).init_params(
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    wupdate = s8b_param_err(torch, wone["params"], w0)
    wref = tree_map(lambda t: t.cpu(), wone.pop("params"))
    del w0
    torch.cuda.empty_cache()
    log(f"slice 8b-2 references on one card: {time.perf_counter() - t0:.1f}s"
        f"; cgroup memory {cgroup_memory()}")
    out_dir = Path(tempfile.mkdtemp(prefix="slice8b2_"))
    try:
        torch.save(wref, out_dir / "whisper_ref.pt")
        t0 = time.perf_counter()
        s8b2_spawn(seed, out_dir)
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"slice 8b-2 gloo run: 2 ranks on cuda:0, "
            f"{time.perf_counter() - t0:.1f}s with the ranks' start; "
            "cells (seconds; each rank's peak host memory so far, GiB) "
            + ", ".join(
                f"{c} {ranks[0][c]['secs']:.1f}s "
                f"{ranks[0][c]['host_peak']:.1f} / "
                f"{ranks[1][c]['host_peak']:.1f}" for c in
                ["AM", *[c for c, _, _ in S8B2_MOE_RUNS],
                 *[c for c, _, _ in S8B2_WHISPER_RUNS]])
            + f"; this process {host_peak_gib():.1f}; cgroup memory "
            f"{cgroup_memory()}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        for cell, rec in res.items():
            for line in rec.get("log", []):
                log(f"slice 8b-2 rank {r}: {line}")

    def per_rank(key, fmt):
        return " / ".join(fmt(res[cell][key]) for res in ranks)

    def busy_text(x):
        return "not measured" if x is None else f"{x:.2f}"

    def wall_text(rec):
        return (f"{rec['wall']:.1f} ms ("
                + ("one call, profiled and counted" if rec["profiled"] else
                   "a second call alone") + ")")

    # AM, the pipeline
    cell = "AM"
    m, mb, s = S8B2_PIPE
    same = [torch.equal(res[cell]["out"], pipe_out) for res in ranks]
    differ = [f"rank {r} {part}{path}" for r, res in enumerate(ranks)
              for part, got in res[cell]["digests"].items()
              for path, h in got.items()
              if pipe_digests.get(part, {}).get(path) != h]
    nleaves = sum(len(d) for res in ranks
                  for d in res[cell]["digests"].values())
    want = {"collective-permute": 2 * (m + S8B2_STAGES - 1),
            "collective-broadcast": 2}
    lrel = [abs(res[cell]["loss"] - pipe_loss) / abs(pipe_loss)
            for res in ranks]
    log(f"slice 8b-2 AM ({ARCH}, 24 layers as {S8B2_STAGES} stages over "
        f"pod, M = {m} microbatches of {mb} x {s}; {smi}): outputs bit for "
        f"bit the unpipelined stack's {same}; loss {ranks[0][cell]['loss']!r}"
        f" vs {pipe_loss!r} (rel {max(lrel):.2e}); gradient leaves bit for "
        f"bit the unpipelined stack's: {nleaves - len(differ)} of {nleaves}"
        f" (sha256); collectives {per_rank('collectives', str)} (derived "
        f"{want}); per rank wall "
        + " / ".join(wall_text(res[cell]) for res in ranks)
        + f", busy {per_rank('busy', busy_text)} ms (kernels of the "
        f"profiled call, host copies left out), peak "
        f"{per_rank('peak', lambda x: f'{x / 2**30:.2f}')} GiB; the "
        f"permutes are send / recv of host copies (gloo on CUDA tensors)")
    checks.append((all(same), "slice 8b-2 AM: the pipelined outputs differ "
                   "from the unpipelined stack's"))
    # each rank holds its own stage's leaves and every other leaf
    complete = all(
        set(res[cell]["digests"]) == {f"stage{r}", "other"}
        and all(set(got) == set(pipe_digests[part])
                for part, got in res[cell]["digests"].items())
        for r, res in enumerate(ranks))
    checks.append((max(lrel) == 0.0 and not differ and complete,
                   f"slice 8b-2 AM: loss rel {lrel}, gradient leaves that "
                   f"differ {differ} of {nleaves}, every leaf present "
                   f"{complete}"))
    for r, res in enumerate(ranks):
        checks.append((res[cell]["collectives"] == want,
                       f"slice 8b-2 AM: rank {r} issued "
                       f"{res[cell]['collectives']}, not {want}"))

    # AN, AN′, AO: the dbrx layer
    b, s = S8B2_MOE_BATCH
    for cell, dims, groups in S8B2_MOE_RUNS:
        loss, summ, routes = moe_ref[groups]
        r0, r1 = ranks[0][cell], ranks[1][cell]
        got = s8b2_add([r0["summary"], r1["summary"]])
        _, worst = s8b2_grad_errs(got, summ)
        lrel = abs(r0["loss"] - loss) / abs(loss)
        mine = (r0["routes"] if groups % dims[0] or dims[0] == 1 else
                [torch.cat([a, c]) for a, c in zip(r0["routes"],
                                                   r1["routes"])])
        flips, total = s8b2_flips(mine, routes)
        want = s8b2_moe_collectives(dims, groups, min(8, s))
        path = ("manual" if dims[0] > 1 and groups % dims[0] == 0 else
                "fallback" if dims[0] > 1 else "TP")
        log(f"slice 8b-2 {cell} ({MOE_ARCH}, {S8B2_MOE_LAYERS} layer, "
            f"(data, model) = {dims}, moe_groups {groups}, {path}; "
            f"{b} x {s}; {smi}): loss {r0['loss']!r} / {r1['loss']!r} vs "
            f"one rank {loss!r} (rel {lrel:.2e}, tol {S8B2_MOE_LOSS_RTOL}); "
            f"gradients (norm, projection) worst {worst[0]:.2e}, "
            f"{worst[1]:.2e} (tol {S8B2_MOE_GRAD_RTOL}); routing choices "
            f"that differ from one rank: {flips} of {total}; collectives "
            f"{r0['collectives']} / {r1['collectives']} (derived {want}); "
            f"per rank wall {wall_text(r0)} / {wall_text(r1)}, busy "
            + " / ".join("not measured" if x["busy"] is None else
                         f"{x['busy']:.2f}" for x in (r0, r1))
            + " ms (kernels of the profiled call, host copies left out), "
            f"peak {r0['peak'] / 2**30:.2f} / "
            f"{r1['peak'] / 2**30:.2f} GiB; the walls carry gloo's host "
            "copies and both ranks share one card: not a multi-card number")
        checks.append((r0["loss"] == r1["loss"] and lrel <= S8B2_MOE_LOSS_RTOL
                       and max(worst) <= S8B2_MOE_GRAD_RTOL,
                       f"slice 8b-2 {cell}: losses {r0['loss']}, "
                       f"{r1['loss']} against {loss}, gradients {worst}"))
        for r, res in enumerate((r0, r1)):
            checks.append((res["collectives"] == want, f"slice 8b-2 {cell}: "
                           f"rank {r} issued {res['collectives']}, not "
                           f"{want}"))

    # AP, AQ: whisper-tiny
    flags = s8b_flags(args=S8B2_WHISPER_ARGS)
    for cell, dims, compression in S8B2_WHISPER_RUNS:
        r0, r1 = ranks[0][cell], ranks[1][cell]
        rels = s8b_rel(r0["losses"], wone["losses"])
        nrels = s8b_rel(r0["norms"], wone["norms"])
        perr = r0["param_err"] / wupdate
        if compression == "none":
            ok = (max(rels) <= S8B_RTOL and max(nrels) <= S8B_NORM_RTOL
                  and perr <= S8B_PARAM_RTOL)
        else:
            ok = (rels[0] <= S8B_EF_FIRST_RTOL and max(rels) <= S8B_EF_RTOL
                  and max(nrels) <= S8B_EF_NORM_RTOL
                  and perr <= S8B_EF_PARAM_RTOL)
        want = s8b2_whisper_collectives(wcfg, dims, compression, flags.seq)
        busy = ["not measured" if r["busy"] is None else
                f"{r['busy']:.2f} ms" for r in (r0, r1)]
        log(f"slice 8b-2 {cell} (whisper-tiny, {dims}, {compression}; "
            f"{smi}): losses {r0['losses']} vs one rank {wone['losses']}, "
            f"rel {', '.join(f'{x:.2e}' for x in rels)}; grad norms "
            f"{r0['norms']} vs {wone['norms']}, rel "
            f"{', '.join(f'{x:.2e}' for x in nrels)}; params {perr:.3e} of "
            f"the one-rank update ({wupdate:.4f}); collectives a step "
            f"{r0['collectives']} / {r1['collectives']} (derived {want}); "
            f"per rank wall a step {r0['walls'][1]:.1f} / "
            f"{r1['walls'][1]:.1f} ms (second step), busy {busy[0]} / "
            f"{busy[1]} (third, profiled: kernels, host copies left out), "
            f"peak {r0['peak'] / 2**30:.2f} / "
            f"{r1['peak'] / 2**30:.2f} GiB; {flags.batch} x {flags.seq} "
            "tokens a step over both ranks")
        checks.append((ok and r0["losses"] == r1["losses"],
                       f"slice 8b-2 {cell}: losses {r0['losses']} / "
                       f"{r1['losses']}, norms {r0['norms']}, params {perr} "
                       f"against the one-rank {wone['losses']}, "
                       f"{wone['norms']}"))
        for r, res in enumerate((r0, r1)):
            checks.append((res["collectives"] == want, f"slice 8b-2 {cell}: "
                           f"rank {r} issued {res['collectives']} in a "
                           f"step, not {want}"))
    gc.collect()
    torch.cuda.empty_cache()
    for ok, msg in checks:
        check(ok, msg)


# slice 8b-3a: tensor parallelism and the int8-EF pod hop for the recurrent
# families (two gloo ranks on the card, the "torch" plan), at their
# published widths and FAMILY_LAYERS' depth, phase 11's batch (8 x 512, lr
# 1e-3, remat) and bounds, S8B3_STEPS steps: the phase took 102 s with
# phase 11's 3 (limit 100 s), and at the third step the one-card rwkv6-1.6b
# run diverges (loss 11.6 -> 23.7) and the grad norms of AR, AS and AU
# with it (8.2e-2, 3.8e-2, 0.104 from the one-card run's; PERF.md
# section 6, PR 33)
S8B3_STEPS = 2
# (cell, arch, mesh, gradient compression)
S8B3_RUNS = (("AR", "rwkv6-1.6b", (1, 2), "none"),
             ("AS", "rwkv6-1.6b", (2, 1, 1), "int8_ef"),
             ("AT", "hymba-1.5b", (1, 2), "none"),
             ("AU", "hymba-1.5b", (2, 1, 1), "int8_ef"))
# the replicated leaves each model rank cuts to its own heads (their
# gradients summed over model by the cut's backward), and Hymba's w_bc,
# shared by every head: their first gradients at model 2 against the
# one-card run's, the norm's relative error and the projection's error
# (s8b2_grad_errs), within phase 12's bound for AN-AO
S8B3_LEAVES = {"rwkv6-1.6b": ("tm", ("decay_A", "decay_B", "decay_base",
                                     "bonus_u", "ln_out", "mu_w")),
               "hymba-1.5b": ("ssm", ("a_log", "d_skip", "w_bc"))}
S8B3_GRAD_RTOL = S8B2_MOE_GRAD_RTOL
# the cells train in f32: in bf16 the RWKV6 gradient is mostly rounding
# (the phase logs the one-card bf16 run's first leaf gradients against the
# f32 ones), and with S8B3_DTYPE = "bfloat16" the sharded run's first grad
# norm read 0.35 from the one-card run's (bonus_u's 0.36) on the card;
# in f32 the same TP gradients agree to 4.9e-4 (bonus_u; PERF.md section
# 6, PR 33)
S8B3_DTYPE = "float32"
S8B3_TIMEOUT = 300                    # seconds, the gloo run of two ranks


def s8b3_config(arch, dtype=S8B3_DTYPE):
    """``arch`` at its published widths and FAMILY_LAYERS' depth, in
    ``dtype``."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get(arch),
                               num_layers=FAMILY_LAYERS[arch],
                               param_dtype=dtype, activation_dtype=dtype)


def s8b3_args(arch):
    return ["--arch", arch, "--steps", str(S8B3_STEPS), *S8B_ARGS[4:]]


def s8b3_leaf_grads(torch, arch, seed, mesh=None, dtype=S8B3_DTYPE):
    """The first train step's gradients (``make_grad_fn``, the CLI's
    setup on S8B_ARGS' batch 0, params from ``seed`` in ``dtype``) of
    the leaves of S8B3_LEAVES, summarised as ``s8b2_summary`` does (this
    rank's part under ``mesh``)."""
    from repro_torch.distributed import shard_tree
    from repro_torch.launch.train import run_config
    from repro_torch.models.api import get_model
    from repro_torch.training.train_state import (local_batch, make_grad_fn,
                                                  mesh_setup)

    cfg = s8b3_config(arch, dtype)
    api = get_model(cfg)
    flags = s8b_flags(args=s8b3_args(arch), seed=seed)
    ctx, rules, specs = mesh_setup(api, mesh)
    grads_fn = make_grad_fn(api, ctx, run_config(flags), mesh=mesh)
    params = api.init_params(torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    if mesh is not None:
        params = shard_tree(params, specs.params, mesh)
    batch = s8b2_batch(cfg, seed, flags.batch, flags.seq)
    if mesh is not None:
        batch = local_batch(batch, rules, mesh)
    _, grads = grads_fn(params, batch)
    part, names = S8B3_LEAVES[arch]

    def pick(tree):
        return {"layers": {part: {k: tree["layers"][part][k]
                                  for k in names}}}

    return s8b2_summary(torch, pick(grads), "s8b3", mesh,
                        None if specs is None else pick(specs.params))


def slice8b3_rank(rank, world, out_dir, seed):
    """One rank of the slice 8b-3a gloo run (a process of its own on
    cuda:0): AR, AS, AT, AU, each on a mesh of its own over one world of
    two ranks; writes ``rank<r>.pt``: each cell's leaf gradients (at
    model 2), losses, grad norms, the distance of its final params from
    the one-card run's (rank 0), the collectives and the device busy of
    its first step (counted and profiled: kernels, host copies left
    out), the wall of its second, the peak memory and the cell's
    seconds."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=S8B3_TIMEOUT // 2))
    res = {}
    try:
        for cell, arch, dims, compression in S8B3_RUNS:
            t0 = time.perf_counter()
            rec = res[cell] = {}
            mesh = make_mesh_from_config(
                MeshConfig(dims, s8b_names(dims)), device="cuda",
                backend="gloo")
            if dict(zip(s8b_names(dims), dims))["model"] > 1:
                rec["grads"] = s8b3_leaf_grads(torch, arch, seed, mesh)
                torch.cuda.empty_cache()

            def on_step(i, run_step):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if i == 0:
                    with CostCounter() as cc:
                        rec["busy"] = tick_busy_ms(
                            torch, run_step,
                            rec.setdefault("log", []).append,
                            tag=f"slice8b3_{cell}_rank{rank}", cpu=False,
                            host_copies=False)
                    rec["collectives"] = dict(cc.collectives.counts)
                else:
                    run_step()
                torch.cuda.synchronize()
                rec.setdefault("walls", []).append(
                    1e3 * (time.perf_counter() - t1))

            torch.cuda.reset_peak_memory_stats()
            out = s8b_train(torch, s8b3_config(arch), seed, mesh,
                            compression, on_step, args=s8b3_args(arch))
            rec["peak"] = torch.cuda.max_memory_allocated()
            rec.update(losses=out["losses"], norms=out["norms"])
            if rank == 0:
                ref = torch.load(out_dir / f"ref_{arch}.pt",
                                 weights_only=True)
                rec["param_err"] = s8b_param_err(torch, out["params"], ref)
                del ref
            del out
            torch.cuda.empty_cache()
            rec["secs"] = time.perf_counter() - t0
            print(f"{cell} {rec['secs']:.1f}s", flush=True)
    finally:
        dist.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


def s8b3_spawn(seed, out_dir, world=2):
    """The slice 8b-3a gloo ranks as subprocesses, within S8B3_TIMEOUT."""
    import os

    from repro_torch.launch.mesh import run_ranks

    env = dict(os.environ, PYTHONPATH=str(SRC))
    logs = [open(out_dir / f"rank{r}.out", "w") for r in range(world)]
    try:
        codes = run_ranks(
            [[sys.executable, "-c", f"import chip_smoke; chip_smoke."
              f"slice8b3_rank({r}, {world}, {str(out_dir)!r}, {seed})"]
             for r in range(world)], env=env, cwd=str(ROOT),
            timeout=S8B3_TIMEOUT, outputs=logs)
    finally:
        for f in logs:
            f.close()
    check(codes == [0] * world, "slice 8b-3a: gloo ranks exited "
          f"{codes}: " + " ".join(
              f"--- rank {r}: {(out_dir / f'rank{r}.out').read_text()[-2000:]}"
              for r in range(world)))


def slice8b3_phase(torch, seed, log):
    """Slice 8b-3a on the card (the "torch" plan: no kernel of the table
    runs): the recurrent families on a mesh. The references first, on
    one card in this process: S8B3_STEPS steps of rwkv6-1.6b and of
    hymba-1.5b (published widths, FAMILY_LAYERS' depth, f32, 8 x 512)
    and their first gradients of S8B3_LEAVES, logged beside the same
    gradients in bf16. Then two gloo ranks on cuda:0
    (subprocesses, spawned once) run S8B3_RUNS: AR / AT at (data, model)
    = (1, 2), AS / AU at (pod, data, model) = (2, 1, 1) with int8-EF.
    Losses, grad norms and final params against the one-card run under
    phase 11's bounds (S8B_RTOL, S8B_NORM_RTOL, S8B_PARAM_RTOL; int8-EF
    the S8B_EF_ ones), the ranks' losses alike; at model 2 the leaf
    gradients within S8B3_GRAD_RTOL; the collectives of a step against
    ``s8b_collectives``; each rank's wall (second step), busy (first,
    profiled: kernels, host copies left out) and peak memory beside the
    card's name and power limit. The walls carry gloo's host copies and
    both ranks share one card: not multi-card numbers. Every reading is
    logged before any check."""
    import shutil
    import tempfile

    from repro_torch.models.api import get_model
    from repro_torch.models.stack import tree_map

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    checks = []
    out_dir = Path(tempfile.mkdtemp(prefix="slice8b3_"))
    try:
        t0 = time.perf_counter()
        one, update, grads, bf16 = {}, {}, {}, {}
        for arch in S8B3_LEAVES:
            cfg = s8b3_config(arch)
            one[arch] = s8b_train(torch, cfg, seed, args=s8b3_args(arch))
            p0 = get_model(cfg).init_params(
                torch.Generator(device="cuda").manual_seed(seed),
                device="cuda")
            update[arch] = s8b_param_err(torch, one[arch]["params"], p0)
            del p0
            torch.save(tree_map(lambda t: t.cpu(),
                                one[arch].pop("params")),
                       out_dir / f"ref_{arch}.pt")
            grads[arch] = s8b3_leaf_grads(torch, arch, seed)
            # the yardstick of bf16 rounding: the same first gradients
            # on one card in bf16 (params the f32 ones rounded)
            bf16[arch] = s8b2_grad_errs(s8b3_leaf_grads(
                torch, arch, seed, dtype="bfloat16"), grads[arch])[0]
            gc.collect()
            torch.cuda.empty_cache()
        log(f"slice 8b-3a references on one card: "
            f"{time.perf_counter() - t0:.1f}s")
        for arch, errs in bf16.items():
            log(f"slice 8b-3a {arch} one card, the first gradients in bf16 "
                f"against {S8B3_DTYPE} (norm, projection; {smi}): "
                + ", ".join(f"{k.rsplit('/', 1)[-1]} {e[0]:.2e} {e[1]:.2e}"
                            for k, e in errs.items()))
        t0 = time.perf_counter()
        s8b3_spawn(seed, out_dir)
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"slice 8b-3a gloo run: 2 ranks on cuda:0, "
            f"{time.perf_counter() - t0:.1f}s with the ranks' start; cells "
            + ", ".join(f"{c} {ranks[0][c]['secs']:.1f}s"
                        for c, _, _, _ in S8B3_RUNS))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        for cell, rec in res.items():
            for line in rec.get("log", []):
                log(f"slice 8b-3a rank {r}: {line}")
    flags = s8b_flags(args=S8B_ARGS)
    for cell, arch, dims, compression in S8B3_RUNS:
        cfg = s8b3_config(arch)
        r0, r1 = ranks[0][cell], ranks[1][cell]
        rels = s8b_rel(r0["losses"], one[arch]["losses"])
        nrels = s8b_rel(r0["norms"], one[arch]["norms"])
        perr = r0["param_err"] / update[arch]
        if compression == "none":
            ok = (max(rels) <= S8B_RTOL and max(nrels) <= S8B_NORM_RTOL
                  and perr <= S8B_PARAM_RTOL)
        else:
            ok = (rels[0] <= S8B_EF_FIRST_RTOL and max(rels) <= S8B_EF_RTOL
                  and max(nrels) <= S8B_EF_NORM_RTOL
                  and perr <= S8B_EF_PARAM_RTOL)
        want = s8b_collectives(cfg, dims, compression, flags.seq)
        busy = ["not measured" if r["busy"] is None else
                f"{r['busy']:.2f} ms" for r in (r0, r1)]
        leaves = ""
        if "grads" in r0:
            errs, worst = s8b2_grad_errs(
                s8b2_add([r0["grads"], r1["grads"]]), grads[arch])
            leaves = (
                "; first gradients of the leaves cut to each rank's heads "
                "(norm, projection) " + ", ".join(
                    f"{k.rsplit('/', 1)[-1]} {e[0]:.2e} {e[1]:.2e}"
                    for k, e in errs.items())
                + f" (tol {S8B3_GRAD_RTOL})")
            checks.append((max(worst) <= S8B3_GRAD_RTOL,
                           f"slice 8b-3a {cell}: leaf gradients {errs}"))
        log(f"slice 8b-3a {cell} ({arch}, {cfg.num_layers} layers, "
            f"{cfg.param_dtype}, {dims}, {compression}; {smi}): losses {r0['losses']} vs one card "
            f"{one[arch]['losses']}, rel {', '.join(f'{x:.2e}' for x in rels)}"
            f"; grad norms {r0['norms']} vs {one[arch]['norms']}, rel "
            f"{', '.join(f'{x:.2e}' for x in nrels)}; params {perr:.3e} of "
            f"the one-card update ({update[arch]:.4f}){leaves}; collectives "
            f"a step {r0['collectives']} / {r1['collectives']} (derived "
            f"{want}); per rank wall a step {r0['walls'][1]:.1f} / "
            f"{r1['walls'][1]:.1f} ms (second step; first "
            f"{r0['walls'][0]:.1f} / {r1['walls'][0]:.1f} counted and "
            f"profiled), busy {busy[0]} / {busy[1]} (first, profiled: "
            f"kernels, host copies left out), peak "
            f"{r0['peak'] / 2**30:.2f} / {r1['peak'] / 2**30:.2f} GiB; "
            f"{flags.batch} x {flags.seq} tokens a step over both ranks; the "
            "walls carry gloo's host copies and both ranks share one card: "
            "not a multi-card number")
        checks.append((ok and r0["losses"] == r1["losses"],
                       f"slice 8b-3a {cell}: losses {r0['losses']} / "
                       f"{r1['losses']}, norms {r0['norms']}, params {perr} "
                       f"against the one-card {one[arch]['losses']}, "
                       f"{one[arch]['norms']}"))
        for r, res in enumerate((r0, r1)):
            checks.append((res["collectives"] == want, f"slice 8b-3a {cell}:"
                           f" rank {r} issued {res['collectives']} in a "
                           f"step, not {want}"))
    gc.collect()
    torch.cuda.empty_cache()
    for ok, msg in checks:
        check(ok, msg)


# slice 8b-3b: tensor parallelism in the decode tick, two gloo ranks at
# (data, model) = (1, 2) sharing this card, AH's rows and ticks (S8A_*):
# (cell, arch, layers); AV at FAMILY_LAYERS' serving depth, AW one of
# dbrx-132b's 40 layers (9.0 GB of bf16 params, as AN-AO: the reference
# and both ranks' halves share the card)
S8B3B_RUNS = (("AV", ARCH, 4), ("AW", MOE_ARCH, 1))
S8B3B_TIMEOUT = 300                   # seconds, the gloo run of two ranks
S8B3B_FLIPS = 3     # AW's expert sets (of 64 a scheme) the free router may
                    # choose otherwise than rank 0: near-tied router logits


def s8b3b_config(arch, layers):
    """``arch`` at its published widths and ``layers`` of its depth."""
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), num_layers=layers)


def s8b3b_collectives(cfg, scheme):
    """A TP decode tick's collectives at (1, 2), derived from the code
    (``models/layers.py``, ``transformer.decode_step``): the embedding's
    all-reduce; a layer's q / k / v gathered whole (one all-gather), its
    sequence-split attention (one all-reduce under unified_max, a MAX
    then a SUM under sync), wo's all-reduce and the FFN's (w_down's, or
    the MoE experts' partial sums); the logits gathered whole."""
    per = 1 if scheme == "unified_max" else 2
    n = cfg.num_layers
    return {"all-reduce": 1 + n * (per + 2), "all-gather": n + 1}


def s8b3b_routes():
    """The context that records the MoE routing choices made inside, in
    call order, as the device's tensors (no copy to the host inside a
    timed tick), replacing each call's choices with ``force``'s where
    given (weights renormalised from the call's own probs)."""
    import contextlib

    from repro_torch.models import moe

    @contextlib.contextmanager
    def recorded(force=None):
        calls, route = [], moe.route

        def routed(router, xg, k):
            probs, w, idx = route(router, xg, k)
            if force is not None:
                idx = force[len(calls)].to(idx.device)
                w = probs.gather(-1, idx)
                w = w / w.sum(-1, keepdim=True)
            calls.append(idx)
            return probs, w, idx

        moe.route = routed
        try:
            yield calls
        finally:
            moe.route = route

    return recorded


def s8b3b_flipped(torch, got, want, rows):
    """(the (token, layer) expert sets of the route calls ``got`` that
    differ from ``want``'s, the ``rows`` whose own token's set differs in
    some layer), a decode tick's calls holding one token a row."""
    flipped = torch.zeros(rows, dtype=torch.bool)
    n = 0
    for g, w in zip(got, want):
        g, w = (c.cpu().reshape(rows, -1, c.shape[-1]).sort(-1).values
                for c in (g, w))
        differ = (g != w).any(-1)
        n += int(differ.sum())
        flipped |= differ.any(-1)
    return n, flipped


def slice8b3b_rank(rank, world, out_dir, seed):
    """One rank of the slice 8b-3b gloo run (a process of its own on
    cuda:0): AV and AW under each scheme, ``serving/sharded.py`` on the
    "cuda" plan with this rank's TP cut of the params and its slice of
    the 4 x 32,768 cache; writes ``rank<r>.pt``: logits (rank 0), tokens,
    each tick's wall, one tick's device busy (profiled, host copies left
    out), the collectives of one tick, the kernels' launches, the MoE
    routing choices (rank 0) and the peak memory."""
    import datetime

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.analysis.cost import CostCounter
    from repro_torch.config import MeshConfig
    from repro_torch.core.plan import make_plan
    from repro_torch.distributed import shard_tree
    from repro_torch.launch.mesh import make_mesh_from_config
    from repro_torch.serving.sharded import serve_rules, sharded_serve

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=S8B3B_TIMEOUT // 2))
    res = {"log": []}
    recorded = s8b3b_routes()
    try:
        mesh = make_mesh_from_config(MeshConfig((1, world), ("data", "model")),
                                     backend="gloo")
        rules = serve_rules(mesh)
        for cell, arch, layers in S8B3B_RUNS:
            cfg = s8b3b_config(arch, layers)
            for scheme in S8A_SCHEMES:
                t0 = time.perf_counter()
                api, params, cache, tokens, lengths = s8a_model(
                    torch, cfg, seed, world, rank)
                srv = sharded_serve(api, make_plan("cuda", scheme=scheme),
                                    mesh, rules)
                params = shard_tree(params, srv.param_specs, mesh)
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for c in counters().values():
                    c.launches = 0
                logits, toks, walls, routes = [], [], [], []
                busy = coll = None
                for t in range(S8A_TICKS):
                    made = []     # the tick's routes, copied after its wall

                    def tick():
                        with torch.no_grad(), recorded() as calls:
                            lg = srv.decode_step(params, tokens, cache,
                                                 lengths)[0]
                        made.extend(calls)
                        return lg

                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    if t == 1:
                        with CostCounter() as cc:
                            lg = tick()
                        coll = dict(cc.collectives.counts)
                    elif t == S8A_TICKS - 1:
                        box = []
                        busy = tick_busy_ms(
                            torch, lambda: box.append(tick()),
                            res["log"].append,
                            tag=f"slice8b3b_{cell}_{scheme}_rank{rank}",
                            cpu=False, host_copies=False)
                        lg = box[0]
                    else:
                        lg = tick()
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t1))
                    routes.extend(c.cpu() for c in made)
                    if rank == 0:
                        logits.append(lg.float().cpu())
                    tokens = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
                    toks.append(tokens.cpu())
                    lengths = lengths + 1
                res[cell, scheme] = dict(
                    logits=logits, tokens=toks, walls=walls, busy=busy,
                    collectives=coll, routes=routes if rank == 0 else None,
                    peak=torch.cuda.max_memory_allocated(),
                    launches={n: c.launches for n, c in counters().items()
                              if c.launches},
                    secs=time.perf_counter() - t0)
                del params, cache, srv
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.save(res, out_dir / f"rank{rank}.pt")


def s8b3b_spawn(seed, out_dir, world=2):
    """The slice 8b-3b gloo ranks as subprocesses, within S8B3B_TIMEOUT."""
    import os

    from repro_torch.launch.mesh import run_ranks

    env = dict(os.environ, PYTHONPATH=str(SRC))
    logs = [open(out_dir / f"rank{r}.out", "w") for r in range(world)]
    try:
        codes = run_ranks(
            [[sys.executable, "-c", f"import chip_smoke; chip_smoke."
              f"slice8b3b_rank({r}, {world}, {str(out_dir)!r}, {seed})"]
             for r in range(world)], env=env, cwd=str(ROOT),
            timeout=S8B3B_TIMEOUT, outputs=logs)
    finally:
        for f in logs:
            f.close()
    check(codes == [0] * world, "slice 8b-3b: gloo ranks exited "
          f"{codes}: " + " ".join(
              f"--- rank {r}: {(out_dir / f'rank{r}.out').read_text()[-2000:]}"
              for r in range(world)))


def s8b3b_dryrun(log):
    """The mesh dry run's CLI in this process (the CPU, the meta device):
    qwen2-0.5b x decode_32k as rank 0 of the single pod under torch's fake
    process group, which this machine's torch must have."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import dryrun

    out = Path(tempfile.mkdtemp(prefix="dryrun_mesh_"))
    try:
        t0 = time.perf_counter()
        rc = dryrun.main(["--mesh", "single", "--arch", ARCH, "--shape",
                          "decode_32k", "--no-probes", "--out", str(out)])
        rec = json.loads((out / f"{ARCH}__decode_32k__16x16.json")
                         .read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    full = rec.get("full", {})
    log(f"slice 8b-3b dry run --mesh single {ARCH} decode_32k on the CPU: "
        f"rc {rc}, {time.perf_counter() - t0:.1f}s, chips {rec['chips']}, "
        f"fsdp_params {rec.get('fsdp_params')}, rank 0's argument bytes "
        f"{full.get('argument_size_in_bytes')}, per_device_bytes "
        f"{full.get('per_device_bytes')}, collectives "
        f"{full.get('collective_counts')} "
        f"({full.get('collective_bytes')} B)")
    check(rc == 0 and rec["ok"] and rec["chips"] == 256
          and full.get("collective_bytes", 0) > 0,
          f"slice 8b-3b: the mesh dry run failed: {rec.get('error', rec)}")
    check(not dist.is_initialized(), "slice 8b-3b: the dry run left a "
          "process group behind")


def slice8b3b_phase(torch, seed, log, launches):
    """Slice 8b-3b on the card: the mesh dry run's CLI in this process
    (``s8b3b_dryrun``), then two gloo ranks on cuda:0 (subprocesses,
    spawned once) run S8B3B_RUNS through ``serving/sharded.py`` on the
    "cuda" plan, each rank with its TP cut of the params (column-parallel
    q / k / v gathered whole, row-parallel wo, the MLP or the experts'
    F) and its slice of AH's 4 x 32,768 cache: 16 greedy ticks a scheme,
    rows 3-4's shard partials and rows 1-2 on the cut weights. Then the
    same ticks unsharded here on the "cuda" plan, fed the ranks' tokens
    (AW's twice: its router free, then with rank 0's expert choices
    forced): every tick's logits within LOGITS_TOL, free too on the rows
    whose experts agree with rank 0's, at most S8B3B_FLIPS expert sets
    chosen otherwise, tokens equal or near ties, the ranks' tokens alike, the collectives of a tick as
    ``s8b3b_collectives`` derives them, each partial kernel once a layer
    a tick, rows 1 and 2 launched; each rank's wall (median tick), busy
    (one profiled tick, host copies left out) and peak memory beside the
    card's name and power limit. The walls carry gloo's host copies and
    both ranks share one card: not multi-card numbers."""
    import shutil
    import tempfile

    from repro_torch.core.plan import make_plan
    from repro_torch.models.layers import LayerCtx

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    s8b3b_dryrun(log)
    out_dir = Path(tempfile.mkdtemp(prefix="slice8b3b_"))
    try:
        t0 = time.perf_counter()
        s8b3b_spawn(seed, out_dir)
        ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        log(f"slice 8b-3b gloo run: 2 ranks on cuda:0, "
            f"{time.perf_counter() - t0:.1f}s with the ranks' start; "
            + ", ".join(f"{c} {s} {ranks[0][c, s]['secs']:.1f}s"
                        for c, _, _ in S8B3B_RUNS for s in S8A_SCHEMES))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        for line in res["log"]:
            log(f"slice 8b-3b rank {r}: {line}")
    recorded = s8b3b_routes()
    checks = []
    for cell, arch, layers in S8B3B_RUNS:
        cfg = s8b3b_config(arch, layers)
        for scheme in S8A_SCHEMES:
            r0, r1 = ranks[0][cell, scheme], ranks[1][cell, scheme]
            api, params, cache, tokens, lengths = s8a_model(torch, cfg, seed)
            ctx = LayerCtx(cfg, make_plan("cuda", scheme=scheme))
            worst, free_worst, ties, flips = 0.0, 0.0, 0, 0
            force = r0["routes"] if cfg.moe is not None else None
            forced_calls = 0
            for t in range(S8A_TICKS):
                a = r0["logits"][t][:, :cfg.vocab_size]
                if force is not None:
                    # the router free first; the forced tick then rewrites
                    # the cache at the same positions
                    with torch.no_grad(), recorded() as free:
                        got = api.decode_step(ctx, params, tokens, cache,
                                              lengths)[0].float().cpu()
                    n, flipped = s8b3b_flipped(
                        torch, force[forced_calls:forced_calls + len(free)],
                        free, a.shape[0])
                    flips += n
                    err = (a - got[:, :cfg.vocab_size]).abs().amax(-1)
                    err = err[~flipped].max().item() if (~flipped).any() \
                        else 0.0
                    free_worst = max(free_worst, err)
                    checks.append((err <= LOGITS_TOL,
                                   f"slice 8b-3b {cell} {scheme} tick {t}: "
                                   "logits of rows whose experts agree "
                                   f"differ by {err} with the router free"))
                with torch.no_grad(), recorded(
                        None if force is None
                        else force[forced_calls:]) as calls:
                    want = api.decode_step(ctx, params, tokens, cache,
                                           lengths)[0].float().cpu()
                forced_calls += len(calls)
                w = want[:, :cfg.vocab_size]
                row_err = (a - w).abs().amax(-1)
                tok = a.argmax(-1)
                near = (w.amax(-1) - w.gather(1, tok[:, None])[:, 0]
                        <= 2 * row_err)
                agree = tok == w.argmax(-1)
                worst = max(worst, row_err.max().item())
                ties += int((near & ~agree).sum())
                checks.append((row_err.max().item() <= LOGITS_TOL,
                               f"slice 8b-3b {cell} {scheme} tick {t}: "
                               f"logits differ by {row_err.max().item()}"))
                checks.append((bool((agree | near).all()),
                               f"slice 8b-3b {cell} {scheme} tick {t}: a "
                               "greedy token differs by more than a near "
                               "tie"))
                checks.append((torch.equal(r0["tokens"][t], r1["tokens"][t]),
                               f"slice 8b-3b {cell} {scheme} tick {t}: the "
                               "ranks' tokens differ"))
                tokens = r0["tokens"][t].cuda()
                lengths = lengths + 1
            del params, cache
            gc.collect()
            torch.cuda.empty_cache()
            if force is not None:
                checks.append((flips <= S8B3B_FLIPS,
                               f"slice 8b-3b {cell} {scheme}: the free "
                               f"router chose otherwise {flips} expert "
                               f"sets, past {S8B3B_FLIPS}"))
            want_coll = s8b3b_collectives(cfg, scheme)
            partial = S8A_PARTIALS[scheme]
            for r, res in enumerate((r0, r1)):
                for n, c in res["launches"].items():
                    launches[n] = launches.get(n, 0) + c
                checks.append((res["collectives"] == want_coll,
                               f"slice 8b-3b {cell} {scheme}: rank {r} "
                               f"issued {res['collectives']} in a tick, not "
                               f"{want_coll}"))
                checks.append((res["launches"].get(partial, 0)
                               == S8A_TICKS * cfg.num_layers,
                               f"slice 8b-3b {cell} {scheme}: rank {r}'s "
                               f"{partial} launched "
                               f"{res['launches'].get(partial, 0)} times"))
                checks.append((res["launches"].get("gemv", 0)
                               + res["launches"].get("flat_gemm", 0) > 0,
                               f"slice 8b-3b {cell} {scheme}: rank {r} "
                               "launched no GEMM kernel"))
            walls = [statistics.median(res["walls"]) for res in (r0, r1)]
            busy = ["not measured" if res["busy"] is None
                    else f"{res['busy']:.3f} ms" for res in (r0, r1)]
            moe = (f"; expert sets of rank 0's tokens that the free "
                   f"unsharded router chose otherwise {flips} (bound "
                   f"{S8B3B_FLIPS}), its logits on the rows that agree "
                   f"within {free_worst:.4f}; the max_abs_err above with "
                   "rank 0's choices forced" if force is not None else "")
            log(f"slice 8b-3b {cell} ({arch}, {cfg.num_layers} layers, "
                f"(1, 2) TP, {scheme}; {smi}): {S8A_TICKS} ticks, logits vs "
                f"unsharded max_abs_err={worst:.4f} (tol {LOGITS_TOL}), near "
                f"ties {ties}{moe}; collectives a tick {r0['collectives']} / "
                f"{r1['collectives']} (derived {want_coll}); launches a rank "
                f"{r0['launches']}; per rank wall (median of {S8A_TICKS}) "
                f"{walls[0]:.3f} / {walls[1]:.3f} ms, busy {busy[0]} / "
                f"{busy[1]} (one tick, profiled, host copies left out), peak "
                f"{r0['peak'] / 2**30:.2f} / {r1['peak'] / 2**30:.2f} GiB; the "
                "walls carry gloo's host copies and both ranks share one "
                "card: not a multi-card number")
    for ok, msg in checks:
        check(ok, msg)


def examples_phase(log):
    """The port's examples on the card (qwen2-0.5b's published widths),
    three subprocesses at once; fails if any exits non-zero."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in EXAMPLES}
    results = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            results[name] = (proc.returncode, out, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (rc, out, err) in results.items():
        for line in out.splitlines():
            log(f"example {name}: {line}")
        check(rc == 0, f"example {name} exited {rc}: {err[-2000:]}")
    log(f"examples: {time.perf_counter() - t0:.1f}s, three at once")


def use_bytecode_cache():
    """Keep the bytecode of every module imported from here on under
    PYCACHE, for this process and the subprocesses it starts (the rank
    processes, the CLI runs, the examples). Where the environment turns
    bytecode writing off, each fresh process otherwise compiles torch's
    lazily imported modules from source: about 10 s a process, measured
    on the card's machine."""
    import os

    PYCACHE.mkdir(parents=True, exist_ok=True)
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profiles-only", action="store_true",
                    help="build, then run only the decode-tick and "
                    "chunk-step profiles (A, B, N; E, H, P; J, K, O, P, S) "
                    "and print them; checks nothing and prints no result "
                    "line")
    ap.add_argument("--plan-only", action="store_true",
                    help="build, then only measure the cost models' fixed "
                    "costs and tune qwen2-0.5b's plan into chiprun_out/ "
                    "(printing where it differs from plans_torch/); "
                    "prints no result line")
    ap.add_argument("--slice7b-only", action="store_true",
                    help="build, then only the slice 7b kernel lines and "
                    "runs Y, Z, Z′ and AA; prints no result line")
    ap.add_argument("--slice9a-only", action="store_true",
                    help="build, then only runs Y, Z, Z′ and AA (split and "
                    "looped) and the train phase; prints no result line")
    ap.add_argument("--decode32k-only", action="store_true",
                    help="build, then only the decode_32k cell beside its "
                    "dry run and the examples; prints no result line")
    ap.add_argument("--slice8a-only", action="store_true",
                    help="build, then only the slice 8a phase (rows 3 and "
                    "4 as shard partials, NCCL at world size 1, two gloo "
                    "ranks on one card); prints no result line")
    ap.add_argument("--slice8b1-only", action="store_true",
                    help="build, then only the slice 8b-1 phase (the "
                    "int8-EF leaf, the sharded trainer on NCCL at world "
                    "size 1 and on two gloo ranks on one card); prints no "
                    "result line")
    ap.add_argument("--slice8b3-only", action="store_true",
                    help="build, then only the slice 8b-3a phase (rwkv6 "
                    "and hymba under TP and int8-EF, on two gloo ranks on "
                    "one card); prints no result line")
    ap.add_argument("--slice8b3b-only", action="store_true",
                    help="build, then only the slice 8b-3b phase (the mesh "
                    "dry run in process; qwen2-0.5b and dbrx-132b decoding "
                    "under TP on two gloo ranks on one card); prints no "
                    "result line")
    ap.add_argument("--slice8b2-only", action="store_true",
                    help="build, then only the slice 8b-2 phase (the "
                    "pipeline over pod, MoE on a data mesh and under TP, "
                    "whisper-tiny under TP and int8-EF, on two gloo ranks "
                    "on one card); prints no result line")
    args = ap.parse_args(argv)
    if (SRC / "repro_torch" / "csrc").is_dir():
        use_bytecode_cache()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models.api import get_model
    from repro_torch.serving.request import SamplingParams

    OUT_DIR.mkdir(exist_ok=True)
    log_lines = []

    def log(line):
        print(line, flush=True)
        log_lines.append(line)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s wall, per source "
        + ", ".join(f"{k}={v:.1f}s" for k, v in secs.items()))

    rows = {}
    if args.slice8b3b_only:
        t0 = time.perf_counter()
        slice8b3b_phase(torch, args.seed, log, {})
        log(f"slice 8b-3b phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.slice8b3_only:
        t0 = time.perf_counter()
        slice8b3_phase(torch, args.seed, log)
        log(f"slice 8b-3a phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.slice8b2_only:
        t0 = time.perf_counter()
        slice8b2_phase(torch, args.seed, log)
        log(f"slice 8b-2 phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.slice8b1_only:
        t0 = time.perf_counter()
        slice8b1_phase(torch, args.seed, log)
        log(f"slice 8b-1 phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.slice8a_only:
        t0 = time.perf_counter()
        slice8a_phase(torch, args.seed, log, {}, rows)
        log(f"slice 8a phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.decode32k_only:
        t0 = time.perf_counter()
        decode32k_phase(torch, args.seed, log, {}, rows)
        log(f"decode_32k phase: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        examples_phase(log)
        log(f"examples phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if args.slice9a_only:
        a_lengths = np.random.default_rng(args.seed).integers(32, 301, size=8)
        t0 = time.perf_counter()
        slice7b_phase(torch, args.seed, [int(n) for n in a_lengths], log, {})
        log(f"slice 7b and looped phase: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        train_phase(torch, args.seed, log)
        log(f"train phase: {time.perf_counter() - t0:.1f}s")
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    if not (args.profiles_only or args.plan_only):
        timer = Timer(torch)
        t0 = time.perf_counter()
        kernel_phase(torch, timer, rows, log,
                     slice7b_only=args.slice7b_only)
        log(f"kernel phase: {time.perf_counter() - t0:.1f}s")
        print(f"chip_smoke: kernel phase done at "
              f"{time.perf_counter() - T_START:.0f}s", file=sys.stderr,
              flush=True)
        del timer
    if args.slice7b_only:
        a_lengths = np.random.default_rng(args.seed).integers(32, 301, size=8)
        slice7b_phase(torch, args.seed, [int(n) for n in a_lengths], log, {})
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0

    cfg = serve_config()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = get_model(cfg).init_params(gen, device="cuda")
    log(f"serving {ARCH} at {cfg.num_layers} of "
        f"{configs.get(ARCH).num_layers} layers (phases 3-5)")
    rng = np.random.default_rng(args.seed)
    sp = SamplingParams(max_new_tokens=32)
    requests = [(rng.integers(1, cfg.vocab_size, size=int(n)).astype(
        np.int32), sp) for n in rng.integers(32, 301, size=8)]
    log("prompt lengths: " + str([len(p) for p, _ in requests]))
    shared = shared_requests(np, cfg, args.seed)
    log("shared-header prompt lengths: " + str([len(p) for p, _ in shared]))
    mixed = mixed_requests(np, cfg, args.seed)
    log("two-header prompt lengths / new tokens: " + str(
        [(len(p), s.max_new_tokens) for p, s in mixed]))
    if args.profiles_only:
        tick_profiles(torch, cfg, params, requests, shared, log)
        print(smi)
        return 0
    if args.plan_only:
        cost_phase(torch, args.seed, requests, shared, log)
        tune_phase(torch, configs.get(ARCH), log, strict=False)
        (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
        print(smi)
        return 0
    check(set(REPLACES) <= set(counters()),
          "a kernel of REPLACES has no counter in ops.LAUNCH_COUNTERS")
    # the quantized-weight runs serve the same requests with fewer tokens
    sp16 = SamplingParams(max_new_tokens=16)
    sp32 = SamplingParams(max_new_tokens=32)
    launches = {}
    t_mark = [time.perf_counter()]

    def mark(what):
        """Log the seconds since the last mark (the time a phase takes),
        and on stderr the seconds since the start as well."""
        now = time.perf_counter()
        log(f"{what} phase: {now - t_mark[0]:.1f}s")
        print(f"chip_smoke: {what} phase done at {now - T_START:.0f}s",
              file=sys.stderr, flush=True)
        t_mark[0] = now

    outputs = serve_phase(torch, cfg, params,
                          {"plain": requests, "shared": shared,
                           "mixed": mixed,
                           "plain16": [(p, sp16) for p, _ in requests],
                           "shared32": [(p, sp32) for p, _ in shared]},
                          log, launches)
    chunk_ms = tier_phase(torch, cfg, params, shared, outputs, log,
                          launches)
    transfer_phase(torch, cfg, params, log, chunk_ms)
    mark("serve and tier")
    tick_profiles(torch, cfg, params, requests, shared, log)
    profile_phase(torch, cfg, params, shared, log,
                  tag="H slots=4 paged sharing grouped fused-FFN",
                  cache_kind="paged", page_size=PAGE, prefix_sharing=True,
                  plan=tuned_plan())
    profile_phase(torch, cfg, params, requests, log,
                  tag="M slots=4 int8 weights", weight_dtype="int8")
    mark("profile")
    graph_phase(torch, cfg, params, shared, log)
    logits_phase(torch, cfg, params, requests, log, outputs["A"])
    bf16_paged = paged_logits_phase(torch, cfg, params, shared, log)
    quant_logits_phase(torch, cfg, params, requests, log)
    kv_quant_logits_phase(torch, cfg, params, shared, log, bf16_paged)
    mark("graph and logits")
    # T3 on the card: fixed costs, the wallclock tuner, the tuned route
    cost_phase(torch, args.seed, requests, shared, log)
    tuned = tune_phase(torch, configs.get(ARCH), log)
    split_tuned = tuned_serve_phase(torch, cfg, params, requests, tuned,
                                    outputs, launches, log)
    tuned_logits_phase(torch, cfg, params, requests, split_tuned, log)
    tuned_profiles(torch, cfg, params, requests, split_tuned, log)
    cli_phase(log)
    mark("T3")
    # the MoE runs need the card's memory: qwen2-0.5b's weights go first
    # (the engines that held them sit in reference cycles: collect them)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_phase(torch, args.seed, [len(p) for p, _ in requests], log,
              launches)
    mark("moe")
    slice7b_phase(torch, args.seed, [len(p) for p, _ in requests], log,
                  launches)
    mark("slice 7b and looped")
    train_phase(torch, args.seed, log)
    mark("train")
    decode32k_phase(torch, args.seed, log, launches, rows)
    mark("decode_32k")
    slice8a_phase(torch, args.seed, log, launches, rows)
    mark("slice 8a")
    slice8b1_phase(torch, args.seed, log)
    mark("slice 8b-1")
    slice8b2_phase(torch, args.seed, log)
    mark("slice 8b-2")
    slice8b3_phase(torch, args.seed, log)
    mark("slice 8b-3a")
    slice8b3b_phase(torch, args.seed, log, launches)
    mark("slice 8b-3b")
    examples_phase(log)
    mark("examples")

    for name in REPLACES:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was never launched on the main path")
    log("launches " + json.dumps(launches))
    kernels = []
    for name in REPLACES:
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["case"],
            **{key: v for key, v in r.items()
               if key == "bf16_ms" or isinstance(v, dict)}})
    (OUT_DIR / "chip_smoke.log").write_text("\n".join(log_lines) + "\n")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
