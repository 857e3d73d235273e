"""End-to-end serving CLI (continuous batching over synthetic requests)
for the port, on the dense slot cache or the block-paged pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4 --max-seq 1024 --max-new 32 --prompt-len 128

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
the kernels' plain versions on the CPU (use ``--smoke`` there). Weights
are random, drawn from ``--seed`` with the JAX package's init
distributions. ``--prefill-chunk`` defaults to the plan's
``paged.chunk_block`` (64 untuned); ``--prefill-chunk 0`` prefills each
admission wave in one padded call through flash prefill attention.
``--temperature`` and ``--top-p`` set every request's sampling (greedy
at temperature 0, the default).

``--cache-kind paged`` serves from a shared pool of ``--page-size``
pages through block tables; ``--num-pages`` or ``--overcommit`` below 1
shrinks the pool so that lazy page growth preempts. ``--prefix-sharing``
maps identical page-aligned prompt prefixes onto refcounted
copy-on-write pages (``--shared-prefix N`` prepends N identical tokens to
every prompt), and ``--gather-chunk dense|fused`` picks how chunked
prefill reads the pool. ``--decode-group grouped`` (with
``--prefix-sharing``) reads each shared prefix once per group of slots at
decode; the summary then counts grouped decodes and the prefix KV bytes
saved. The ``req N:`` lines do not change with any of these.

``--host-pages N`` (paged, with ``--prefix-sharing``) puts a host-memory
tier of N pages behind the pool: preemption and retirement keep their
full KV pages in a session cache instead of freeing them, pool pressure
demotes those pages to pinned host memory, and a returning prompt
promotes them back instead of re-prefilling them (``--session-cache``
alone keeps the session cache on the device only). ``--rounds R``
resubmits every prompt R times, calling ``evict_finished()`` between
rounds, so rounds 2 and on are returning conversations; the summary adds
the pages demoted and promoted and the session hits.

``--weight-dtype bf16|int8|fp8`` stores every layer GEMM weight as int8
or fp8 codes with one f32 step per output channel, quantized once at
load; the GEMM kernels stream the codes and scale their f32 accumulators.
The summary's ``weights=`` segment gives the stored weight bytes per
decode tick and the total the decode ticks read. The accuracy contract of
int8 / fp8 is the logits guard (``quant.logits_guard_tol``), not bitwise
tokens against bf16; ``bf16`` (the default) keeps every ``req N:`` line.

``--kv-dtype bf16|int8|fp8`` (paged only; default: the plan's
``paged.kv_dtype``, bf16) stores every KV page as int8 or fp8 codes with
one f32 step per (page, kv head), written by the quantized scatter and
dequantized inside the paged kernels. The summary's ``kv=`` segment gives
the stored bytes per page (steps included) and the KV bytes the decode
ticks read; the accuracy contract is again the logits guard.

``--plan PATH`` serves with a tuned plan, loaded strictly: a plan tuned
for another config or other hardware (its provenance hashes) raises
``StalePlanError``. ``--tune`` runs the offline tuner first
(``core.plan.tune``: GEMM inflections timed on the card with the
wallclock measure, or from the analytical models under ``--device
cpu``), saves the plan to ``--plan`` or
``plans_torch/<arch>-<hw>.json``, prints its ``describe()`` line and
serves with it. Plans pick kernels, not tokens.

``--decode-fusion split|fused|looped`` overrides the plan's decode-layer
granularity: ``fused`` runs each layer as four fused stage kernels,
``looped`` replays the whole decode step as one CUDA graph on the card
(on the CPU it runs the fused path eagerly). The summary reports
``fusion=<granularity>`` and, under looped, ``graphs=<captures>/
<replays>``.
"""
import argparse
import sys
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (2 layers, width "
                         "128)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill chunk size (default: the plan's "
                         "paged.chunk_block); 0 = one padded prefill call "
                         "per admission wave (dense cache)")
    ap.add_argument("--cache-kind", choices=["dense", "paged"],
                    default="dense",
                    help="dense slot cache or block-paged pool")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="exact pool size in pages (default: the worst-case "
                         "slots*max_seq footprint scaled by --overcommit)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="fraction of the worst-case page footprint to "
                         "provision; below 1 lazy growth preempts")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "sjf", "pagefair"],
                    help="admission/preemption policy")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="map identical page-aligned prompt prefixes onto "
                         "shared refcounted pages (copy-on-write; paged "
                         "cache only)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many identical tokens to every "
                         "synthetic prompt")
    ap.add_argument("--gather-chunk", choices=["dense", "fused"],
                    default=None,
                    help="override the plan's chunked-prefill page access: "
                         "'dense' gathers the full (B, NB*PS) KV view per "
                         "chunk step, 'fused' runs the fused chunk kernel "
                         "over the pool in place")
    ap.add_argument("--decode-group", choices=["off", "grouped"],
                    default=None,
                    help="override the plan's decode discipline: 'grouped' "
                         "reads each shared prefix once per group of slots "
                         "(paged cache with --prefix-sharing)")
    ap.add_argument("--decode-fusion", choices=["split", "fused", "looped"],
                    default=None,
                    help="override the plan's decode-layer granularity: "
                         "'fused' = four fused stage kernels per layer, "
                         "'looped' = the fused step replayed as one CUDA "
                         "graph per tick")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host-memory tier capacity in KV pages: "
                         "preemption and retirement demote pages here "
                         "instead of discarding them (paged cache + "
                         "--prefix-sharing only); returning prompts "
                         "promote them back")
    ap.add_argument("--session-cache", action="store_true",
                    help="retain finished conversations' KV pages in the "
                         "session cache (implied by --host-pages; alone it "
                         "keeps them on the device only)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="resubmit every prompt this many times: rounds 2 "
                         "and on are returning conversations")
    ap.add_argument("--weight-dtype", choices=["bf16", "int8", "fp8"],
                    default=None,
                    help="GEMM weight storage: int8 / fp8 codes with one "
                         "f32 step per output channel, quantized at load "
                         "(default: the plan's matmul.weight_dtype, bf16)")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8", "fp8"],
                    default=None,
                    help="KV page storage (paged cache only): int8 / fp8 "
                         "codes with one f32 step per (page, kv head) "
                         "(default: the plan's paged.kv_dtype, bf16)")
    ap.add_argument("--plan", default=None,
                    help="serve with this tuned plan (strict load: its "
                         "provenance must match the config and the card); "
                         "with --tune, where the tuned plan is saved")
    ap.add_argument("--tune", action="store_true",
                    help="tune a plan first (wallclock GEMM timings on the "
                         "card, the analytical models under --device cpu), "
                         "save it to --plan or plans_torch/<arch>-<hw>.json "
                         "and serve with it")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, hardware
    from repro_torch.core import plan as plan_mod
    from repro_torch.device import resolve
    from repro_torch.models.api import get_model
    from repro_torch.models.kvlayout import pages_for
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    dev = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(gen, device=dev)
    plan = None
    if args.tune:
        # the wallclock measure raises without CUDA; on the CPU the
        # analytical models stand in, and the provenance says which
        measure = "analytical" if dev.type == "cpu" else "wallclock"
        plan = plan_mod.tune(cfg, hardware.DEFAULT, measure=measure)
        path = plan.save(args.plan or plan_mod.default_plan_path(cfg))
        print(f"tuned ({measure}) -> {path}: {plan.describe()}")
    elif args.plan:
        plan = plan_mod.ExecutionPlan.load(args.plan, cfg=cfg,
                                           spec=hardware.DEFAULT)
        print(f"plan {args.plan}: {plan.describe()}")
    over = {k: v for k, v in (("gather_chunk", args.gather_chunk),
                              ("decode_group", args.decode_group))
            if v is not None}
    if over:
        base = plan or plan_mod.DEFAULT_PLAN
        plan = dataclasses.replace(base, paged=dataclasses.replace(
            base.paged, **over))
    num_pages = args.num_pages
    if num_pages is None and args.cache_kind == "paged":
        worst = args.slots * pages_for(args.max_seq, args.page_size)
        num_pages = max(int(worst * args.overcommit), 1)
    eng = Engine(cfg, params, num_slots=args.slots, max_seq=args.max_seq,
                 cache_kind=args.cache_kind, page_size=args.page_size,
                 num_pages=num_pages, prefill_chunk=args.prefill_chunk,
                 prefix_sharing=args.prefix_sharing,
                 host_pages=args.host_pages,
                 session_cache=args.session_cache or None,
                 scheduler=args.scheduler, plan=plan,
                 decode_fusion=args.decode_fusion,
                 weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
                 seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    sp = SamplingParams(max_new_tokens=args.max_new,
                        temperature=args.temperature, top_p=args.top_p)
    header = rng.integers(1, cfg.vocab_size,
                          size=args.shared_prefix).astype(np.int32)
    reqs = [(np.concatenate([header, rng.integers(
        1, cfg.vocab_size, size=args.prompt_len).astype(np.int32)]), sp)
        for _ in range(args.requests)]

    t0 = time.perf_counter()
    out = {}
    served = total = 0                # over every round, as dt and ticks
    for rnd in range(max(args.rounds, 1)):
        out = eng.run(reqs)
        served += len(out)
        total += sum(len(v) for v in out.values())
        if rnd + 1 < args.rounds:
            eng.evict_finished()      # the KV stays in the session cache
    dt = time.perf_counter() - t0
    st = eng.stats
    tick_ms = 1e3 * st.decode_seconds / max(eng.ticks, 1)
    line = (f"served {served} requests, {total} tokens in {dt:.2f}s "
            f"({total / dt:.1f} tok/s, {eng.ticks} decode ticks, "
            f"{tick_ms:.2f} ms/tick, prefill {st.prefill_seconds:.2f}s, "
            f"{eng.scheduler.name} scheduler, device={dev}, "
            f"fusion={eng.decode_fusion}, weights={eng.weight_dtype} "
            f"({eng._weight_bytes_per_tick} B/tick, "
            f"{st.weight_bytes_decode_read} decode weight bytes read)")
    if eng.decode_fusion == "looped":
        line += f", graphs={st.graph_captures}/{st.graph_replays}"
    if eng.pool is not None:
        line += (f", {st.preemptions} preemptions, peak pages "
                 f"{st.peak_pages_used}/{eng.pool.num_pages}")
        line += (f", kv={eng.kv_dtype} ({st.kv_page_bytes} B/page, "
                 f"{st.kv_bytes_decode_read} decode KV bytes read)")
    if args.prefix_sharing:
        line += (f", {st.shared_prefix_pages} shared pages, "
                 f"{st.saved_prefill_tokens} prefill tokens saved, "
                 f"{st.cow_forks} COW forks")
    if st.grouped_requests:
        line += (f", {st.grouped_requests} grouped decodes, "
                 f"{st.prefix_kv_bytes_saved} prefix KV bytes saved")
    if eng.tiers is not None:
        line += (f", {st.demoted_pages} pages demoted, "
                 f"{st.promoted_pages} promoted, {st.session_hits} session "
                 f"hits")
        if st.host_evicted_pages:
            line += f", {st.host_evicted_pages} evicted"
    print(line + ")")
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]} [{eng.finish_reason(rid)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
