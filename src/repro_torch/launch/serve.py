"""End-to-end serving CLI (continuous batching over synthetic requests)
for the port, on the dense slot cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4 --max-seq 1024 --max-new 32 --prompt-len 128

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
the kernels' plain versions on the CPU (use ``--smoke`` there). Weights
are random, drawn from ``--seed`` with the JAX package's init
distributions. ``--prefill-chunk 0`` prefills each admission wave in one
padded call through flash prefill attention instead of 64-token chunks.
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
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="chunked-prefill chunk size; 0 = one padded "
                         "prefill call per admission wave")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.device import resolve
    from repro_torch.models.api import get_model
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    dev = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init_params(gen, device=dev)
    eng = Engine(cfg, params, num_slots=args.slots, max_seq=args.max_seq,
                 prefill_chunk=args.prefill_chunk, seed=args.seed,
                 device=dev)
    rng = np.random.default_rng(args.seed)
    sp = SamplingParams(max_new_tokens=args.max_new,
                        temperature=args.temperature)
    reqs = [(rng.integers(1, cfg.vocab_size,
                          size=args.prompt_len).astype(np.int32), sp)
            for _ in range(args.requests)]

    t0 = time.perf_counter()
    out = eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    st = eng.stats
    tick_ms = 1e3 * st.decode_seconds / max(eng.ticks, 1)
    print(f"served {len(out)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {eng.ticks} decode ticks, "
          f"{tick_ms:.2f} ms/tick, prefill {st.prefill_seconds:.2f}s, "
          f"{eng.scheduler.name} scheduler, device={dev})")
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]} [{eng.finish_reason(rid)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
