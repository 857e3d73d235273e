"""Serve batched requests through the port's continuous-batching engine —
the paper's end-to-end inference scenario.

    PYTHONPATH=src python examples/serve_batch_torch.py               # card
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

qwen2-0.5b at its published widths on the card (random weights from seed
0), its smoke config on the CPU; the engine dispatches by a plan tuned
for the config (T3).
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.plan import tune
from repro_torch.device import resolve
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

NUM_REQUESTS = 12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = configs.get("qwen2-0.5b")
    if dev.type == "cpu":
        cfg = configs.smoke(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_model(cfg).init_params(gen, device=dev)
    eng = Engine(cfg, params, num_slots=4, max_seq=512, plan=tune(cfg),
                 device=dev)

    rng = np.random.default_rng(0)
    requests = [
        (rng.integers(1, cfg.vocab_size,
                      size=int(rng.integers(8, 120))).astype(np.int32),
         SamplingParams(max_new_tokens=16,
                        temperature=0.8 if i % 2 else 0.0,
                        top_k=20, top_p=0.95, seed=i))
        for i in range(NUM_REQUESTS)
    ]
    t0 = time.perf_counter()
    out = eng.run(requests)
    dt = time.perf_counter() - t0
    tok = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s, {eng.ticks} decode ticks, "
          f"{eng.num_slots} slots, {dev.type})")
    for rid in sorted(out)[:5]:
        print(f"  req {rid:>2}: {out[rid]} [{eng.finish_reason(rid)}]")
    return 0 if len(out) == NUM_REQUESTS and tok == 16 * NUM_REQUESTS else 1


if __name__ == "__main__":
    sys.exit(main())
