"""Streaming generation and a mid-flight abort through the port's engine:
``generate()`` yields one ``TokenEvent`` per emitted token (the engine
keeps batching every other resident request between yields), and
``abort(rid)`` cancels a request in any phase, releasing its slot and
pages at once.

    PYTHONPATH=src python examples/streaming_serve_torch.py           # card
    PYTHONPATH=src python examples/streaming_serve_torch.py --device cpu

qwen2-0.5b at its published widths on the card (random weights from seed
0), its smoke config on the CPU, over the paged pool.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve
from repro_torch.models.api import get_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import FinishReason, SamplingParams


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
    eng = Engine(cfg, params, num_slots=2, max_seq=256, cache_kind="paged",
                 page_size=64, scheduler="fcfs", device=dev)

    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
    # a background request sharing the batch with the streamed one
    victim = eng.submit(
        rng.integers(1, cfg.vocab_size, size=40).astype(np.int32),
        SamplingParams(max_new_tokens=64))

    print("streaming request (greedy, 12 tokens):")
    events = []
    for ev in eng.generate(prompt, SamplingParams(max_new_tokens=12)):
        events.append(ev)
        print(f"  token[{ev.index}] = {ev.token}"
              + (f"  <{ev.finish_reason}>" if ev.finished else ""))
        if ev.index == 5:
            # cancel the background request mid-decode: its slot and pages
            # free at once; the stream continues unaffected
            if not eng.abort(victim):
                print(f"  could not abort request {victim}")
                return 1
            print(f"  (aborted background request {victim}: "
                  f"{eng.finish_reason(victim)})")

    bg = eng.requests[victim]
    print(f"background request generated {bg.generated} tokens before "
          f"abort; stats: {eng.stats}")
    done = (len(events) == 12 and events[-1].finished
            and eng.finish_reason(victim) == FinishReason.ABORT)
    return 0 if done else 1


if __name__ == "__main__":
    sys.exit(main())
