"""End-to-end driver on the port: train a small (~25M-param) qwen2-family
model for a few hundred steps with the full substrate: deterministic data
pipeline, AdamW, async checkpoints, preemption-safe loop.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py --device cpu
    PYTHONPATH=src python examples/train_tiny_lm_torch.py   # on the card

Interrupt it (Ctrl-C) and run again with the same ``--ckpt``: it resumes
from the last checkpoint and the loss curve continues exactly where it
left off.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.device import resolve
from repro_torch.models.api import get_model
from repro_torch.models.layers import LayerCtx
from repro_torch.training.loop import train_loop
from repro_torch.training.train_state import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # ~25M params: the smoke config deepened a bit for a real-ish curve
    cfg = dataclasses.replace(
        configs.smoke(configs.get("qwen2-0.5b")),
        num_layers=4, d_model=256, d_ff=1024, vocab_size=8192,
        num_heads=8, num_kv_heads=2, head_dim=32,
    )
    print(f"model: {cfg.name}  params ~{cfg.param_count()/1e6:.1f}M")
    shape = ShapeConfig("tiny_train", seq_len=256, global_batch=8,
                        kind="train")
    run = RunConfig(
        learning_rate=3e-3, warmup_steps=20, total_steps=args.steps,
        checkpoint_every=100,
        checkpoint_dir=args.ckpt or tempfile.mkdtemp(prefix="repro_ex_"),
    )
    api = get_model(cfg)
    ctx = LayerCtx(cfg=cfg, plan=DEFAULT_PLAN.with_overrides(backend="torch"))
    step = make_train_step(api, ctx, run)

    res = train_loop(
        model_cfg=cfg, shape=shape, run=run, train_step=step,
        init_state=lambda: TrainState.create(api.init_params(
            torch.Generator(device=dev).manual_seed(0), device=dev)),
        device=dev, log_every=25,
    )
    print(f"\nloss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over "
          f"{len(res.losses)} steps "
          f"(resumed from {res.restored_from})")
    assert res.losses[-1] < res.losses[0], "loss must decrease"
    return res


if __name__ == "__main__":
    main()
