"""End-to-end training driver for the port, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 200 --batch 8 --seq 128

Runs on the card by default (``--device cuda``); ``--device cpu`` trains
on the CPU (use ``--smoke`` there: the reduced same-family config).
Without ``--smoke`` the full published config is built, its weights drawn
from ``--seed``. The step runs the ``"torch"`` plan: library GEMMs and
the reference attention math, whose backward passes autograd provides
(the hand-written kernels are forward-only).

Fault tolerance is live here: SIGTERM checkpoints and exits 0; rerunning
the same command resumes from the latest committed step. ``--devices``,
``--mesh`` and ``--grad-compression int8_ef`` need the sharded training
layer, which the port does not have yet (ROADMAP.md, slice 8b): they
raise.
"""
import argparse
import os
import sys
import tempfile


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0,
                    help="N devices in a (data, model) mesh (not yet "
                    "ported: raises)")
    ap.add_argument("--mesh", default="",
                    help="mesh as DATAxMODEL (not yet ported: raises)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    from repro_torch.training.train_state import NO_MESH
    if args.devices or args.mesh:
        raise ValueError(f"--devices / --mesh: a sharded run {NO_MESH}")
    if args.grad_compression != "none":
        raise ValueError(f"--grad-compression {args.grad_compression} "
                         f"{NO_MESH}")

    import torch

    from repro_torch import configs
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.device import resolve
    from repro_torch.models.api import get_model
    from repro_torch.models.layers import LayerCtx
    from repro_torch.training.loop import train_loop
    from repro_torch.training.train_state import TrainState, make_train_step

    dev = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = RunConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        microbatch=args.microbatch,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        seed=args.seed,
        warmup_steps=max(args.steps // 20, 1),
    )
    api = get_model(cfg)
    ctx = LayerCtx(cfg=cfg, plan=DEFAULT_PLAN.with_overrides(backend="torch"))
    step = make_train_step(api, ctx, run)

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        return TrainState.create(api.init_params(gen, device=dev))

    res = train_loop(model_cfg=cfg, shape=shape, run=run, train_step=step,
                     init_state=init_state, device=dev,
                     log_every=args.log_every)
    times = sorted(res.step_times)
    losses = (f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
              f"median step {1e3 * times[len(times) // 2]:.1f} ms"
              if res.losses else "no step run")
    print(f"finished at step {res.final_step} "
          f"(restored_from={res.restored_from}, preempted={res.preempted}); "
          f"{losses}; slow_steps={res.slow_steps}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
