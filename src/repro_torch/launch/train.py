"""End-to-end trainer CLI of the port, on one device or a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --devices 4 --mesh 2x2 --steps 3

Runs on the card by default (``--device cuda``); ``--device cpu`` trains
on the CPU (use ``--smoke`` there: the reduced same-family config).
Without ``--smoke`` the full published config is built, its weights drawn
from ``--seed``. The step runs the ``"torch"`` plan: library GEMMs and
the reference attention math, whose backward passes autograd provides
(the hand-written kernels are forward-only).

**A mesh.** ``--devices N`` trains on N ranks, each a process of its own:
this command starts them as subprocesses of itself (``--rank`` / the
``--world`` / ``--init-file`` they are given are theirs only) and waits
for them; rank 0 prints. ``--mesh DxM`` is (data, model), ``PxDxM``
(pod, data, model); without it the JAX CLI's (max(N // 2, 1), min(2, N)),
and ``--mesh`` alone implies N. Params are sharded TP over ``model`` and
FSDP over the batch axes (``training/train_state.py``);
``--grad-compression int8_ef`` on a mesh with a ``pod`` axis sends the
gradients across pods as int8 codes with error feedback. The process
groups follow ``--device``: NCCL on ``cuda`` (one card a rank, rank r on
``cuda:r``), gloo on ``cpu``; ``--backend gloo`` with ``--device cuda``
puts ranks that share a card on it (rank r on ``cuda:r % cards``).
Nothing falls back to another backend by itself. Every family trains on
every mesh; MoE routes over ``data``-size groups (``moe_groups``), each
rank its own where they divide.

Fault tolerance is live here: SIGTERM checkpoints and exits 0 (on a
mesh, the command passes it to every rank, and the ranks agree to stop);
rerunning the same command resumes from the latest committed step, at
the same or another mesh.
"""
import argparse
import datetime
import os
import sys
import tempfile

# seconds a rank waits in a collective before its process group gives up
GROUP_TIMEOUT_S = 600


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
                    help="N ranks in a mesh (data, model)")
    ap.add_argument("--mesh", default="",
                    help="mesh as DATAxMODEL or PODxDATAxMODEL, e.g. 2x2")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the process groups' backend (default: NCCL on "
                    "cuda, gloo on cpu)")
    # one rank of a mesh run, as the parent starts it
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default="", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def mesh_dims(args) -> list:
    """The mesh shape the flags ask for ([] without a mesh)."""
    dims = [int(x) for x in args.mesh.split("x") if x]
    if not dims and args.devices:
        dims = [max(args.devices // 2, 1), min(2, args.devices)]
    if dims and len(dims) not in (2, 3):
        raise ValueError(f"--mesh {args.mesh}: DxM or PxDxM")
    n = 1
    for d in dims:
        n *= d
    if args.devices and dims and n != args.devices:
        raise ValueError(f"--mesh {args.mesh} has {n} ranks, --devices "
                         f"{args.devices}")
    return dims


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    from repro_torch import configs

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = configs.smoke(cfg)
    dims = mesh_dims(args)
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    world = 1
    for d in dims:
        world *= d
    if not dims or args.rank is not None:
        return _train(args, cfg, dims, names)
    if world > 1:
        return _spawn(sys.argv[1:] if argv is None else list(argv), world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        args.rank, args.world = 0, 1
        args.init_file = os.path.join(tmp, "store")
        return _train(args, cfg, dims, names)


def _spawn(argv: list, world: int) -> int:
    """This command once a rank, each a subprocess (``mesh.run_ranks``:
    SIGTERM / SIGINT go on to every rank, a rank that fails stops the
    others). Returns the first nonzero exit code, else 0."""
    import repro_torch
    from repro_torch.launch.mesh import run_ranks

    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        init = os.path.join(tmp, "store")
        codes = run_ranks(
            [[sys.executable, "-m", "repro_torch.launch.train", *argv,
              "--rank", str(r), "--world", str(world), "--init-file", init]
             for r in range(world)], env=env)
    return next((c for c in codes if c != 0), 0)


def run_config(args):
    """The ``RunConfig`` of the parsed flags."""
    from repro_torch.config import RunConfig

    return RunConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        microbatch=args.microbatch,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        grad_compression=args.grad_compression,
        seed=args.seed,
        warmup_steps=max(args.steps // 20, 1),
    )


def _train(args, cfg, dims: list, names: tuple) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import backend_for, make_mesh_from_config
    from repro_torch.models.api import get_model
    from repro_torch.training.loop import train_loop
    from repro_torch.training.train_state import (initial_state,
                                                  make_train_step, mesh_setup)

    rank = args.rank or 0
    dev = torch.device(args.device)
    if dims and dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend_for(dev, args.backend) == "nccl" and args.world > cards:
            raise ValueError(f"NCCL needs one card a rank: {args.world} "
                             f"ranks, {cards} cards (--backend gloo shares "
                             "one)")
        dev = torch.device("cuda", rank % max(cards, 1))
    dev = resolve(dev)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = run_config(args)
    api = get_model(cfg)
    mesh = None
    if dims:
        dist.init_process_group(
            backend_for(dev, args.backend),
            init_method=f"file://{args.init_file}", rank=rank,
            world_size=args.world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        if dims:
            mesh = make_mesh_from_config(MeshConfig(tuple(dims), names),
                                         device=dev, backend=args.backend)
        ctx, rules, specs = mesh_setup(api, mesh, run.grad_compression)
        step = make_train_step(api, ctx, run, mesh=mesh)

        def init_state():
            gen = torch.Generator(device=dev).manual_seed(run.seed)
            return initial_state(api.init_params(gen, device=dev), run,
                                 mesh, specs)

        res = train_loop(model_cfg=cfg, shape=shape, run=run,
                         train_step=step, init_state=init_state, device=dev,
                         mesh=mesh, rules=rules, specs=specs,
                         log_every=args.log_every)
    finally:
        if dims:
            dist.destroy_process_group()
    if rank == 0:
        times = sorted(res.step_times)
        losses = (f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
                  f"median step {1e3 * times[len(times) // 2]:.1f} ms"
                  if res.losses else "no step run")
        print(f"finished at step {res.final_step} "
              f"(restored_from={res.restored_from}, "
              f"preempted={res.preempted}); {losses}; "
              f"slow_steps={res.slow_steps}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
