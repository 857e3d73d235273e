"""φ calibration workflow (paper Fig. 5) on the port: collect attention-logit
statistics over calibration batches, derive the unified max value and its
safe band, and show the OPT-style disable path for wide-ranged models.

    PYTHONPATH=src python examples/calibrate_phi_torch.py --device cpu
    PYTHONPATH=src python examples/calibrate_phi_torch.py   # on the card

Runs the reduced (--smoke) qwen2-0.5b unless ``--full`` is given.
"""
import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.core import phi as phi_mod
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.models.layers import LayerCtx


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width qwen2-0.5b instead of its smoke config")
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = configs.get("qwen2-0.5b")
    if not args.full:
        cfg = configs.smoke(cfg)
    ctx = LayerCtx(cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_model(cfg).init_params(gen, device=dev)
    p0 = {k: {n: t[0] for n, t in v.items()}
          for k, v in params["layers"].items()}

    # run a few calibration batches through layer-0 QK to collect stats
    stats = phi_mod.LogitStats()
    for i in range(args.batches):
        g = torch.Generator(device=dev).manual_seed(1 + i)
        tokens = torch.randint(1, cfg.vocab_size, (2, 128), generator=g,
                               device=dev)
        x = L.embed(ctx, params, tokens)
        h = L.norm(cfg, p0["attn_norm"], x)
        positions = torch.arange(x.shape[1], device=dev).expand(
            x.shape[0], -1)
        q, k, _ = L.attention_qkv(ctx, p0["attn"], h, positions)
        stats = phi_mod.collect_attention_logit_stats(q, k, stats=stats)

    print(f"logit stats over {stats.count} samples: "
          f"mean={stats.mean:+.3f} std={stats.std:.3f} "
          f"range=[{stats.minimum:+.2f}, {stats.maximum:+.2f}]")
    cal = phi_mod.calibrate(stats)
    print(f"calibrated: phi={cal.phi:+.3f} band=({cal.band[0]:+.1f}, "
          f"{cal.band[1]:+.1f}) active={cal.active}")

    # wire it into the model config — every attention op now runs async
    cfg_t1 = dataclasses.replace(cfg, softmax_phi=cal)
    print(f"model '{cfg_t1.name}' now runs T1 with phi={cal.phi:+.3f}")

    # the OPT case: a model whose logits are too wide -> T1 disabled
    wide = phi_mod.LogitStats().update(torch.tensor([-400.0, 0.0, 390.0]))
    opt_cal = phi_mod.calibrate(wide)
    print(f"wide-range model (OPT case): active={opt_cal.active} "
          "-> engine uses the synchronized scheme everywhere")
    return stats, cal, opt_cal


if __name__ == "__main__":
    main()
