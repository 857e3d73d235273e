"""Quickstart on the port: the paper's three techniques through the
public API of ``repro_torch``.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card every op launches its hand-written kernel at qwen2-0.5b's
published widths; on the CPU (smoke widths) each runs its plain version.
Exits 1 if a kernel strays past its tolerance.
"""
import argparse
import sys

import torch

from repro_torch import configs
from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core import plan as plan_mod
from repro_torch.device import resolve
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flat_gemm import flat_gemm

ATTN_TOL = 2e-2      # bf16 output rounding of values ~1
GEMM_REL = 2e-2      # bf16 products against the f32 ones, relative


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = configs.get("qwen2-0.5b")
    if dev.type == "cpu":
        cfg = configs.smoke(cfg)
    plan = plan_mod.make_plan("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    # -- T1: asynchronized softmax with a unified max value ----------------
    print("== T1: unified-max decode attention ==")
    b, hq, hk, d = 4, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 2048 if dev.type == "cuda" else 256
    q, k_cache, v_cache = randn(b, hq, d), randn(b, s, hk, d), randn(
        b, s, hk, d)
    lengths = torch.tensor([s // 3, s // 2, s - 1, s], dtype=torch.int32,
                           device=dev)
    phi_cfg = SoftmaxPhiConfig(phi=0.0, band=(-40.0, 40.0))  # calibrated φ
    out = ops.attention_decode(q, k_cache, v_cache, lengths,
                               phi_cfg=phi_cfg, plan=plan)
    want = ref.attention_decode_ref(q.float(), k_cache.float(),
                                    v_cache.float(), lengths)
    err = (out.float() - want).abs().max().item()
    print(f"   async == sync result, max |Δ| = {err:.2e} "
          f"(tol {ATTN_TOL:.0e}; B={b} HQ={hq} HK={hk} D={d} S={s})")
    ok &= err <= ATTN_TOL

    # -- T2: flat GEMM with no M padding -----------------------------------
    print("== T2: flat GEMM at a decode batch's M ==")
    m, kk, nn = 3, cfg.d_model, cfg.d_ff
    x, w = randn(m, kk), randn(kk, nn) * kk ** -0.5
    y = flat_gemm(x, w)
    want = x.float() @ w.float()
    rel = ((y.float() - want).abs().max() / want.abs().max()).item()
    print(f"   ({m}, {kk}) @ ({kk}, {nn}): max |Δ| / max |y| = {rel:.2e} "
          f"(tol {GEMM_REL:.0e}), out {tuple(y.shape)}")
    ok &= rel <= GEMM_REL

    # -- T3: heuristic dataflow — offline table, runtime lookup ------------
    print(f"== T3: tuned execution plan ({cfg.name}) ==")
    tuned = plan_mod.tune(cfg)
    for (k_, n_), e in sorted(tuned.matmul.entries.items()):
        print(f"   [K={k_:>6}, N={n_:>6}]  M1={e.m1:<4} M2={e.m2:<4} "
              "(M<M1: GEMV, M<M2: flat GEMM, else the library GEMM)")
    impl = tuned.matmul.pick(4, cfg.d_model, cfg.q_dim)
    print(f"   decode batch 4 routes the q projection to {impl.value}")
    print(f"   plan: {tuned.describe()}")
    print(f"   round-trips: "
          f"{plan_mod.ExecutionPlan.from_json(tuned.to_json()) == tuned}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
