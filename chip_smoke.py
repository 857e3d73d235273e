#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds every kernel under ``src/repro_torch/csrc`` with nvcc (sm_90a).
2. Holds each kernel against its plain PyTorch version on the card at the
   full-width qwen2-0.5b shapes of the serving path, both softmax schemes,
   plus inputs scaled so that some s − φ > 40 (forcing the overflow
   recompute); times kernel, plain version and one library call with CUDA
   events (median of 25, L2 flushed before each launch) beside the
   card's least possible time (``bound_ms``).
3. Serves full-width qwen2-0.5b (24 layers, random weights from --seed),
   greedy, in three engine runs — 4 slots with chunked prefill, 1 slot,
   and ``prefill_chunk=0`` (flash prefill) — with every kernel's launch
   counter set to 0 just before and read just after each run.
4. Checks the logits of the first prefill and decode step against the
   ``"torch"`` plan (plain reference math) on the card, and counts the
   greedy tokens on which the two plans agree.
5. Prints the card's name and power limit, one JSON line describing every
   kernel, and as its last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.
Exits non-zero, printing no result line, without CUDA, outside the repo,
or when any check fails. Long output goes to ``chiprun_out/``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

ARCH = "qwen2-0.5b"
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
}
SOURCES = {
    "gemv": "src/repro_torch/csrc/gemv.cu",
    "flat_gemm": "src/repro_torch/csrc/flat_gemm.cu",
    "decode_attention_unified_max": "src/repro_torch/csrc/decode_attention.cu",
    "decode_attention_sync": "src/repro_torch/csrc/decode_attention.cu",
    "flash_prefill_unified_max": "src/repro_torch/csrc/flash_prefill.cu",
    "flash_prefill_sync": "src/repro_torch/csrc/flash_prefill.cu",
}


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
    t_bytes = nbytes / spec.hbm_bw
    t_ops = flops / spec.peak_flops_bf16
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer, rows, log):
    import torch.nn.functional as F

    from repro_torch import hardware
    from repro_torch.core.plan import DEFAULT_PLAN
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    from repro_torch.kernels.flat_gemm import flat_gemm, flat_gemm_plain
    from repro_torch.kernels.gemv import gemv, gemv_plain
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

    def attn_close(got, want):
        err = (got.float() - want.float()).abs().amax(-1)
        rms = want.float().pow(2).mean(-1).sqrt()
        ratio = (err / rms.clamp_min(1e-30)).max().item()
        return (bool((err <= ATTN_REL * rms).all()),
                f"tol per row {ATTN_REL} x RMS(row); worst {ratio:.4f} x RMS")

    def record(name, case, got, want, kern, plain, lib, nbytes, flops,
               primary, close):
        err = (got.float() - want.float()).abs().max().item()
        ok, tol = close(got, want)
        b_ms, b_by = bound_ms(nbytes, flops, spec)
        k_ms, p_ms = timer.ms(kern), timer.ms(plain)
        l_ms = timer.ms(lib) if lib is not None else None
        line = (f"kernel {name:30s} {case:34s} max_abs_err={err:.3e} "
                f"({tol}) "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"library_ms={'n/a' if l_ms is None else f'{l_ms:.4f}'} "
                f"bound_ms={b_ms:.4f} ({b_by}) "
                f"{'ok' if ok else 'MISMATCH'}")
        log(line)
        check(ok, f"{name} {case}: kernel disagrees with its plain version")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if primary:
            row.update(case=case, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=b_ms, bound_by=b_by)

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
            primary = "tied head" in case and m <= 4
            record(name, case, fn(xx, w), plain(xx, w),
                   lambda: fn(xx, w), lambda: plain(xx, w),
                   lambda: torch.matmul(xx, w),
                   2 * (m * k + k * n + m * n), 2 * m * k * n, primary,
                   gemm_close)

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
        record("flash_prefill_sync", tag, fp.flash_prefill_sync(q, k, v),
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


# ---------------------------------------------------------------------------
# phase 3-4: serving and logits
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import flat_gemm as fg
    from repro_torch.kernels import gemv as gv
    return {"gemv": gv.gemv, "flat_gemm": fg.flat_gemm,
            "decode_attention_unified_max": da.decode_attention_unified_max,
            "decode_attention_sync": da.decode_attention_sync,
            "flash_prefill_unified_max": fp.flash_prefill_unified_max,
            "flash_prefill_sync": fp.flash_prefill_sync}


def serve_phase(torch, cfg, params, requests, log, launches):
    from repro_torch.serving.engine import Engine

    # warm-up (allocator, library handles) so the first timed run is not
    # charged for one-time set-up; its launches are not counted
    Engine(cfg, params, num_slots=4, max_seq=1024, device="cuda").run(
        requests[:2])

    runs = [("slots=4 chunked prefill", dict(num_slots=4),
             ("flat_gemm", "decode_attention_unified_max",
              "decode_attention_sync")),
            ("slots=1 chunked prefill", dict(num_slots=1),
             ("gemv", "flat_gemm", "decode_attention_unified_max")),
            ("slots=4 prefill_chunk=0", dict(num_slots=4, prefill_chunk=0),
             ("flat_gemm", "flash_prefill_unified_max",
              "flash_prefill_sync"))]
    outputs = {}
    for tag, kw, expect in runs:
        eng = Engine(cfg, params, max_seq=1024, device="cuda", **kw)
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
        log(f"serve {tag}: {len(out)} requests, {total} tokens in "
            f"{dt:.3f}s = {total / dt:.1f} tok/s; {eng.ticks} decode ticks "
            f"at {1e3 * st.decode_seconds / max(eng.ticks, 1):.3f} ms/tick; "
            f"prefill {st.prefill_seconds:.3f}s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"launches {json.dumps(counts)}")
        for rid, toks in out.items():
            check(len(toks) == requests[rid][1].max_new_tokens,
                  f"{tag}: request {rid} produced {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"{tag}: request {rid} produced an out-of-vocab token")
            check(eng.finish_reason(rid).value == "length",
                  f"{tag}: request {rid} finished early")
        for n in expect:
            check(counts[n] > 0, f"{tag}: kernel {n} was never launched")
        outputs[tag] = out
    return outputs


def profile_phase(torch, cfg, params, requests, log):
    """Where a decode tick's time goes at 4 slots: 8 steady ticks timed
    on the host clock without the profiler, then 8 more under
    torch.profiler for the device busy time (sum of kernel times) and
    the costliest device kernels. The idle share is given against both
    walls: the profiled window's own (busy and wall from one window, the
    wall inflated by the profiler) and the unprofiled window's (adjacent
    ticks of the same engine, the wall a serving user sees)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    eng = Engine(cfg, params, num_slots=4, max_seq=1024, device="cuda")
    for p, _ in requests[:4]:
        eng.submit(p, SamplingParams(max_new_tokens=40))
    for _ in range(3):
        eng.step()                      # admission + prefill + warm ticks
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
    per_tick = {name: fn.launches / n for name, fn in counters().items()}
    log(f"profile slots=4 decode: kernel launches per tick "
        f"{json.dumps(per_tick)}")
    # device-side events only (the aten ops that launched them carry the
    # same time again as their own "self device" time)
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evs) / n
    if busy_us == 0:
        log("profile slots=4 decode: device time not measured (the "
            "profiler reported none)")
        return
    log(f"profile slots=4 decode ({n} ticks each window): device busy "
        f"{busy_us / 1e3:.3f} ms/tick; profiled wall {1e3 * wall:.3f} "
        f"ms/tick, device idle {100 * (1 - busy_us / 1e6 / wall):.1f}%; "
        f"unprofiled wall {1e3 * plain_wall:.3f} ms/tick, device idle "
        f"{100 * (1 - busy_us / 1e6 / plain_wall):.1f}%")
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"profile   {e.self_device_time_total / n / 1e3:8.4f} ms/tick "
            f"{e.count // n:5d} calls/tick  {e.key[:90]}")
    (OUT_DIR / "decode_profile.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))


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
    results = {}
    for name, plan in (("cuda", DEFAULT_PLAN), ("torch", torch_plan)):
        ctx = LayerCtx(cfg, plan)
        cache = api.init_cache(DenseLayout(4, 1024), device="cuda")
        with torch.no_grad():
            l1, cache = api.prefill_chunk(ctx, params, toks, chunk_lens,
                                          cache, zeros)
            nxt = results["cuda"][0][:, :cfg.vocab_size].argmax(-1) \
                if name == "torch" else l1[:, :cfg.vocab_size].argmax(-1)
            l2, cache = api.decode_step(ctx, params, nxt.int(), cache,
                                        chunk_lens)
            cache2 = api.init_cache(DenseLayout(4, 64), device="cuda")
            l3, _ = api.prefill(ctx, params, toks, chunk_lens, cache2)
        results[name] = (l1, l2, l3)
    worst = 0.0
    for i, what in enumerate(("first prefill chunk", "first decode step",
                              "one-shot prefill")):
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


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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

    timer = Timer(torch)
    rows = {}
    kernel_phase(torch, timer, rows, log)
    del timer

    cfg = configs.get(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = get_model(cfg).init_params(gen, device="cuda")
    rng = np.random.default_rng(args.seed)
    sp = SamplingParams(max_new_tokens=32)
    requests = [(rng.integers(1, cfg.vocab_size, size=int(n)).astype(
        np.int32), sp) for n in rng.integers(32, 301, size=8)]
    log("prompt lengths: " + str([len(p) for p, _ in requests]))
    launches = {}
    outputs = serve_phase(torch, cfg, params, requests, log, launches)
    profile_phase(torch, cfg, params, requests, log)
    logits_phase(torch, cfg, params, requests, log,
                 outputs["slots=4 chunked prefill"])

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
            "shape": r["case"]})
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
