"""The port's analysis modules (``repro_torch.analysis.roofline`` and
``.cost``) and ``hardware.matmul_flops`` / ``bytes_of``, on the CPU.

The roofline cases of ``tests/test_analysis.py`` (exact extrapolation,
bottleneck attribution, train against decode model FLOPs, the table) run
on ``hardware.H100_SXM``, and the JAX package's roofline gives the same
output on the same ``ProbeCost`` when its spec carries the same peaks.
The counter's cases are exact: a matmul counts 2mnk FLOPs and its input
plus output bytes, an add one FLOP an element, a view nothing; a known
sequence of allocations gives its peak; one ``all_reduce`` and one
``all_gather_into_tensor`` under a one-process gloo group give their
bytes and counts by kind.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import hardware as jhardware
from repro.analysis import roofline as jroofline
from repro_torch import configs, hardware
from repro_torch.analysis import roofline
from repro_torch.analysis.cost import CostCounter
from repro_torch.config import applicable_shapes

# the JAX package's spec with the H100's peaks: its roofline then divides
# by the same three rates as the port's
JAX_H100 = dataclasses.replace(
    jhardware.DEFAULT, name="h100-sxm",
    peak_flops_bf16=hardware.H100_SXM.peak_flops_bf16,
    hbm_bw=hardware.H100_SXM.hbm_bw, ici_bw_per_link=roofline.NVLINK_BW)


def both_terms(cost_args, **kw):
    """The port's terms and the JAX package's on the same probe cost."""
    t = roofline.terms_from(cost=roofline.ProbeCost(*cost_args), **kw)
    j = jroofline.terms_from(cost=jroofline.ProbeCost(*cost_args),
                             spec=JAX_H100, **kw)
    return t, j


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_linear_extrapolation_exact():
    rows = [(1, 100.0, 50.0, 7.0), (3, 160.0, 90.0, 13.0)]
    full = roofline.extrapolate([roofline.ProbeCost(*r) for r in rows], 10)
    # per-layer: 30 flops, 20 bytes, 3 coll; outside: 70, 30, 4
    np.testing.assert_allclose(full.flops, 70 + 300)
    np.testing.assert_allclose(full.bytes_accessed, 30 + 200)
    np.testing.assert_allclose(full.collective_bytes, 4 + 30)
    want = jroofline.extrapolate([jroofline.ProbeCost(*r) for r in rows], 10)
    assert dataclasses.asdict(full) == dataclasses.asdict(want)


def test_extrapolation_clamps_collectives_as_the_jax_package():
    # a falling collective slope clamps to 0 (the intercept stays)
    rows = [(1, 10.0, 10.0, 50.0), (3, 30.0, 20.0, 10.0)]
    full = roofline.extrapolate([roofline.ProbeCost(*r) for r in rows], 8)
    want = jroofline.extrapolate([jroofline.ProbeCost(*r) for r in rows], 8)
    assert full.collective_bytes == 50.0
    assert dataclasses.asdict(full) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        roofline.extrapolate([roofline.ProbeCost(*rows[0])], 8)


def test_terms_bottleneck_attribution():
    kw = dict(arch="a", shape="s", mesh="1", chips=256)
    t, j = both_terms((1, 1e15, 1e9, 1e6), model_flops=5e14, **kw)
    assert t.bottleneck == "compute"
    assert abs(t.useful_ratio - 0.5) < 1e-9
    assert t.to_dict() == j.to_dict()
    t, j = both_terms((1, 1e9, 1e9, 1e12), model_flops=1e9, **kw)
    assert t.bottleneck == "collective"
    assert t.bound_s == t.collective_s
    assert t.to_dict() == j.to_dict()
    t, j = both_terms((1, 1e9, 1e12, 0.0), model_flops=1e9, **kw)
    assert t.bottleneck == "memory"
    assert t.memory_s == 1e12 / (256 * 3.35e12)
    assert t.to_dict() == j.to_dict()


def test_terms_default_to_the_h100():
    t = roofline.terms_from(arch="a", shape="s", mesh="1", chips=1,
                            cost=roofline.ProbeCost(1, 989e12, 3.35e12,
                                                    450e9),
                            model_flops=1.0)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)


def test_bound_is_the_larger_term():
    spec = hardware.H100_SXM
    for nbytes, flops in ((1e9, 1e9), (1e6, 1e13), (3.35e9, 989e9)):
        s, by = roofline.bound(nbytes, flops)
        t_b, t_o = nbytes / spec.hbm_bw, flops / spec.peak_flops_bf16
        assert s == max(t_b, t_o)
        assert by == ("bytes" if t_b >= t_o else "operations")


def test_model_flops_train_vs_decode():
    train = roofline.model_flops_estimate(
        params_active=int(1e9), tokens=1000, kind="train")
    decode = roofline.model_flops_estimate(
        params_active=int(1e9), tokens=1000, kind="decode")
    assert abs(train / decode - 3.0) < 1e-9  # 6ND vs 2ND
    kw = dict(params_active=int(5e8), tokens=4096, num_layers=24,
              d_model=896, num_kv_heads=2, head_dim=64, num_q_heads=14,
              kv_len=32768, seq_len=4096)
    for kind in ("train", "prefill", "decode"):
        assert (roofline.model_flops_estimate(kind=kind, **kw)
                == jroofline.model_flops_estimate(kind=kind, **kw))


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_model_flops_for_matches_the_roofline_report(arch):
    from benchmarks import roofline_report
    for shape in applicable_shapes(configs.get(arch)):
        assert (roofline.model_flops_for(configs.get(arch), shape)
                == roofline_report.model_flops_for(arch, shape.name))


def test_format_table_and_report_round_trip(tmp_path):
    kw = dict(arch="qwen2-0.5b", shape="train_4k", mesh="1", chips=1,
              model_flops=5e11, per_device_bytes=int(2e9))
    t, j = both_terms((1, 1e12, 1e10, 1e8), **kw)
    out = roofline.format_table([t.to_dict()])
    assert "qwen2-0.5b" in out and "compute" in out
    assert out == jroofline.format_table([j.to_dict()])
    path = str(tmp_path / "r.json")
    roofline.save_report(path, [t])
    assert roofline.load_report(path) == [t.to_dict()]


def test_matmul_flops_and_bytes_of():
    for m, n, k in ((1, 896, 4864), (128, 151936, 896), (3, 5, 7)):
        assert hardware.matmul_flops(m, n, k) == 2 * m * n * k
        assert hardware.matmul_flops(m, n, k) == jhardware.matmul_flops(
            m, n, k)
    for shape, nb in (((24, 128, 32768, 2, 64), 2), ((7,), 4), ((), 1)):
        assert hardware.bytes_of(shape, nb) == jhardware.bytes_of(shape, nb)
    assert hardware.bytes_of((2, 3)) == 12


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_matmul(device):
    m, k, n = 5, 7, 11
    a = torch.ones((m, k), dtype=torch.bfloat16, device=device)
    b = torch.ones((k, n), dtype=torch.float32, device=device).to(
        torch.bfloat16)
    with CostCounter() as c:
        out = a @ b
    assert out.shape == (m, n)
    assert c.flops == 2 * m * n * k
    assert c.bytes_accessed == 2 * (m * k + k * n + m * n)


def test_counter_batched_matmul_and_add():
    a = torch.ones((3, 4, 5), device="meta")
    b = torch.ones((3, 5, 6), device="meta")
    with CostCounter() as c:
        torch.bmm(a, b)
    assert c.flops == 2 * 3 * 4 * 5 * 6
    x = torch.ones((6, 10), device="meta")
    y = torch.ones((6, 10), device="meta")
    with CostCounter() as c:
        x + y
    assert c.flops == 60
    assert c.bytes_accessed == 3 * 60 * 4


def test_counter_view_adds_nothing():
    x = torch.ones((6, 10), device="meta")
    with CostCounter() as c:
        v = x.view(10, 6).transpose(0, 1)[1:]
        x.reshape(60)
        x.unsqueeze(0).expand(3, 6, 10)
    assert v.shape == (5, 10)
    assert (c.flops, c.bytes_accessed, c.peak_bytes) == (0, 0, 0)


def test_counter_in_place_counts_no_new_output():
    x = torch.ones((8, 8), device="meta")
    y = torch.ones((8, 8), device="meta")
    with CostCounter() as c:
        x.add_(y)
    assert c.flops == 64
    assert c.bytes_accessed == 2 * 64 * 4      # both inputs, no output
    assert c.peak_bytes == 0


def test_counter_peak_of_known_allocations():
    mb = 2**20
    with CostCounter() as c:
        a = torch.empty(mb, dtype=torch.uint8, device="meta")
        b = torch.empty(2 * mb, dtype=torch.uint8, device="meta")
        view = b[:10]
        del b                                # its view keeps the storage
        gc.collect()
        assert c.live_bytes == 3 * mb
        del view
        gc.collect()
        assert c.live_bytes == mb
        d = torch.empty(4 * mb, dtype=torch.uint8, device="meta")
        assert c.peak_bytes == 5 * mb
        del a, d
        gc.collect()
        assert c.live_bytes == 0
    assert c.peak_bytes == 5 * mb


def test_counter_keeps_autograd_saved_storages():
    """exp saves its output for the backward pass: that storage stays
    counted after its name is gone, until backward frees the graph."""
    x = torch.empty(1000, device="meta", requires_grad=True)
    with CostCounter() as c:
        y = x.exp()
        loss = y.sum()
        del y
        gc.collect()
        assert c.live_bytes == 4000 + 4          # exp's output and the sum
        loss.backward()
        assert x.grad.shape == x.shape          # created here, still live
        del loss
        x.grad = None
        gc.collect()
    assert c.live_bytes == 0
    assert c.peak_bytes >= 8000                 # exp's output and the grad


def test_counter_collectives_under_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        x = torch.ones((8, 4))
        out = torch.empty((8, 4))
        with CostCounter() as c:
            dist.all_reduce(x)
            with c.scope("while_body"):
                dist.all_gather_into_tensor(out, x)
    finally:
        dist.destroy_process_group()
    stats = c.collectives
    assert stats.by_kind() == {"all-reduce": 128, "all-gather": 128}
    assert stats.counts == {"all-reduce": 1, "all-gather": 1}
    assert stats.total_bytes() == 256
    assert stats.total_bytes({"while": 10}) == 128 + 10 * 128
    assert (c.flops, c.bytes_accessed) == (0, 0)
