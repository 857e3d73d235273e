"""The port's ExecutionPlan (repro_torch.core.plan): the analytical tuner
against the JAX package's, JSON round trips, provenance staleness,
overrides, and a CPU serve whose every ``ops.matmul`` call finds a tuned
entry (the repair of the reference's tuned-but-never-called shapes)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import plan as jplan
from repro_torch import configs as tconfigs
from repro_torch import hardware as thw
from repro_torch.core import dispatch as td
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import (
    DEFAULT_PLAN, ExecutionPlan, PlanError, StalePlanError, make_plan, tune,
)

from test_torch_dispatch import SPEC as TPU_LIKE

ARCHS = sorted(tconfigs.REGISTRY)
CFG = tconfigs.get("qwen2-0.5b")
TUNED = tune(CFG)
BACKENDS = {"cuda": "pallas", "torch": "xla"}


# ---------------------------------------------------------------------------
# Parity: the analytical tune knob for knob
# ---------------------------------------------------------------------------


def _parity(arch, backend, **kw):
    t = json.loads(tune(tconfigs.get(arch), TPU_LIKE, backend=backend,
                        **kw).to_json())
    j = json.loads(jplan.tune(jconfigs.get(arch),
                              backend=BACKENDS[backend], **kw).to_json())
    assert t["version"] == j["version"]
    for name, op in j["ops"].items():
        mine = dict(t["ops"][name])
        assert mine.pop("backend") == backend
        theirs = dict(op)
        assert theirs.pop("backend") == BACKENDS[backend]
        if name == "matmul":
            te, je = mine.pop("entries"), theirs.pop("entries")
            assert {k: te[k] for k in je} == je          # every shared entry
            extra = {tuple(int(x) for x in k.split(",")) for k in te} - {
                tuple(int(x) for x in k.split(",")) for k in je}
            called = {(s.k, s.n) for s in td.called_gemm_shapes(
                tconfigs.get(arch))}
            assert extra <= called                       # only called shapes
        assert mine == theirs, name
    tp, jp = t["provenance"], j["provenance"]
    assert tp["config"] == jp["config"] and tp["measure"] == jp["measure"]
    assert tp["hardware_name"] == TPU_LIKE.name
    assert (tp["backend"], jp["backend"]) == (backend, BACKENDS[backend])


@pytest.mark.parametrize("arch", ARCHS)
def test_analytical_tune_matches_reference(arch):
    _parity(arch, "cuda")


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(kv_dtype="fp8", weight_dtype="int8"),
                                dict(weight_dtype=None),
                                dict(decode_seq=1024, page_size=32)],
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama2-7b"])
def test_analytical_tune_matches_reference_knobs(arch, kw):
    _parity(arch, "torch", **kw)


# ---------------------------------------------------------------------------
# Round trip and staleness
# ---------------------------------------------------------------------------


def test_json_roundtrip_is_identity(tmp_path):
    assert ExecutionPlan.from_json(TUNED.to_json()) == TUNED
    path = TUNED.save(str(tmp_path / "p.json"))
    assert ExecutionPlan.load(path, cfg=CFG) == TUNED
    assert plan_mod.default_plan_path(CFG) == \
        "plans_torch/qwen2-0.5b-h100-sxm.json"
    assert TUNED.provenance.hardware == plan_mod.hardware_hash(thw.H100_SXM)


def test_load_rejects_wrong_hardware(tmp_path):
    path = TUNED.save(str(tmp_path / "p.json"))
    other = dataclasses.replace(thw.H100_SXM, name="h200-sxm", hbm_bw=4.8e12)
    with pytest.raises(StalePlanError, match="hardware"):
        ExecutionPlan.load(path, cfg=CFG, spec=other)
    # a re-measured fixed cost strands the plan too
    slower = dataclasses.replace(thw.H100_SXM, launch_s=thw.H100_SXM.launch_s
                                 * 2)
    with pytest.raises(StalePlanError, match="hardware"):
        ExecutionPlan.load(path, cfg=CFG, spec=slower)


def test_load_rejects_wrong_config(tmp_path):
    path = TUNED.save(str(tmp_path / "p.json"))
    with pytest.raises(StalePlanError, match="config"):
        ExecutionPlan.load(path, cfg=tconfigs.smoke(CFG))


def test_load_rejects_wrong_version(tmp_path):
    doc = json.loads(TUNED.to_json())
    doc["version"] = plan_mod.PLAN_VERSION + 1
    p = tmp_path / "p.json"
    p.write_text(json.dumps(doc))
    with pytest.raises(StalePlanError, match="version"):
        ExecutionPlan.load(str(p), cfg=CFG)


def test_load_rejects_unprovenanced_unless_lax(tmp_path):
    path = make_plan().save(str(tmp_path / "hand.json"))
    with pytest.raises(StalePlanError, match="provenance"):
        ExecutionPlan.load(path, cfg=CFG)
    assert ExecutionPlan.load(path, strict=False) == make_plan()
    # lax loading skips the hashes too
    other = dataclasses.replace(thw.H100_SXM, name="other")
    p2 = TUNED.save(str(tmp_path / "p.json"))
    assert ExecutionPlan.load(p2, cfg=tconfigs.smoke(CFG), spec=other,
                              strict=False) == TUNED


def test_bad_knob_values_rejected():
    with pytest.raises(PlanError):
        plan_mod.AttentionDecodePlan(scheme="bogus")
    with pytest.raises(PlanError):
        plan_mod.MatmulPlan(backend="pallas")
    with pytest.raises(PlanError):
        plan_mod.AttentionDecodePlan(block_k=0)
    with pytest.raises(PlanError):
        plan_mod.AttentionPrefillPlan(chunk_threshold=-1)
    with pytest.raises(PlanError):
        ExecutionPlan.from_json("{not json")


@pytest.mark.parametrize("mutate", [
    lambda d: d["ops"]["attention_decode"].__setitem__("block_k", 0),
    lambda d: d["ops"]["matmul"].__setitem__("backend", "xla"),
    lambda d: d["ops"]["matmul"]["entries"].__setitem__("896", {"m1": 1}),
    lambda d: d["ops"]["matmul"]["entries"].__setitem__(
        "896,896", {"m1": 9, "m2": 3}),
    lambda d: d["ops"]["paged"].__setitem__("kv_dtype", "int3"),
    lambda d: d["ops"]["paged"].__setitem__("surprise", 1),
    lambda d: d["ops"].__delitem__("fused_ffn"),
    lambda d: d["ops"].__setitem__("matmul", []),
    lambda d: d.__setitem__("provenance", {"backend": "cuda", "hw": "x"}),
], ids=["block_k", "backend", "entry_key", "inverted", "kv_dtype",
        "unknown_knob", "missing_op", "matmul_list", "provenance"])
def test_malformed_document_stays_inside_plan_error(mutate):
    doc = json.loads(TUNED.to_json())
    mutate(doc)
    with pytest.raises(PlanError):
        ExecutionPlan.from_json(json.dumps(doc))


def test_with_overrides_maps_shared_knobs():
    p = TUNED.with_overrides(backend="torch", fallback=False, scheme="sync")
    assert p.attention_decode.fallback is False
    assert p.attention_prefill.scheme == "sync"
    assert p.paged.scheme == "sync"
    assert p.fused_ffn.fused is False        # the fused kernel is cuda's
    assert p.matmul.backend == "torch" and p.decode_fusion.backend == "torch"
    assert p.matmul.entries == TUNED.matmul.entries   # decisions survive
    assert p.decode_fusion.granularity == TUNED.decode_fusion.granularity
    assert TUNED.fused_ffn.fused is True
    assert TUNED.with_overrides(backend="cuda").fused_ffn.fused is True
    assert TUNED.with_overrides(block_k=128).attention_decode.block_k == 128
    assert TUNED.with_overrides() == TUNED


def test_describe_names_every_decision():
    s = TUNED.describe()
    for part in ("matmul[", "decode[", "prefill[", "ffn[fused]",
                 "paged[cuda/fused", "fusion["):
        assert part in s
    assert "w=int8" in tune(CFG, weight_dtype="int8").describe()


# ---------------------------------------------------------------------------
# make_plan, tune's options
# ---------------------------------------------------------------------------


def test_make_plan_takes_every_knob():
    p = make_plan("torch", scheme="sync", fallback=False, block_k=128,
                  chunk_threshold=1024, chunk_block=32, swap_threshold=3)
    assert (p.attention_decode.scheme, p.attention_decode.fallback,
            p.attention_decode.block_k) == ("sync", False, 128)
    assert (p.attention_prefill.scheme, p.attention_prefill.fallback,
            p.attention_prefill.chunk_threshold) == ("sync", False, 1024)
    assert (p.paged.scheme, p.paged.fallback, p.paged.chunk_block,
            p.paged.swap_threshold) == ("sync", False, 32, 3)
    assert p.fused_ffn.fused is False and make_plan().fused_ffn.fused
    assert make_plan() == dataclasses.replace(
        DEFAULT_PLAN, fused_ffn=plan_mod.FusedFFNPlan(fused=True))


def test_make_plan_refuses_the_cost_model_pick_and_tune_takes_it():
    with pytest.raises(PlanError, match="tune"):
        make_plan(weight_dtype=None)
    picked = tune(CFG, weight_dtype=None).matmul.weight_dtype
    assert picked == td.find_weight_dtype(CFG) == "int8"


def test_tune_measures_and_provenance():
    calls = []

    def measure(impl, m, k, n):
        calls.append((k, n))
        return td.predict_time(impl, m, k, n)

    p = tune(CFG, measure=measure)
    assert p.provenance.measure == "custom"
    assert p.matmul.entries == TUNED.matmul.entries
    assert {(s.k, s.n) for s in plan_mod.tuned_gemm_shapes(CFG)} <= set(calls)
    assert TUNED.provenance.measure == "analytical"
    with pytest.raises(PlanError, match="measure"):
        tune(CFG, measure="stopwatch")
    with pytest.raises(PlanError):
        tune(CFG, backend="pallas")


def test_tune_wallclock_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the wallclock tune runs here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tune(CFG, measure="wallclock")


@pytest.mark.parametrize("arch", ARCHS)
def test_tuned_entries_cover_model_and_called_shapes(arch):
    cfg = tconfigs.get(arch)
    p = tune(cfg)
    for gs in td.model_gemm_shapes(cfg) + td.called_gemm_shapes(cfg):
        assert (gs.k, gs.n) in p.matmul.entries, gs
    order = {td.Impl.GEMV: 0, td.Impl.FLAT_GEMM: 1, td.Impl.XLA_DOT: 2}
    for k, n in list(p.matmul.entries) + [(17, 23)]:
        picks = [order[p.matmul.pick(m, k, n)] for m in range(1, 1100, 7)]
        assert picks == sorted(picks), (k, n)    # never down the ladder


def test_reference_fault_its_tuned_plan_misses_the_called_shapes():
    """The JAX package tunes its fused QKV / FFN-up shapes, which no
    layer passes to ops.matmul, and leaves the k / v and gate / up calls
    to the default ladder; the port's tune covers them."""
    ref = jplan.tune(jconfigs.get("qwen2-0.5b"))
    assert (896, 1152) in ref.matmul.entries
    assert (896, 9728) in ref.matmul.entries
    assert (896, 4864) not in ref.matmul.entries
    assert (896, 128) not in ref.matmul.entries
    with open("plans/qwen2-0.5b-tpu-v5e.json") as f:
        committed = json.load(f)["ops"]["matmul"]["entries"]
    assert "896,4864" not in committed and "896,128" not in committed
    assert (896, 4864) in TUNED.matmul.entries
    assert (896, 128) in TUNED.matmul.entries


# ---------------------------------------------------------------------------
# Serving under a tuned plan: tokens, and every GEMM call has an entry
# ---------------------------------------------------------------------------


def _serve(cfg, params, plan, monkeypatch=None, seen=None):
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import SamplingParams

    if monkeypatch is not None:
        real = ops.matmul

        def recording(x, w, *, plan=None):
            out = real(x, w, plan=plan)
            seen.add((x.shape[-1], out.shape[-1]))
            return out

        monkeypatch.setattr(ops, "matmul", recording)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).astype(np.int32)
               for n in (11, 70, 26)]
    eng = Engine(cfg, params, num_slots=2, max_seq=128, plan=plan,
                 device="cpu")
    return eng.run([(p, SamplingParams(max_new_tokens=5)) for p in prompts])


def test_serve_under_tuned_plan_calls_only_tuned_shapes(monkeypatch):
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(tconfigs.smoke(CFG), param_dtype="float32",
                              activation_dtype="float32")
    params = get_model(cfg).init_params(device="cpu")
    tuned = tune(cfg, backend="torch")
    assert tuned.decode_fusion.granularity != "split"
    split = dataclasses.replace(tuned, decode_fusion=dataclasses.replace(
        tuned.decode_fusion, granularity="split"))
    want = _serve(cfg, params, make_plan("torch"))
    seen = set()
    assert _serve(cfg, params, tuned, monkeypatch, seen) == want
    assert _serve(cfg, params, split, monkeypatch, seen) == want
    assert seen <= set(tuned.matmul.entries)
    assert seen == {(s.k, s.n) for s in td.called_gemm_shapes(cfg)}


def test_serve_cli_tunes_saves_and_loads_strictly(tmp_path, capsys):
    from repro_torch.launch import serve

    path = str(tmp_path / "smoke.json")
    argv = ["--smoke", "--device", "cpu", "--requests", "2", "--slots", "2",
            "--max-seq", "96", "--max-new", "3", "--prompt-len", "20"]
    assert serve.main(argv + ["--tune", "--plan", path]) == 0
    tuned_out = capsys.readouterr().out
    assert "tuned (analytical)" in tuned_out
    saved = ExecutionPlan.load(path, cfg=tconfigs.smoke(CFG))
    assert saved.provenance.measure == "analytical"
    assert serve.main(argv + ["--plan", path]) == 0
    loaded_out = capsys.readouterr().out
    reqs = [line for line in tuned_out.splitlines() if "req " in line]
    assert reqs and reqs == [line for line in loaded_out.splitlines()
                             if "req " in line]
    with pytest.raises(StalePlanError, match="config"):
        serve.main(argv + ["--arch", "llama2-7b", "--plan", path])
