"""tools/check_plans_torch.py: the port's committed plans
(plans_torch/*.json) lint clean, and the linter catches each staleness
class it advertises. The JAX package's plans and linter are a separate
pair (tests/test_check_plans.py); neither reads the other's files."""
import json
import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import check_plans_torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402

PLANS = sorted(
    os.path.join(_ROOT, "plans_torch", p)
    for p in os.listdir(os.path.join(_ROOT, "plans_torch"))
    if p.endswith(".json")
)


def test_committed_plans_exist():
    assert PLANS, "plans_torch/ must ship tuned artifacts"


@pytest.mark.parametrize("path", PLANS, ids=os.path.basename)
def test_committed_plan_lints_clean(path):
    assert check_plans_torch.check_plan(path) == []


@pytest.mark.parametrize("path", PLANS, ids=os.path.basename)
def test_committed_plan_loads_strictly_and_was_timed(path):
    doc = json.load(open(path))
    cfg = configs.get(doc["provenance"]["config_name"])
    plan = plan_mod.ExecutionPlan.load(path, cfg=cfg)
    assert plan.provenance.measure == "wallclock"
    assert plan.provenance.backend == "cuda"
    for gs in plan_mod.tuned_gemm_shapes(cfg):
        assert (gs.k, gs.n) in plan.matmul.entries, gs
    # the analytical decisions are the analytical tune's on this spec
    fresh = plan_mod.tune(cfg)
    for op in ("attention_decode", "attention_prefill", "fused_ffn",
               "paged", "decode_fusion"):
        assert getattr(plan, op) == getattr(fresh, op), op
    assert plan.matmul.weight_dtype == fresh.matmul.weight_dtype


def test_cli_green_on_committed_plans(capsys):
    assert check_plans_torch.main([]) == 0
    assert "ok" in capsys.readouterr().out


def _mutate(tmp_path, mutate, name=None):
    """Copy the first committed plan, apply ``mutate`` to its dict."""
    doc = json.load(open(PLANS[0]))
    mutate(doc)
    p = tmp_path / (name or os.path.basename(PLANS[0]))
    p.write_text(json.dumps(doc))
    return str(p)


def _version(doc):
    doc["version"] = plan_mod.PLAN_VERSION + 1
    doc["provenance"]["version"] = plan_mod.PLAN_VERSION + 1


@pytest.mark.parametrize("mutate,finding", [
    (_version, "version"),
    (lambda d: d["provenance"].__setitem__("config", "0" * 12),
     "stale config hash"),
    (lambda d: d["provenance"].__setitem__("hardware", "0" * 12),
     "stale hardware hash"),
    (lambda d: d["provenance"].__setitem__("hardware_name", "tpu-v5e"),
     "not a known HardwareSpec"),
    (lambda d: d["provenance"].__setitem__("config_name", "gpt-5"),
     "not a known arch"),
    (lambda d: d["ops"]["paged"].__delitem__("kv_dtype"), "kv_dtype"),
    (lambda d: d["ops"]["paged"].__setitem__("kv_dtype", "int3"), "schema"),
    (lambda d: d["ops"]["matmul"].__delitem__("weight_dtype"),
     "weight_dtype"),
    (lambda d: d["ops"]["matmul"].__setitem__("weight_dtype", "int3"),
     "schema"),
    (lambda d: d["ops"].__delitem__("decode_fusion"), "decode_fusion"),
    (lambda d: d["ops"]["decode_fusion"].__setitem__("granularity",
                                                     "megakernel"),
     "schema"),
    (lambda d: d["ops"]["decode_fusion"].__setitem__("granularity",
                                                     "granular"), "schema"),
    (lambda d: d["ops"]["matmul"].__setitem__("backend", "pallas"),
     "schema"),
    (lambda d: d.__delitem__("provenance"), "provenance"),
], ids=["version", "config_hash", "hardware_hash", "unknown_hardware",
        "unknown_config", "missing_kv_dtype", "invalid_kv_dtype",
        "missing_weight_dtype", "invalid_weight_dtype",
        "missing_decode_fusion", "invalid_granularity", "granular",
        "jax_backend", "missing_provenance"])
def test_catches_each_mutation(tmp_path, mutate, finding):
    findings = check_plans_torch.check_plan(_mutate(tmp_path, mutate))
    assert any(finding in f for f in findings), findings


def test_catches_wrong_filename(tmp_path):
    findings = check_plans_torch.check_plan(
        _mutate(tmp_path, lambda doc: None, name="renamed.json"))
    assert any("filename" in f for f in findings)


def test_the_jax_plans_are_not_the_ports():
    """The JAX package's plans name its own backends and TPU hardware:
    the port's linter refuses them, and the two plan directories stay
    apart."""
    jax_plans = sorted(os.listdir(os.path.join(_ROOT, "plans")))
    assert jax_plans and not set(jax_plans) & set(map(os.path.basename,
                                                      PLANS))
    findings = check_plans_torch.check_plan(
        os.path.join(_ROOT, "plans", jax_plans[0]))
    assert findings and "schema" in findings[0]


def test_current_registry_is_consistent():
    specs = check_plans_torch._hardware_registry()
    assert "h100-sxm" in specs
    for path in PLANS:
        prov = json.load(open(path))["provenance"]
        assert prov["hardware_name"] in specs
        configs.get(prov["config_name"])   # must not raise
