"""Provenance/schema linter for the port's committed ``plans_torch/*.json``
artifacts: the twin of ``tools/check_plans.py`` (the JAX package's plans),
run against ``repro_torch``.

    PYTHONPATH=src python tools/check_plans_torch.py [paths...]

A tuned plan is a promise: "these knob values were derived from *this*
config on *this* hardware." The serving loader (``ExecutionPlan.load``)
already rejects stale plans at use time, but a drive-by edit to
``HardwareSpec`` or ``ModelConfig`` strands every committed artifact
silently — nothing fails until someone serves with ``--plan``. This
linter runs the same checks ahead of time, over every committed plan:

  * the document parses through ``ExecutionPlan.from_json`` — every knob
    value passes the same validation serving uses (scheme/backend
    whitelists, positive blocks, ``kv_dtype`` in ``KV_DTYPES``, ...);
  * ``version`` matches ``PLAN_VERSION``;
  * provenance exists, its ``config`` hash matches the *current*
    ``configs.get(config_name)`` and its ``hardware`` hash matches the
    named spec in ``repro_torch.hardware`` — i.e. the plan would load
    strictly today;
  * the paged op records an explicit ``kv_dtype`` (pre-quantization
    documents default to bf16 on load, but committed artifacts must say
    what they tuned for);
  * the ``decode_fusion`` op records an explicit ``granularity`` in
    ``FUSION_MODES`` (pre-fusion documents default to split on load —
    same rule: committed artifacts must say what they tuned);
  * the ``matmul`` op records an explicit ``weight_dtype`` in
    ``WEIGHT_DTYPES`` (pre-weight-quant documents default to bf16 on
    load — committed artifacts must say what they tuned);
  * the filename matches ``default_plan_path`` for its provenance.

Exit status 0 = every plan clean, 1 = at least one finding (one line per
finding, ``path: message``). ``tests/test_torch_check_plans.py`` runs it
over the committed plans and holds it to each finding. It imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import glob
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch import configs, hardware  # noqa: E402
from repro_torch.core import plan as plan_mod  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    FUSION_MODES, KV_DTYPES, PLAN_VERSION, WEIGHT_DTYPES, ExecutionPlan,
    PlanError,
)


def _hardware_registry() -> dict:
    """name -> HardwareSpec for every spec the hardware module defines."""
    return {
        spec.name: spec
        for spec in vars(hardware).values()
        if isinstance(spec, hardware.HardwareSpec)
    }


def check_plan(path: str) -> list:
    """All findings for one plan file ([] = clean)."""
    findings = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable JSON: {e}"]

    # knob validity: the full document must round-trip the same
    # constructors serving uses
    try:
        plan = ExecutionPlan.from_json(json.dumps(doc))
    except PlanError as e:
        return [f"schema: {e}"]

    if doc.get("version") != PLAN_VERSION:
        findings.append(f"version {doc.get('version')!r} != "
                        f"PLAN_VERSION {PLAN_VERSION}")

    paged_doc = doc.get("ops", {}).get("paged", {})
    if "kv_dtype" not in paged_doc:
        findings.append("paged op missing explicit kv_dtype "
                        "(legacy document — retune)")
    elif paged_doc["kv_dtype"] not in KV_DTYPES:
        findings.append(f"kv_dtype {paged_doc['kv_dtype']!r} "
                        f"not in {KV_DTYPES}")

    matmul_doc = doc.get("ops", {}).get("matmul", {})
    if "weight_dtype" not in matmul_doc:
        findings.append("matmul op missing explicit weight_dtype "
                        "(legacy document — retune)")
    elif matmul_doc["weight_dtype"] not in WEIGHT_DTYPES:
        findings.append(f"weight_dtype {matmul_doc['weight_dtype']!r} "
                        f"not in {WEIGHT_DTYPES}")

    fusion_doc = doc.get("ops", {}).get("decode_fusion", {})
    if "granularity" not in fusion_doc:
        findings.append("decode_fusion op missing explicit granularity "
                        "(legacy document — retune)")
    elif fusion_doc["granularity"] not in FUSION_MODES:
        findings.append(f"decode_fusion granularity "
                        f"{fusion_doc['granularity']!r} "
                        f"not in {FUSION_MODES}")

    prov = plan.provenance
    if prov is None:
        findings.append("no provenance (hand-written plan committed?)")
        return findings

    try:
        cfg = configs.get(prov.config_name)
    except KeyError:
        findings.append(f"provenance config {prov.config_name!r} is not "
                        "a known arch")
        cfg = None
    if cfg is not None and plan_mod.config_hash(cfg) != prov.config:
        findings.append(
            f"stale config hash: plan {prov.config} vs current "
            f"{plan_mod.config_hash(cfg)} for {prov.config_name} — retune")

    specs = _hardware_registry()
    spec = specs.get(prov.hardware_name)
    if spec is None:
        findings.append(f"provenance hardware {prov.hardware_name!r} is "
                        "not a known HardwareSpec")
    elif plan_mod.hardware_hash(spec) != prov.hardware:
        findings.append(
            f"stale hardware hash: plan {prov.hardware} vs current "
            f"{plan_mod.hardware_hash(spec)} for {prov.hardware_name} "
            "— retune")

    if cfg is not None and spec is not None:
        want = os.path.basename(plan_mod.default_plan_path(cfg, spec))
        got = os.path.basename(path)
        if got != want:
            findings.append(f"filename {got!r} != canonical {want!r}")

    return findings


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = argv or sorted(
        glob.glob(os.path.join(_ROOT, "plans_torch", "*.json")))
    if not paths:
        print("check_plans_torch: no plan files found", file=sys.stderr)
        return 1
    bad = 0
    for path in paths:
        findings = check_plan(path)
        rel = os.path.relpath(path, _ROOT)
        if findings:
            bad += 1
            for msg in findings:
                print(f"{rel}: {msg}")
        else:
            print(f"{rel}: ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
