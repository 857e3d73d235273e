"""The port's single-card dry run (``repro_torch.launch.dryrun``) against
the JAX package, on the CPU.

* Meta params: every ASSIGNED arch's ``init_params(device="meta")`` has
  ``jax.eval_shape(init_params)``'s leaves (shape and dtype) at the
  published widths, and the CPU init's at smoke widths.
* Serve input specs: equal to the JAX package's for every ASSIGNED arch
  at ``decode_32k`` and ``prefill_32k`` (the cache tree included); the
  VLM's prefill takes the ``prefix_embeds`` they give it as the JAX
  package's does (f32, TOL["float32"]); the meta argument bytes equal a
  CPU build's.
* FLOP parity: the counted FLOPs of probes of one and three layers
  against XLA's ``cost_analysis()["flops"]`` of the same step lowered
  with ``mesh=None`` (as the JAX dry run's builders do), for the dense,
  MoE, ssm, hybrid, encdec and VLM families at smoke widths: within
  DECODE_PREFILL_TOL for decode and prefill, TRAIN_TOL for train. XLA
  counts elementwise work the dispatcher counts a little differently;
  the measured ratios lie in 0.96-1.06.
* Exact linearity: the count at five layers equals ``extrapolate`` of
  one and three to five (relative 1e-9), FLOPs and bytes.
* The CLI: ``main`` writes a record with the JAX keys, on one card and
  as rank 0 of the pod meshes (``--mesh single``, ``--mesh multi``,
  int8-EF; no process group left behind), ``--grad-compression`` without
  a mesh raises, and cells run with JAX not importable.

``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` to 512
host devices when imported.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL

from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.core import plan as jplan
from repro.models import api as japi
from repro.models.layers import LayerCtx as JLayerCtx
from repro.training.train_state import TrainState as JTrainState
from repro.training.train_state import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.analysis import roofline
from repro_torch.config import RunConfig, ShapeConfig, SHAPES
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["qwen2-0.5b", "dbrx-132b", "rwkv6-1.6b", "hymba-1.5b",
            "whisper-tiny", "internvl2-76b"]
# (seq_len, batch) of the smoke-width parity cells
SMOKE_SHAPES = {"decode": (256, 4), "prefill": (128, 2), "train": (128, 2)}
DECODE_PREFILL_TOL = 0.10
TRAIN_TOL = 0.15
JKEYS = {"arch", "shape", "mesh", "chips", "ok", "full", "probes"}
TORCH_PLAN = DEFAULT_PLAN.with_overrides(backend="torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: under the suite's parallel workers a thread
    pool per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a tree of tensors or of JAX / port
    shape records."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    dtype = tree.dtype
    name = (str(dtype).removeprefix("torch.")
            if isinstance(dtype, torch.dtype) else str(dtype))
    return {prefix: (tuple(tree.shape), name)}


def probe(cfg, n):
    kw = {"num_layers": n}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# params and input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_meta_params_match_jax_eval_shape(arch):
    jcfg = jconfigs.get(arch)
    want = flat(jax.eval_shape(
        lambda: japi.get_model(jcfg).init_params(jax.random.PRNGKey(0))))
    params = api.get_model(configs.get(arch)).init_params(device="meta")
    assert all(t.is_meta for t in tree_leaves(params))
    assert flat(params) == want


@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_meta_params_match_the_cpu_init(arch):
    cfg = configs.smoke(configs.get(arch))
    model = api.get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    assert (flat(model.init_params(device="meta"))
            == flat(model.init_params(gen, device="cpu")))


@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_serve_input_specs_match_jax(arch, shape_name):
    jfn = {"decode_32k": japi.serve_decode_input_specs,
           "prefill_32k": japi.serve_prefill_input_specs}[shape_name]
    tfn = {"decode_32k": api.serve_decode_input_specs,
           "prefill_32k": api.serve_prefill_input_specs}[shape_name]
    jshape = JShapeConfig("s", SHAPES[shape_name].seq_len,
                          SHAPES[shape_name].global_batch,
                          SHAPES[shape_name].kind)
    got = tfn(configs.get(arch), SHAPES[shape_name])
    assert flat(got) == flat(jfn(jconfigs.get(arch), jshape))
    assert set(got) >= {"tokens", "lengths"}


def test_vlm_prefill_takes_prefix_embeds_as_the_jax_package():
    """internvl2's prefill with the stub vision prefix (what
    ``serve_prefill_input_specs`` gives it), f32: last-token logits and
    the cache rows against the JAX package's."""
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get("internvl2-76b")),
                               **f32)
    tcfg = dataclasses.replace(configs.smoke(configs.get("internvl2-76b")),
                               **f32)
    jmodel, tmodel = japi.get_model(jcfg), api.get_model(tcfg)
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(3)
    b, s = 2, 32
    npfx = api.n_image_tokens(s)
    tokens = rng.integers(1, jcfg.vocab_size, (b, s - npfx)).astype(np.int32)
    prefix = (rng.normal(size=(b, npfx, jcfg.d_model)) * 0.02).astype(
        np.float32)
    lengths = np.array([s, s - 5], np.int32)
    jl, jcache = jmodel.prefill(
        JLayerCtx(cfg=jcfg), jp, jnp.asarray(tokens), jnp.asarray(lengths),
        jmodel.init_cache(japi.DenseLayout(b, s)),
        prefix_embeds=jnp.asarray(prefix))
    tl, tcache = tmodel.prefill(
        LayerCtx(cfg=tcfg, plan=TORCH_PLAN), tp, torch.from_numpy(tokens),
        torch.from_numpy(lengths),
        tmodel.init_cache(api.DenseLayout(b, s), device="cpu"),
        prefix_embeds=torch.from_numpy(prefix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# FLOP parity and linearity
# ---------------------------------------------------------------------------


def jax_flops(cfg, kind, seq, batch) -> float:
    """XLA's counted FLOPs of one unrolled step, built as the JAX dry
    run's build_* do with mesh=None."""
    model = japi.get_model(cfg)
    ctx = JLayerCtx(cfg=cfg, plan=jplan.make_plan().with_overrides(
        backend="xla", fallback=False))
    shape = JShapeConfig(kind, seq, batch, kind)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    if kind == "train":
        step = jmake_train_step(model, ctx, JRunConfig(), unroll=True,
                                mesh=None)
        state = jax.eval_shape(lambda: JTrainState.create(
            model.init_params(jax.random.PRNGKey(0))))
        args = (state, japi.train_input_specs(cfg, shape))
    elif kind == "decode":
        specs = japi.serve_decode_input_specs(cfg, shape)

        def step(p, t, c, n):
            return model.decode_step(ctx, p, t, c, n, unroll=True)
        args = (params, specs["tokens"], specs["cache"], specs["lengths"])
    else:
        specs = japi.serve_prefill_input_specs(cfg, shape)
        cache = model.cache_spec(japi.DenseLayout(batch, seq))
        extra = {k: v for k, v in specs.items()
                 if k not in ("tokens", "lengths")}

        def step(p, t, n, e):
            return model.prefill(ctx, p, t, n, cache, unroll=True, **e)
        args = (params, specs["tokens"], specs["lengths"], extra)
    cost = jax.jit(step).lower(*args).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_match_xla_cost_analysis(arch, kind):
    seq, batch = SMOKE_SHAPES[kind]
    tol = TRAIN_TOL if kind == "train" else DECODE_PREFILL_TOL
    jcfg = jconfigs.smoke(jconfigs.get(arch))
    tcfg = configs.smoke(configs.get(arch))
    for n in dryrun.PROBES:
        want = jax_flops(probe(jcfg, n), kind, seq, batch)
        got = dryrun.count(probe(tcfg, n), ShapeConfig(kind, seq, batch, kind),
                           RunConfig())["flops_global"]
        print(f"flop parity {arch} {kind} L={n}: port / XLA "
              f"{got / want:.3f}")       # PERF.md's table (pytest -s)
        assert abs(got / want - 1.0) <= tol, (n, got, want)


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counts_are_exactly_linear_in_depth(arch, kind):
    seq, batch = SMOKE_SHAPES[kind]
    cfg = configs.smoke(configs.get(arch))
    shape = ShapeConfig(kind, seq, batch, kind)
    rec = {n: dryrun.count(probe(cfg, n), shape, RunConfig())
           for n in (1, 3, 5)}
    full = roofline.extrapolate(
        [roofline.ProbeCost(n, rec[n]["flops_global"], rec[n]["bytes_global"],
                            rec[n]["collective_bytes"]) for n in (1, 3)], 5)
    assert full.flops == pytest.approx(rec[5]["flops_global"], rel=1e-9)
    assert full.bytes_accessed == pytest.approx(rec[5]["bytes_global"],
                                                rel=1e-9)
    assert rec[1]["flops_global"] < rec[3]["flops_global"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_match_a_real_build(arch):
    """The decode cell's argument bytes on meta are what the CPU build of
    the same params, cache, tokens and lengths holds."""
    cfg = configs.smoke(configs.get(arch))
    seq, batch = SMOKE_SHAPES["decode"]
    shape = ShapeConfig("decode", seq, batch, "decode")
    model = api.get_model(cfg)
    real = tree_leaves(model.init_params(torch.Generator().manual_seed(0),
                                         device="cpu"))
    real += tree_leaves(model.init_cache(api.DenseLayout(batch, seq),
                                         device="cpu"))
    real += [torch.zeros(batch, dtype=torch.int32)] * 2
    rec = dryrun.count(cfg, shape, RunConfig())
    assert rec["argument_size_in_bytes"] == sum(t.nbytes for t in real)


def test_full_depth_record_at_published_widths():
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k")
    assert rec["ok"], rec.get("error")
    full = rec["full"]
    # the decode_32k cache: 24 layers x 128 rows x 32,768 positions x K and
    # V x 2 kv heads x 64 dims at 2 bytes, plus the params
    cache = 24 * 128 * 32768 * 2 * 2 * 64 * 2
    assert full["argument_size_in_bytes"] > cache
    assert full["per_device_bytes"] == (full["argument_size_in_bytes"]
                                        + full["temp_size_in_bytes"])
    assert full["fits"] is True
    # the full-depth count equals the probes' extrapolation
    assert rec["terms"]["hlo_flops"] == pytest.approx(full["flops_global"],
                                                      rel=1e-9)
    assert rec["terms"]["bottleneck"] == "memory"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_writes_a_record_with_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "dr"
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                      "--out", str(out)])
    assert rc == 0
    rec = json.loads((out / "whisper-tiny__decode_32k__1.json").read_text())
    assert JKEYS <= set(rec)
    assert (rec["mesh"], rec["chips"], rec["ok"]) == ("1", 1, True)
    assert [p["num_layers"] for p in rec["probes"]] == [1, 3]
    assert "whisper-tiny" in capsys.readouterr().out


@pytest.mark.parametrize("argv,mesh,chips", [
    (["--mesh", "single"], "16x16", 256),
    (["--mesh", "multi", "--no-probes"], "2x16x16", 512),
    (["--mesh", "multi", "--grad-compression", "int8_ef", "--no-probes"],
     "2x16x16", 512)], ids=["single", "multi", "multi-int8_ef"])
def test_cli_runs_the_pod_meshes(argv, mesh, chips, tmp_path):
    """whisper-tiny x decode_32k as rank 0 of each pod mesh: a record
    with the JAX keys, the mesh's name and chips, the rank's collectives
    (nonzero), the one-card global counts beside its own; probes and the
    roofline terms (a nonzero collective term) on the single pod only;
    no default process group left."""
    rc = dryrun.main(argv + ["--arch", "whisper-tiny", "--shape",
                             "decode_32k", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / f"whisper-tiny__decode_32k__{mesh}.json")
                     .read_text())
    assert JKEYS <= set(rec)
    assert (rec["mesh"], rec["chips"], rec["ok"]) == (mesh, chips, True)
    full = rec["full"]
    for key in ("argument_size_in_bytes", "temp_size_in_bytes",
                "output_size_in_bytes", "per_device_bytes",
                "flops_per_device", "bytes_per_device", "flops_global",
                "bytes_global", "collective_counts", "collective_by_kind"):
        assert key in full, key
    assert full["collective_bytes"] > 0
    assert full["flops_per_device"] < full["flops_global"]
    assert rec["fsdp_params"] is False
    if mesh == "16x16":
        assert [p["num_layers"] for p in rec["probes"]] == [1, 3]
        assert rec["terms"]["chips"] == 256
        assert rec["terms"]["collective_s"] > 0
    else:
        assert rec["probes"] == [] and "terms" not in rec
    assert not torch.distributed.is_initialized()


def test_cli_refuses_grad_compression_without_a_mesh(tmp_path):
    with pytest.raises(ValueError, match="--mesh multi"):
        dryrun.main(["--grad-compression", "int8_ef", "--out",
                     str(tmp_path)])


def test_weight_dtype_counts_quantized_serving_params():
    """``--weight-dtype int8`` quantizes the serving cells' layer GEMM
    weights (1-byte codes and f32 steps: fewer argument bytes); the MoE
    family is refused, as the engine refuses it."""
    plan = plan_mod.make_plan(weight_dtype="int8")
    bf16, int8 = (dryrun.run_cell("whisper-tiny", "decode_32k", probes=(),
                                  plan=p) for p in (None, plan))
    assert bf16["ok"] and int8["ok"], int8.get("error")
    assert (int8["full"]["argument_size_in_bytes"]
            < bf16["full"]["argument_size_in_bytes"])
    moe = dryrun.run_cell("dbrx-132b", "decode_32k", probes=(),
                          cfg=configs.smoke(configs.get("dbrx-132b")),
                          plan=plan)
    assert not moe["ok"] and "moe family" in moe["error"]


_NO_JAX = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
from repro_torch.launch import dryrun
cell = ["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--out", sys.argv[1]]
sys.exit(dryrun.main(cell) or dryrun.main(cell + ["--mesh", "single"]))
"""


def test_cli_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("failures=0") == 2
    assert (tmp_path / "rwkv6-1.6b__long_500k__1.json").exists()
    assert (tmp_path / "rwkv6-1.6b__long_500k__16x16.json").exists()
