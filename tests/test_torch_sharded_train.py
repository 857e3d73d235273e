"""Slice 8b-1 of the port on the CPU: the sharded trainer (TP over
``model``, FSDP over the batch axes) and the int8-EF cross-pod hop,
against the JAX package.

The multi-rank tests run gloo ranks, each a process of its own
(``tests/_torch_dist.py``: a ``FileStore`` in a tmp dir, every rank
joined with a timeout and killed on expiry), on meshes (data, model) or
(pod, data, model). Params come from the JAX package's
``init_params(PRNGKey(0))``, carried over by ``models/convert.py``;
inputs are made with numpy from a seed. The smoke qwen2-0.5b runs in f32
(4 query / 2 KV heads of 32: ``model`` = 4 cuts a KV head, so its
projections are gathered before the heads are formed).

Tolerances: the int8 quantizer bitwise; the cross-pod mean against the
JAX math to f32 rounding (1e-6 of each leaf's largest element), the
residuals bitwise; each TP / FSDP layer against the unsharded port,
1e-5 of the largest element (f32 sums in another order); the sharded
steps' losses within rtol 2e-3 of the JAX single-device step (the JAX
package's own bound for its sharded step) and of the port's one-rank
step, params within ``conftest.TOL["float32"]``; checkpoints bit for
bit.
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

import _torch_dist
from conftest import TOL
from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.distributed import collectives as JC
from repro.models.api import get_model as jget_model
from repro.models.api import make_synthetic_batch
from repro.models.layers import LayerCtx as JLayerCtx
from repro.training.checkpoint import CheckpointManager as JCheckpointManager
from repro.training.train_state import TrainState as JTrainState
from repro.training.train_state import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.distributed import P
from repro_torch.distributed import collectives as C
from repro_torch.launch import train as cli
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map
from repro_torch.training.data import SyntheticTokens, device_batch
from repro_torch.training.train_state import TrainState, make_train_step

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32")
RUN = dict(learning_rate=1e-3, warmup_steps=1)
LAYERS = ["attention", "mlp", "embed", "loss"]
DM = ("data", "model")
PDM = ("pod", "data", "model")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return dataclasses.replace(jconfigs.smoke(jconfigs.get("qwen2-0.5b")),
                               **F32)


def _tcfg():
    return dataclasses.replace(configs.smoke(configs.get("qwen2-0.5b")),
                               **F32)


_CACHE = {}


def _jax_params():
    if "params" not in _CACHE:
        jp = jget_model(_jcfg()).init_params(jax.random.PRNGKey(0))
        _CACHE["jparams"] = jp
        _CACHE["params"] = jax.tree.map(np.asarray, jax.device_get(jp))
    return _CACHE["params"]


def _batch():
    """The JAX package's sharded-step test batch: 8 x 32 from key 1."""
    b = make_synthetic_batch(_jcfg(), JShapeConfig("t", 32, 8, "train"),
                             jax.random.PRNGKey(1))
    return {k: np.array(v) for k, v in b.items()}


def _close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


# ---------------------------------------------------------------------------
# int8-EF: the quantizer bitwise, the cross-pod mean against the JAX math
# ---------------------------------------------------------------------------


def _leaf(kind):
    rng = np.random.default_rng(3)
    if kind == "normal":
        return (rng.standard_normal((64, 48)) * 0.01).astype(np.float32)
    if kind == "zeros":
        return np.zeros((5, 7), np.float32)
    # amax 127 -> scale 1: every other value a tie at .5 (half to even)
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.49],
                    np.float32)


@pytest.mark.parametrize("kind", ["normal", "zeros", "ties"])
def test_int8_quantizer_matches_reference_bitwise(kind):
    x = _leaf(kind)
    err = (np.random.default_rng(4).standard_normal(x.shape) * 1e-3).astype(
        np.float32) * (kind == "normal")
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = C.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(
        C.dequantize_int8(tq, ts).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))
    jout = JC.ef_quantize_leaf(jnp.asarray(x), jnp.asarray(err))
    tout = C.ef_quantize_leaf(torch.from_numpy(x), torch.from_numpy(err))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind == "zeros":
        assert float(ts) == 1.0 and not tq.any()
    if kind == "ties":
        assert tq[1:7].tolist() == [0, 2, 2, 0, -2, 4]


def _jax_crosspod(grads, errs):
    """The JAX package's crosspod_psum_int8 math, pod by pod, on host
    values: (the mean, each pod's new residual) per leaf."""
    mean, new = {}, [{} for _ in grads]
    for name in grads[0]:
        qs, ss = [], []
        for p, (g, e) in enumerate(zip(grads, errs)):
            q, s, ne = JC.ef_quantize_leaf(jnp.asarray(g[name]),
                                           jnp.asarray(e[name]))
            qs.append(q)
            ss.append(s)
            new[p][name] = np.asarray(ne)
        total = jnp.tensordot(jnp.stack(ss),
                              jnp.stack(qs).astype(jnp.float32),
                              axes=((0,), (0,)))
        mean[name] = np.asarray(total / len(grads))
    return mean, new


def _mean_close(got, want):
    """To f32 rounding: each element is a sum of one product a pod, so
    1e-6 of the leaf's largest (where the two products nearly cancel,
    the receiver's order or a fused multiply-add moves the last bit of
    the larger one)."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_crosspod_psum_int8_matches_reference(tmp_path):
    """Two pods of two data ranks: each rank holds its shards of its
    pod's leaves (cut over data on either dim, or replicated), so a
    leaf's scale needs the pod's MAX all-reduce; the ranks' mean is the
    JAX math's on the pods' whole leaves, the residuals bitwise theirs;
    the boxed form (``crosspod_allreduce_int8``) gives the same bits."""
    rng = np.random.default_rng(5)
    shapes = {"a": (8, 6), "b": (4, 10), "c": (7,)}
    specs = {"a": P("data", None), "b": P(None, "data"), "c": P(None)}
    grads = [{k: (rng.standard_normal(s) * 10 ** -p).astype(np.float32)
              for k, s in shapes.items()} for p in range(2)]
    errs = [{k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2)]
    res = _torch_dist.run("int8", 4, tmp_path, dict(
        grads=grads, errs=errs, specs=specs), mesh=((2, 2, 1), PDM))
    mean, new = _jax_crosspod(grads, errs)
    for r, out in enumerate(res):
        pod = r // 2
        for k in shapes:
            _mean_close(out["mean"][k], mean[k])
            np.testing.assert_array_equal(out["err"][k], new[pod][k])
        assert out["boxed"]


# ---------------------------------------------------------------------------
# Each TP / FSDP layer against the unsharded port
# ---------------------------------------------------------------------------


def _layer_inputs():
    rng = np.random.default_rng(6)
    b, s, d = 4, 16, _tcfg().d_model
    inputs = dict(x=rng.standard_normal((b, s, d)).astype(np.float32),
                  tokens=rng.integers(0, 512, (b, s)).astype(np.int64),
                  labels=rng.integers(0, 500, (b, s)).astype(np.int64),
                  positions=np.broadcast_to(np.arange(s), (b, s)).copy())
    return inputs, rng.standard_normal((b, s, d)).astype(np.float32)


def _layer_reference(name):
    inputs, ct = _layer_inputs()
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(_jax_params(), device="cpu"))
    rows = {k: torch.from_numpy(v) for k, v in inputs.items()}
    rows["x"] = rows["x"].clone().requires_grad_(True)
    ctx = LayerCtx(_tcfg(), DEFAULT_PLAN.with_overrides(backend="torch"))
    y = _torch_dist.layer_fn(name)(ctx, params, rows)
    if name == "loss":
        y.backward()
    else:
        (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), rows["x"].grad, params


def _layer_run(shape, tmp_path_factory):
    if shape not in _CACHE:
        inputs, ct = _layer_inputs()
        _CACHE[shape] = _torch_dist.run(
            "layer", int(np.prod(shape)), tmp_path_factory.mktemp("layer"),
            dict(cfg=_tcfg(), params=_jax_params(), inputs=inputs, ct=ct,
                 layers=LAYERS), mesh=(shape, DM))[0]
    return _CACHE[shape]


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_tp_fsdp_layer_matches_unsharded(shape, layer, tmp_path_factory):
    """attention_block (at model = 4 a KV head is cut: the projections
    are gathered), mlp_block, the vocabulary-parallel embedding and the
    vocabulary-parallel loss: output, input gradient and every param's
    gathered gradient within 1e-5 of the largest element of the
    unsharded port's."""
    got = _layer_run(shape, tmp_path_factory)[layer]
    y, dx, params = _layer_reference(layer)
    _close_rel(got["out"], y, 1e-5)
    if dx is not None:
        _close_rel(got["dx"], dx.numpy(), 1e-5)
    for a, p in zip(tree_leaves(got["grads"]), tree_leaves(params)):
        want = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        _close_rel(a, want, 1e-5)


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _reference_steps():
    """3 steps of the JAX single-device step and of the port's unsharded
    step on the same params and batch: (losses JAX, losses port, the
    port's final params)."""
    if "ref" not in _CACHE:
        jcfg, batch = _jcfg(), _batch()
        jstep = jax.jit(jmake_train_step(jget_model(jcfg),
                                         JLayerCtx(cfg=jcfg),
                                         JRunConfig(**RUN)))
        js = JTrainState.create(_CACHE.get("jparams") or jget_model(
            jcfg).init_params(jax.random.PRNGKey(0)))
        jl = []
        for _ in range(3):
            js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
            jl.append(float(m["loss"]))
        tcfg = _tcfg()
        step = make_train_step(get_model(tcfg), LayerCtx(
            tcfg, DEFAULT_PLAN.with_overrides(backend="torch")),
            RunConfig(**RUN))
        ts = TrainState.create(params_from_numpy(_jax_params(), device="cpu"))
        tl = []
        for _ in range(3):
            ts, m = step(ts, device_batch(batch, "cpu"))
            tl.append(float(m["loss"]))
        _CACHE["ref"] = (jl, tl, tree_map(lambda t: t.numpy(), ts.params),
                         jax.tree.map(np.asarray, jax.device_get(js.params)))
    return _CACHE["ref"]


def _train(shape, names, tmp_path, compression="none"):
    batch = _batch()
    return _torch_dist.run("train", int(np.prod(shape)), tmp_path, dict(
        cfg=_tcfg(), params=_jax_params(), batches=[batch] * 3, run=RUN,
        compression=compression), mesh=(shape, names))


# collectives a step: _torch_dist.TRAIN_COLLECTIVES (derived there; the
# mesh dry run's meta count of one rank is held to the same numbers)
COLLECTIVES = _torch_dist.TRAIN_COLLECTIVES


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_sharded_train_step_matches_single(shape, tmp_path):
    """The JAX package's ``test_sharded_train_step_multidevice_matches_
    single`` for the port: 3 steps at (data, model) = ``shape`` within
    rtol 2e-3 of the JAX single-device step and of the port's one-rank
    step, the gathered params within TOL, every rank's losses alike, and
    the collectives of a step as counted."""
    jl, tl, tparams, jparams = _reference_steps()
    res = _train(shape, DM, tmp_path)
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=2e-3)
        np.testing.assert_allclose(r["losses"], tl, rtol=2e-3)
        assert r["losses"] == res[0]["losses"]
        assert r["collectives"] == COLLECTIVES[shape]
    _params_close(res[0]["params"], jparams)
    _params_close(res[0]["params"], tparams)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-tiny", "internvl2-76b"])
def test_other_families_train_on_a_data_mesh(arch, tmp_path):
    """The families other than the dense one on the mesh they accept,
    (data, model) = (2, 1): FSDP gathers their params, each rank takes
    half the batch (Whisper's frames and the VLM's prefix embeddings
    too), and 3 steps give the port's one-rank losses within rtol 2e-3
    and its params within TOL, every rank's losses alike."""
    cfg = dataclasses.replace(configs.smoke(configs.get(arch)), **F32)
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticTokens(cfg, ShapeConfig("t", 32, 8, "train"),
                            seed=1).batch_at(0)
    step = make_train_step(api, LayerCtx(
        cfg, DEFAULT_PLAN.with_overrides(backend="torch")), RunConfig(**RUN))
    state, losses = TrainState.create(params), []
    for _ in range(3):
        state, m = step(state, device_batch(batch, "cpu"))
        losses.append(float(m["loss"]))
    res = _torch_dist.run("train", 2, tmp_path, dict(
        cfg=cfg, params=tree_map(lambda t: t.numpy(), params),
        batches=[batch] * 3, run=RUN), mesh=((2, 1), DM))
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-3)
        assert r["losses"] == res[0]["losses"]
    _params_close(res[0]["params"], tree_map(lambda t: t.numpy(),
                                             state.params))


def _params_close(port, ref):
    """Every leaf of the port's tree within TOL of ``ref``'s (a JAX or a
    port tree of host arrays) at the same path."""
    for path, got in _flat(port):
        want = ref
        for k in path:
            want = want[k]
        np.testing.assert_allclose(got, np.asarray(want),
                                   **TOL["float32"])


def test_one_rank_step_matches_jax_step():
    """The port's one-rank params after the 3 steps the sharded steps
    are held to, against the JAX package's single-device step."""
    jl, tl, tparams, jparams = _reference_steps()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(tparams, jparams)


def test_int8_ef_step(tmp_path):
    """(pod, data, model) = (2, 1, 1) with int8-EF: the first loss is the
    plain step's, the mean gradient the step applies is the JAX math's
    on the two pods' gradients (each rank's residual bitwise its pod's),
    the later losses near the plain ones, and ef_err has the JAX layout
    (npods, ...)."""
    jl, tl, _, _ = _reference_steps()
    res = _train((2, 1, 1), PDM, tmp_path, compression="int8_ef")
    grads = [r["int8"]["grads"] for r in res]
    flat = [{"/".join(k): v for k, v in _flat(g)} for g in grads]
    errs = [{k: np.zeros_like(v) for k, v in f.items()} for f in flat]
    mean, new = _jax_crosspod(flat, errs)
    for pod, r in enumerate(res):
        np.testing.assert_allclose(r["losses"][0], tl[0], rtol=1e-6)
        np.testing.assert_allclose(r["losses"], tl, rtol=3e-2)
        for k, v in _flat(r["int8"]["mean"]):
            _mean_close(v, mean["/".join(k)])
        for k, v in _flat(r["int8"]["err"]):
            np.testing.assert_array_equal(v, new[pod]["/".join(k)])
        assert r["collectives"] == {"all-reduce": 2, "all-gather": 2}
    for (k, e), (_, p) in zip(_flat(res[0]["ef_err"]),
                              _flat(res[0]["params"])):
        assert e.shape == (2, *p.shape), k


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Checkpoints under a mesh
# ---------------------------------------------------------------------------


def _ckpt(tmp, shape, **kw):
    return _torch_dist.run("ckpt", int(np.prod(shape)), tmp / "ranks", dict(
        cfg=_tcfg(), params=_jax_params(), run=RUN, steps=4, **kw),
        mesh=(shape, DM))[0]


def _same_state(a, b):
    for f in ("params", "m", "v"):
        for x, y in zip(tree_leaves(a[f]), tree_leaves(b[f])):
            np.testing.assert_array_equal(x, y)


def test_checkpoint_resume_is_bitwise_and_restores_at_another_mesh(
        tmp_path):
    """At (1, 2): a run preempted after 2 steps and resumed ends bit for
    bit where the uninterrupted 4-step run does; its checkpoint restored
    at (2, 1) gives the same gathered state."""
    full = _ckpt(tmp_path / "a", (1, 2), dir=str(tmp_path / "full"),
                 mode="run")
    part = _ckpt(tmp_path / "b", (1, 2), dir=str(tmp_path / "part"),
                 mode="run", preempt_after=2)
    assert [r[:3] for r in part["results"]] == [(2, True, None),
                                                (4, False, 2)]
    assert full["results"][0][3][2:] == part["results"][1][3]
    _same_state(full["state"], part["state"])
    moved = _ckpt(tmp_path / "c", (2, 1), dir=str(tmp_path / "full"),
                  mode="restore")
    assert moved["step"] == full["step"] == 4
    _same_state(full["state"], moved["state"])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
           "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
           "--log-every", "1", "--checkpoint-dir", str(tmp_path / "ck"),
           *flags]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(line.split()[3]) for line in res.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all(), res.stdout
    assert res.stdout.strip().splitlines()[-1].startswith(
        "finished at step 3 (restored_from=None, preempted=False)")
    return tmp_path / "ck" / "step_000003"


@pytest.mark.parametrize("flags", [("--devices", "2"), ("--mesh", "2x1"),
                                   ("--mesh", "2x1x1", "--grad-compression",
                                    "int8_ef")])
def test_cli_trains_on_a_mesh(flags, tmp_path):
    """The CLI's ranks (subprocesses of it, gloo on the CPU) train 3
    steps: rank 0 logs finite losses and the final line. With int8-EF
    the checkpoint holds ef_err as the JAX package writes it: (npods,
    ...) leaves, which its CheckpointManager restores into its
    TrainState.create(npods=2, compression="int8_ef")."""
    step_dir = _cli(tmp_path, *flags)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["step"] == 3
    if "int8_ef" in flags:
        jcfg = jconfigs.smoke(jconfigs.get("qwen2-0.5b"))
        like = JTrainState.create(
            jget_model(jcfg).init_params(jax.random.PRNGKey(0)), npods=2,
            compression="int8_ef")
        got = JCheckpointManager(str(step_dir.parent)).load_state(3, like)
        wq = got.ef_err["layers"]["attn"]["wq"]
        assert wq.shape == (2, 2, 128, 128)
        assert manifest["leaves"][".ef_err/layers/attn/wq"]["shape"] == [
            2, 2, 128, 128]
        assert int(got.step) == 3


@pytest.mark.parametrize("arch,flags", [
    ("rwkv6-1.6b", ["--mesh", "1x2"]),
    ("hymba-1.5b", ["--devices", "2"]),
    ("rwkv6-1.6b", ["--mesh", "2x1x1"]),
    ("hymba-1.5b", ["--mesh", "2x1x1", "--grad-compression", "int8_ef"])])
def test_cli_trains_recurrent_families_on_a_mesh(arch, flags, tmp_path):
    """A recurrent family (ssm, hybrid) trains through the CLI where
    ``model`` or ``pod`` is above 1 (tensor-parallel mixes, FSDP over
    pod, the int8-EF pod hop; ``tests/test_torch_recurrent_mesh.py``
    holds them to the JAX package): 3 finite losses and the final line.
    With int8-EF the checkpoint's ef_err is the JAX package's layout:
    its CheckpointManager restores it into its TrainState.create(
    npods=2, compression="int8_ef"), every leaf (2, *the param's)."""
    step_dir = _cli(tmp_path, "--arch", arch, *flags)
    if "int8_ef" in flags:
        jcfg = jconfigs.smoke(jconfigs.get(arch))
        like = JTrainState.create(
            jget_model(jcfg).init_params(jax.random.PRNGKey(0)), npods=2,
            compression="int8_ef")
        got = JCheckpointManager(str(step_dir.parent)).load_state(3, like)
        assert int(got.step) == 3
        errs, params = (jax.tree.leaves(t) for t in (got.ef_err, got.params))
        assert len(errs) == len(params)
        for e, p in zip(errs, params):
            assert e.shape == (2, *p.shape)


def test_cli_mesh_shapes():
    """The JAX CLI's default mesh, PxDxM, and the flags' agreement."""
    def dims(*a):
        return cli.mesh_dims(cli._parse(list(a)))
    assert dims("--devices", "4") == [2, 2]
    assert dims("--devices", "1") == [1, 1]
    assert dims("--devices", "2") == [1, 2]
    assert dims("--mesh", "2x1x2") == [2, 1, 2]
    assert dims() == []
    with pytest.raises(ValueError, match="ranks"):
        dims("--devices", "2", "--mesh", "2x2")
    with pytest.raises(ValueError, match="DxM"):
        dims("--mesh", "4")
