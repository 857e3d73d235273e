"""The port's checkpoints, loop and training CLI on the CPU, and
checkpoints crossing between the port and the JAX package.

  * ``CheckpointManager``: a bf16 round trip restores bit for bit, a
    torn step stays invisible, garbage collection keeps the latest, an
    async save overlaps and waits; the JAX package's leaf paths.
  * A step written by the JAX package's ``CheckpointManager`` restores
    into the port's ``TrainState`` bit for bit, and the port's into the
    JAX package's.
  * ``train_loop``: stopped at 4 and resumed, 8 steps give the
    uninterrupted run's losses bit for bit (the CPU step is
    deterministic); preemption checkpoints its step and returns.

The CLI and the example are in ``test_torch_train_cli.py``.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.training.checkpoint import CheckpointManager as JCheckpointManager
from repro.training.checkpoint import tree_paths as jtree_paths
from repro.training.train_state import TrainState as JTrainState
from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.models.api import get_model
from repro_torch.models.convert import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.models.layers import LayerCtx
from repro_torch.training.checkpoint import CheckpointManager, tree_paths
from repro_torch.training.loop import train_loop
from repro_torch.training.train_state import TrainState, make_train_step

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_state():
    return TrainState.create({
        "w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
        "b": torch.ones((3,), dtype=torch.float32),
        "q": torch.linspace(-2, 2, 8).to(torch.float8_e4m3fn),
    })


def flat(tree, prefix=""):
    """{path: leaf} of a port state or tree, keys sorted."""
    if isinstance(tree, TrainState):
        tree = vars(tree)
    if isinstance(tree, dict):
        return {p: leaf for k in sorted(tree)
                for p, leaf in flat(tree[k], f"{prefix}/{k}").items()}
    return {} if tree is None else {prefix: tree}


def bits(t):
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t


def same_state(a, b):
    """Every leaf of two port states equal bit for bit, dtypes too."""
    fa, fb = flat(a), flat(b)
    assert list(fa) == list(fb)
    for path, x in fa.items():
        y = fb[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(bits(x), bits(y)), path


def test_checkpoint_roundtrip_including_bf16_and_fp8():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        state = toy_state()
        mgr.save(7, state, blocking=True)
        assert mgr.latest_step() == 7
        like = TrainState.create({k: torch.zeros_like(v) for k, v in
                                  state.params.items()})
        same_state(mgr.load_state(7, like), state)
        assert os.path.exists(os.path.join(d, "step_000007", "COMMIT"))


def test_torn_checkpoint_invisible():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        mgr.save(5, toy_state(), blocking=True)
        # a crash mid-write: a step directory without COMMIT
        os.makedirs(os.path.join(d, "step_000009"))
        assert mgr.latest_step() == 5


def test_checkpoint_gc_keeps_latest():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, toy_state(), blocking=True)
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                       if n.startswith("step_"))
        assert steps == [3, 4]


def test_async_save_overlaps_and_waits():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        mgr.save(1, toy_state())     # async
        mgr.save(2, toy_state())     # waits for 1, then async
        mgr.wait()
        assert mgr.latest_step() == 2


def test_tree_paths_are_the_reference_paths():
    params = {"b": {"x": np.ones((2,), np.float32)},
              "a": np.zeros((3,), np.float32)}
    want = jtree_paths(JTrainState.create(jax.tree.map(jnp.asarray,
                                                       params)))
    got = tree_paths(TrainState.create(params_from_numpy(params, "cpu")))
    assert got == want == ['.m/a', '.m/b/x', '.params/a', '.params/b/x',
                           '.step', '.v/a', '.v/b/x']


def reference_state(step):
    """A JAX TrainState of smoke qwen2-0.5b (bf16 params) with moments
    made nonzero, and its port counterpart."""
    cfg = jconfigs.smoke(jconfigs.get("qwen2-0.5b"))
    params = jget_model(cfg).init_params(jax.random.PRNGKey(0))
    st = JTrainState.create(params)
    st = JTrainState(step=jnp.asarray(step, jnp.int32), params=params,
                     m=jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                                    params),
                     v=jax.tree.map(lambda p: jnp.square(
                         p.astype(jnp.float32)), params))
    return st, state_from_numpy(jax.device_get(st), device="cpu")


def test_reference_checkpoint_restores_in_the_port():
    jst, tst = reference_state(12)
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d).save(12, jst, blocking=True)
        mgr = CheckpointManager(d)
        assert mgr.latest_step() == 12
        like = TrainState.create(get_model(configs.smoke(configs.get(
            "qwen2-0.5b"))).init_params(torch.Generator().manual_seed(1),
                                        device="cpu"))
        got = mgr.load_state(12, like)
    same_state(got, tst)
    assert int(got.step) == 12


def test_port_checkpoint_restores_in_the_reference():
    jst, tst = reference_state(9)
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(9, tst, blocking=True)
        mgr = JCheckpointManager(d)
        assert mgr.latest_step() == 9
        got = mgr.load_state(9, jax.eval_shape(lambda: jst))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    back = state_to_numpy(tst)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            dict(step=jst.step, params=jst.params, m=jst.m, v=jst.v))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def loop_fixture(tmp, total):
    cfg = configs.smoke(configs.get("qwen2-0.5b"))
    shape = ShapeConfig("t", 32, 2, "train")
    run = RunConfig(total_steps=total, checkpoint_every=4,
                    learning_rate=1e-3, checkpoint_dir=tmp, warmup_steps=2)
    api = get_model(cfg)
    step = make_train_step(
        api, LayerCtx(cfg=cfg, plan=DEFAULT_PLAN.with_overrides(
            backend="torch")), run)

    def init():
        return TrainState.create(api.init_params(
            torch.Generator().manual_seed(0), device="cpu"))

    return dict(model_cfg=cfg, shape=shape, run=run, train_step=step,
                init_state=init, device="cpu", log_every=0,
                install_signals=False)


def test_loop_restart_resumes_and_matches_uninterrupted():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        kw = loop_fixture(d1, total=8)
        r1 = train_loop(max_steps=8, preempt_after=4, **kw)
        assert r1.preempted and r1.final_step == 4
        assert CheckpointManager(d1).latest_step() == 4
        r2 = train_loop(max_steps=8, **kw)
        assert r2.restored_from == 4 and r2.final_step == 8
        r3 = train_loop(max_steps=8, **loop_fixture(d2, total=8))
        assert r3.restored_from is None
        # deterministic data + deterministic math: the same losses, bit
        # for bit
        assert r1.losses + r2.losses == r3.losses
        assert r3.losses[-1] < r3.losses[0]


def test_loop_preemption_checkpoints_and_exits():
    with tempfile.TemporaryDirectory() as d:
        res = train_loop(preempt_after=3, **loop_fixture(d, total=100))
        assert res.preempted
        assert CheckpointManager(d).latest_step() == res.final_step == 3
