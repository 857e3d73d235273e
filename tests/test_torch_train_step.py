"""The port's optimizer, train step and data stream against the JAX
package's, on the CPU.

  * ``lr_schedule``, ``global_norm``, ``clip_by_global_norm`` and
    ``adamw_update`` (weight decay on matrices only) on the same trees:
    f32 math in the same order, held at rtol 1e-6 (a pow or a sqrt may
    round another way; measured exact here).
  * One ``make_train_step`` step on smoke qwen2-0.5b (f32) from the same
    state and batch: loss rtol 1e-6; every new param, m and v leaf within
    2e-5 of its scale (the gradient's 5e-6 of
    ``test_torch_train_loss.py``, through AdamW's normalisation).
    Microbatch 4 equals the full batch (loss rtol 5e-4, grad norm 1e-3:
    the bounds ``tests/test_training.py`` holds the JAX package to).
  * ``SyntheticTokens.batch_at`` bitwise the JAX package's, with host
    sharding and with the vision and encoder-decoder extras; the
    ``Prefetcher`` keeps its order and closes.
  * The ``"cuda"`` plan and the kernel wrappers refuse autograd.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RunConfig as JRunConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.models.api import get_model as jget_model
from repro.models.layers import LayerCtx as JLayerCtx
from repro.training import optimizer as jopt
from repro.training.data import SyntheticTokens as JSyntheticTokens
from repro.training.train_state import TrainState as JTrainState
from repro.training.train_state import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.core.plan import DEFAULT_PLAN, make_plan
from repro_torch.kernels import ops
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map
from repro_torch.training import optimizer as opt
from repro_torch.training.data import Prefetcher, SyntheticTokens, device_batch
from repro_torch.training.train_state import TrainState, make_train_step

TORCH_PLAN = DEFAULT_PLAN.with_overrides(backend="torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trees(seed=0):
    """A small mixed tree (a matrix, a stacked tensor, a vector) as numpy
    params and gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 6), "layers": {"k": (2, 3, 5), "scale": (7,)}}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return draw(shapes, 1.0), draw(shapes, 0.3)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def assert_tree_close(got, want, **tol):
    for a, b in zip(tree_leaves(got), _leaves_like(got, want)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **tol)


def _leaves_like(tree, ref):
    """``ref``'s leaves in the port tree's order (dict order, not
    sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves_like(tree[k], ref[k])]
    return [ref]


@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedule_matches_reference(warmup):
    cfg = dict(learning_rate=0.7, warmup_steps=warmup, total_steps=100,
               min_lr_ratio=0.1)
    for step in (0, 3, 10, 37, 55, 100, 250):
        want = jopt.lr_schedule(jopt.AdamWConfig(**cfg),
                                jnp.asarray(step, jnp.int32))
        got = opt.lr_schedule(opt.AdamWConfig(**cfg),
                              torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("scale", [0.05, 1.0, 20.0])
def test_clip_by_global_norm_matches_reference(scale):
    _, g = trees(1)
    g = jax.tree.map(lambda a: a * scale, g)
    jc, jn = jopt.clip_by_global_norm(to_jax(g), 1.0)
    tc, tn = opt.clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert_tree_close(tc, jax.device_get(jc), rtol=1e-6, atol=1e-7)
    assert float(opt.global_norm(tc)) <= 1.0 + 1e-5


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_update_matches_reference(clip):
    p, g = trees(2)
    cfg = dict(learning_rate=0.05, weight_decay=0.1, clip_norm=clip,
               warmup_steps=3, total_steps=20)
    jm, jv = jopt.adamw_init(to_jax(p))
    tm, tv = opt.adamw_init(to_torch(p))
    jp_, tp_ = to_jax(p), to_torch(p)
    for step in range(3):      # carried moments: the bias corrections move
        jp_, jm, jv, jmet = jopt.adamw_update(
            jopt.AdamWConfig(**cfg), jp_, to_jax(g), jm, jv,
            jnp.asarray(step, jnp.int32))
        tp_, tm, tv, tmet = opt.adamw_update(
            opt.AdamWConfig(**cfg), tp_, to_torch(g), tm, tv,
            torch.tensor(step, dtype=torch.int32))
    for got, want in ((tp_, jp_), (tm, jm), (tv, jv)):
        assert_tree_close(got, jax.device_get(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                               rtol=1e-6)


def test_weight_decay_applies_to_matrices_only():
    cfg = opt.AdamWConfig(learning_rate=1.0, weight_decay=0.5,
                          clip_norm=0.0, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.ones((2, 2)), "scale": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "scale": torch.zeros((2,))}
    m, v = opt.adamw_init(p)
    new_p, *_ = opt.adamw_update(cfg, p, g, m, v,
                                 torch.zeros((), dtype=torch.int32))
    assert float(new_p["w"][0, 0]) < 1.0     # decayed
    assert float(new_p["scale"][0]) == 1.0   # norm gains never decayed
    assert new_p["w"] is not p["w"] and float(p["w"][0, 0]) == 1.0


def test_adamw_keeps_param_dtypes_and_f32_moments():
    p = {"w": torch.ones((3, 2), dtype=torch.bfloat16),
         "b": torch.ones((2,), dtype=torch.float32)}
    m, v = opt.adamw_init(p)
    assert all(t.dtype == torch.float32
               for t in tree_leaves(m) + tree_leaves(v))
    g = {"w": torch.full((3, 2), 0.5, dtype=torch.bfloat16),
         "b": torch.full((2,), 0.5)}
    new_p, new_m, new_v, _ = opt.adamw_update(
        opt.AdamWConfig(), p, g, m, v, torch.zeros((), dtype=torch.int32))
    assert new_p["w"].dtype == torch.bfloat16
    assert new_p["b"].dtype == torch.float32
    assert new_m["w"].dtype == new_v["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


def qwen_f32():
    f = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get("qwen2-0.5b")),
                               **f)
    tcfg = dataclasses.replace(configs.smoke(configs.get("qwen2-0.5b")), **f)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_train_step_matches_reference():
    jcfg, tcfg, jp, tp = qwen_f32()
    hb = SyntheticTokens(tcfg, ShapeConfig("t", 32, 4, "train"),
                         seed=2).batch_at(0)
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    jstep = jmake_train_step(jget_model(jcfg), JLayerCtx(cfg=jcfg),
                             JRunConfig(**kw))
    tstep = make_train_step(get_model(tcfg),
                            LayerCtx(cfg=tcfg, plan=TORCH_PLAN),
                            RunConfig(**kw))
    js, jmet = jstep(JTrainState.create(jp),
                     {k: jnp.asarray(v) for k, v in hb.items()})
    ts, tmet = tstep(TrainState.create(tp), device_batch(hb, "cpu"))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert int(ts.step) == int(js.step) == 1
    for got, want in ((ts.params, js.params), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(tree_leaves(got),
                        _leaves_like(got, jax.device_get(want))):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            assert np.abs(a - b).max() <= 2e-5 * max(np.abs(b).max(), 1e-12)


def test_microbatch_accumulation_matches_full_batch():
    _, tcfg, _, tp = qwen_f32()
    hb = device_batch(SyntheticTokens(
        tcfg, ShapeConfig("t", 32, 4, "train"), seed=1).batch_at(0), "cpu")
    ctx = LayerCtx(cfg=tcfg, plan=TORCH_PLAN)
    out = {}
    for mb in (0, 4):
        step = make_train_step(get_model(tcfg), ctx, RunConfig(
            microbatch=mb, learning_rate=0.0, warmup_steps=0))
        out[mb] = step(TrainState.create(tp), hb)[1]
    np.testing.assert_allclose(float(out[4]["loss"]), float(out[0]["loss"]),
                               rtol=5e-4)
    np.testing.assert_allclose(float(out[4]["grad_norm"]),
                               float(out[0]["grad_norm"]), rtol=1e-3)


def test_train_state_leaves_are_not_modified():
    """The step returns a new state; the old one keeps its values and
    takes no gradient flag."""
    _, tcfg, _, tp = qwen_f32()
    hb = device_batch(SyntheticTokens(
        tcfg, ShapeConfig("t", 16, 2, "train")).batch_at(0), "cpu")
    state = TrainState.create(tp)
    before = [t.clone() for t in tree_leaves(state.params)]
    step = make_train_step(get_model(tcfg),
                           LayerCtx(cfg=tcfg, plan=TORCH_PLAN),
                           RunConfig(learning_rate=1e-2, warmup_steps=0))
    new, _ = step(state, hb)
    for a, b in zip(before, tree_leaves(state.params)):
        assert torch.equal(a, b) and not b.requires_grad
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(new.params)))


# ---------------------------------------------------------------------------
# The "cuda" plan and the kernel wrappers under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["default", "cuda attention only"])
def test_make_train_step_refuses_the_cuda_plan(plan):
    _, tcfg, _, _ = qwen_f32()
    p = DEFAULT_PLAN if plan == "default" else dataclasses.replace(
        TORCH_PLAN, attention_prefill=dataclasses.replace(
            TORCH_PLAN.attention_prefill, backend="cuda"))
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(get_model(tcfg), LayerCtx(cfg=tcfg, plan=p),
                        RunConfig())


def test_make_train_step_refuses_mesh_and_compression():
    """A mesh needs the context of that mesh (its rules and shard check):
    a context without one is refused. int8-EF without a ``pod`` axis is
    the plain step, as in the JAX package (the sharded and compressed
    steps: ``tests/test_torch_sharded_train.py``)."""
    _, tcfg, _, tp = qwen_f32()
    ctx = LayerCtx(cfg=tcfg, plan=TORCH_PLAN)
    with pytest.raises(ValueError, match="LayerCtx\\(mesh=mesh"):
        make_train_step(get_model(tcfg), ctx, RunConfig(),
                        mesh=object())
    hb = device_batch(SyntheticTokens(
        tcfg, ShapeConfig("t", 16, 2, "train")).batch_at(0), "cpu")
    out = [make_train_step(get_model(tcfg), ctx, RunConfig(
        grad_compression=c, warmup_steps=0))(TrainState.create(tp), hb)
        for c in ("int8_ef", "none")]
    assert float(out[0][1]["loss"]) == float(out[1][1]["loss"])
    assert out[0][0].ef_err is None
    for a, b in zip(tree_leaves(out[0][0].params),
                    tree_leaves(out[1][0].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["gemv", "flat_gemm", "flash_prefill",
                                    "fused_ffn_up"])
def test_kernel_wrappers_refuse_autograd(kernel):
    """A wrapper given an input that requires a gradient raises while
    autograd records, on CPU tensors too (no plain-version fallback);
    under no_grad it runs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 64), generator=g).to(torch.bfloat16)
    w = torch.randn((64, 32), generator=g).to(torch.bfloat16)
    q = torch.randn((1, 16, 2, 64), generator=g).to(torch.bfloat16)
    calls = {
        "gemv": lambda a, b: ops.gemv(a, b),
        "flat_gemm": lambda a, b: ops.flat_gemm(a, b),
        "fused_ffn_up": lambda a, b: ops.fused_ffn_up(a, b, b),
        "flash_prefill": lambda a, b: ops.flash_prefill_sync(q, q, q),
    }
    fn = calls[kernel]
    w_grad = w.clone().requires_grad_(True)
    if kernel == "flash_prefill":
        q = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        fn(x, w_grad)
    with torch.no_grad():
        fn(x, w_grad)


def test_cuda_plan_model_forward_refuses_autograd():
    """The model forward on the "cuda" plan's wrappers, with params that
    require gradients, raises at its first kernel."""
    _, tcfg, _, tp = qwen_f32()
    tp = tree_map(lambda t: t.to(torch.bfloat16).requires_grad_(True), tp)
    cfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    hb = device_batch(SyntheticTokens(
        cfg, ShapeConfig("t", 16, 2, "train")).batch_at(0), "cpu")
    with pytest.raises(ValueError, match="no backward"):
        get_model(cfg).train_loss(LayerCtx(cfg=cfg, plan=make_plan("cuda")),
                                  tp, hb, remat=False)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-76b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_tokens_bitwise_reference(arch, hosts):
    jcfg = jconfigs.smoke(jconfigs.get(arch))
    tcfg = configs.smoke(configs.get(arch))
    for host in range(hosts):
        for step in (0, 11):
            want = JSyntheticTokens(
                jcfg, JShapeConfig("t", 32, 4, "train"), seed=3,
                host_index=host, host_count=hosts).batch_at(step)
            got = SyntheticTokens(
                tcfg, ShapeConfig("t", 32, 4, "train"), seed=3,
                host_index=host, host_count=hosts).batch_at(step)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    extra = {"internvl2-76b": "prefix_embeds", "whisper-tiny": "frames"}
    if arch in extra:
        assert extra[arch] in got


def test_prefetcher_orders_and_closes():
    cfg = configs.smoke(configs.get("qwen2-0.5b"))
    src = SyntheticTokens(cfg, ShapeConfig("t", 16, 2, "train"))
    pf = Prefetcher(src, start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = pf.next(timeout=30.0)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_device_batch_and_input_specs():
    from repro_torch.models.api import (make_synthetic_batch,
                                        train_input_specs)
    cfg = configs.smoke(configs.get("internvl2-76b"))
    shape = ShapeConfig("t", 32, 2, "train")
    specs = train_input_specs(cfg, shape)
    assert specs["tokens"].shape == (2, 24)
    assert specs["prefix_embeds"] == ((2, 8, cfg.d_model), torch.bfloat16)
    b = make_synthetic_batch(cfg, shape, torch.Generator().manual_seed(0),
                             device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        k: s for k, s in specs.items()}
    assert int(b["tokens"].max()) < cfg.vocab_size
    db = device_batch(SyntheticTokens(cfg, shape).batch_at(0), "cpu")
    assert db["tokens"].dtype == torch.int32
    assert db["prefix_embeds"].dtype == torch.float32
