"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``) on the
CPU, against the JAX package's ``distributed/pipeline.py``.

Two gloo ranks (``tests/_torch_dist.py``) on a (pod, data, model) = (2,
1, 1) mesh run the schedule over ``pod``: JAX's toy case (four layers
that add their weight, two stages: outputs 10.0, each layer's gradient
8.0) and the smoke qwen2-0.5b in f32, 2 stages of 1 dense block, M = 4
microbatches of 2 x 16. Params come from the JAX package's
``init_params(PRNGKey(0))``; the microbatches and the cotangent are made
with numpy from a seed.

Tolerances: the toy exact; the smoke stack's outputs bit for bit the
unpipelined port's (the same blocks on the same microbatches); its
gradients within 1e-5 of the largest element of the unpipelined port's
(the stage is recomputed in the backward pass and the microbatches'
gradients summed in another order) and within ``conftest.TOL["float32"]``
of the JAX package's unpipelined ``value_and_grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from conftest import TOL
from repro import configs as jconfigs
from repro.distributed import pipeline as JPP
from repro.models import stack as jstack
from repro.models import transformer as JT
from repro.models.api import get_model as jget_model
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.distributed import pipeline as PP
from repro_torch.models import stack
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves, tree_map

F32 = dict(param_dtype="float32", activation_dtype="float32")
PDM = ("pod", "data", "model")
M, MB, S = 4, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as the ranks run: the unpipelined reference
    sums in their order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _jcfg():
    return dataclasses.replace(jconfigs.smoke(jconfigs.get("qwen2-0.5b")),
                               **F32)


def _tcfg():
    return dataclasses.replace(configs.smoke(configs.get("qwen2-0.5b")),
                               **F32)


def _inputs():
    if "inputs" not in _CACHE:
        jp = jax.jit(jget_model(_jcfg()).init_params)(jax.random.PRNGKey(0))
        rng = np.random.default_rng(11)
        d = _tcfg().d_model
        _CACHE["inputs"] = (
            jax.tree.map(np.asarray, jax.device_get(jp)),
            rng.standard_normal((M, MB, S, d)).astype(np.float32),
            rng.standard_normal((M, MB, S, d)).astype(np.float32))
    return _CACHE["inputs"]


def _ranks(tmp_path_factory):
    if "ranks" not in _CACHE:
        params, xs, ct = _inputs()
        _CACHE["ranks"] = _torch_dist.run(
            "pipeline", 2, tmp_path_factory.mktemp("pipeline"),
            dict(cfg=_tcfg(), params=params, xs=xs, ct=ct),
            mesh=((2, 1, 1), PDM))
    return _CACHE["ranks"]


def _positions():
    return torch.arange(S)[None].expand(MB, -1)


def _unpipelined():
    """The smoke stack applied microbatch by microbatch: outputs, the
    gradients of ``sum(out * ct)`` with respect to the layers and the
    microbatches."""
    params, xs, ct = _inputs()
    ctx = LayerCtx(_tcfg(), DEFAULT_PLAN.with_overrides(backend="torch"))
    layers = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(params, device="cpu")["layers"])
    x = torch.from_numpy(xs).requires_grad_(True)
    out = torch.stack([stack.run_stack(layers, x[i], lambda p_i, xx: T.block(
        ctx, p_i, xx, _positions())[0]) for i in range(M)])
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), tree_map(lambda t: t.grad.numpy(),
                                          layers), x.grad.numpy()


def _close_rel(got, want, rel):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), err


def test_split_and_merge_stages_match_jax():
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((6, 3, 2)).astype(np.float32),
            "b": {"c": rng.standard_normal((6, 5)).astype(np.float32)}}
    for n in (1, 2, 3, 6):
        got = PP.split_stages(tree_map(torch.from_numpy, tree), n)
        want = JPP.split_stages(jax.tree.map(jnp.asarray, tree), n)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        back = PP.merge_stages(got)
        jback = JPP.merge_stages(want)
        for g, w, t in zip(tree_leaves(back), jax.tree.leaves(jback),
                           tree_leaves(tree_map(np.asarray, tree))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), t)
    with pytest.raises(AssertionError):
        PP.split_stages({"a": torch.zeros(5, 2)}, 2)


def test_toy_pipeline_forward_and_grad(tmp_path_factory):
    """JAX's ``test_pipeline_forward_and_grad_multidevice``: outputs 10.0
    on every rank, every layer's gradient 8.0 (each rank holds its own
    stage's), the microbatches' gradient 1.0 (ones as the cotangent); the
    schedule issues P + M - 1 = 5 permutes forward and 5 backward, and
    two broadcasts (the outputs, the microbatches' gradient)."""
    ranks = _ranks(tmp_path_factory)
    for r in ranks:
        toy = r["toy"]
        np.testing.assert_array_equal(toy["out"], np.full((4, 2, 1), 10.0))
        np.testing.assert_array_equal(toy["grads"]["w"], np.full((2, 1),
                                                                 8.0))
        np.testing.assert_array_equal(toy["xs_grad"], np.ones((4, 2, 1)))
        assert toy["collectives"] == {"collective-permute": 10,
                                      "collective-broadcast": 2}


def test_dense_pipeline_is_the_unpipelined_stack(tmp_path_factory):
    """2 stages x 1 block of the smoke qwen2-0.5b, M = 4: outputs bit for
    bit the unpipelined port's on every rank; stage r's gradients (the
    stacked leaves' row r) and the microbatches' within 1e-5 of the
    largest element of the unpipelined port's."""
    ranks = _ranks(tmp_path_factory)
    out, grads, xs_grad = _unpipelined()
    for r, res in enumerate(ranks):
        dense = res["dense"]
        np.testing.assert_array_equal(dense["out"], out)
        _close_rel(dense["xs_grad"], xs_grad, 1e-5)
        for g, w in zip(tree_leaves(dense["grads"]), tree_leaves(grads)):
            _close_rel(g, w[r:r + 1], 1e-5)


def test_dense_pipeline_matches_jax_value_and_grad(tmp_path_factory):
    """The same run against the JAX package's unpipelined stack: its
    ``value_and_grad`` of ``sum(out * ct)`` over the microbatches."""
    ranks = _ranks(tmp_path_factory)
    params, xs, ct = _inputs()
    cfg = _jcfg()
    ctx = JLayerCtx(cfg=cfg)
    positions = jnp.broadcast_to(jnp.arange(S), (MB, S))

    def loss(layers, x):
        out = jnp.stack([jstack.run_stack(layers, x[i], lambda p_i, xx:
                                          JT.block(ctx, p_i, xx, positions),
                                          unroll=True)[0]
                         for i in range(M)])
        return jnp.sum(out * ct), out

    (_, out), (g_layers, g_xs) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params["layers"]), jnp.asarray(xs))
    for r, res in enumerate(ranks):
        dense = res["dense"]
        np.testing.assert_allclose(dense["out"], np.asarray(out),
                                   **TOL["float32"])
        np.testing.assert_allclose(dense["xs_grad"], np.asarray(g_xs),
                                   **TOL["float32"])
        for g, w in zip(tree_leaves(dense["grads"]),
                        jax.tree.leaves(g_layers)):
            np.testing.assert_allclose(g, np.asarray(w)[r:r + 1],
                                       **TOL["float32"])
