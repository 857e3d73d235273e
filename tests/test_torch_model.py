"""The port's dense model (repro_torch.models) against the JAX package's on
the smoke qwen2 config, with the reference's own ``init_params(PRNGKey(0))``
carried across by ``params_from_numpy`` (biases and norm scales perturbed
so those paths carry signal). Both port backends run: ``"cuda"`` (on CPU
tensors: the kernels' plain versions) and ``"torch"`` (reference math).

Tolerances: TOL["float32"] with f32 params and activations (same math,
other summation order); TOL["bfloat16"] in bf16 (rounding points differ
between the frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.models.kvlayout import DenseLayout as JDenseLayout
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs as tconfigs
from repro_torch.core.plan import make_plan
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import DenseLayout
from repro_torch.models.layers import LayerCtx

ARCH = "qwen2-0.5b"


def _cfgs(dtype):
    over = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **over),
            dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **over))


def _perturb(tree, rng):
    """Random biases and norm scales (the init's are zeros and ones)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("bq", "bk", "bv") or k == "scale":
            base = 1.0 if k == "scale" else 0.0
            noise = rng.normal(size=v.shape).astype(np.float32) * 0.1
            out[k] = (base + noise).astype(v.dtype)
        else:
            out[k] = v
    return out


_MODELS = {}


def _model(dtype):
    """(jcfg, tcfg, jparams, numpy params) — built once per dtype."""
    if dtype not in _MODELS:
        jcfg, tcfg = _cfgs(dtype)
        jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
        host = _perturb(jax.device_get(jp), np.random.default_rng(0))
        jp = jax.tree.map(jnp.asarray, host)
        _MODELS[dtype] = (jcfg, tcfg, jp, host)
    return _MODELS[dtype]


def _close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def test_configs_match_reference():
    for name, cfg in jconfigs.REGISTRY.items():
        port = tconfigs.get(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg), name
        assert (dataclasses.asdict(tconfigs.smoke(port))
                == dataclasses.asdict(jconfigs.smoke(cfg))), name
        assert port.param_count() == cfg.param_count(), name


def test_params_from_numpy_keeps_names_shapes_and_bits():
    _, _, jp, host = _model("bfloat16")
    tp = params_from_numpy(host, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) > 10
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            node.float().numpy(), np.asarray(leaf.astype(jnp.float32)))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunk_then_decode_step_logits(dtype, backend):
    """One ragged chunk (rows fill 16 and 11 positions), then one decode
    step from each row's new length: logits and the KV cache agree."""
    jcfg, tcfg, jp, host = _model(dtype)
    japi, tapi = jget_model(jcfg), tget_model(tcfg)
    jctx = JLayerCtx(cfg=jcfg)
    tctx = LayerCtx(cfg=tcfg, plan=make_plan(backend))
    tp = params_from_numpy(host, device="cpu")
    rng = np.random.default_rng(1)
    b, c, s_max = 2, 16, 48
    tokens = rng.integers(1, jcfg.vocab_size, (b, c)).astype(np.int32)
    chunk_lens = np.array([16, 11], np.int32)
    lengths = np.zeros((b,), np.int32)

    jcache = japi.init_cache(JDenseLayout(b, s_max))
    jl, jcache = japi.prefill_chunk(jctx, jp, jnp.asarray(tokens),
                                    jnp.asarray(chunk_lens), jcache,
                                    jnp.asarray(lengths))
    tcache = tapi.init_cache(DenseLayout(b, s_max), device="cpu")
    tl, tcache = tapi.prefill_chunk(tctx, tp, torch.from_numpy(tokens),
                                    torch.from_numpy(chunk_lens), tcache,
                                    torch.from_numpy(lengths))
    _close(tl, jl, dtype)
    _close(tcache["k"][:, 0, :16], jcache["k"][:, 0, :16], dtype)
    _close(tcache["v"][:, 1, :11], jcache["v"][:, 1, :11], dtype)

    nxt = np.array([5, 77], np.int32)
    jl, _ = japi.decode_step(jctx, jp, jnp.asarray(nxt), jcache,
                             jnp.asarray(chunk_lens))
    tl, _ = tapi.decode_step(tctx, tp, torch.from_numpy(nxt), tcache,
                             torch.from_numpy(chunk_lens))
    _close(tl, jl, dtype)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits(dtype, backend):
    """Whole-prompt prefill (flash prefill on the cuda backend): last-token
    logits for ragged lengths, and the cache rows it writes."""
    jcfg, tcfg, jp, host = _model(dtype)
    japi, tapi = jget_model(jcfg), tget_model(tcfg)
    tp = params_from_numpy(host, device="cpu")
    rng = np.random.default_rng(2)
    b, s, s_max = 2, 24, 32
    tokens = rng.integers(1, jcfg.vocab_size, (b, s)).astype(np.int32)
    lengths = np.array([24, 9], np.int32)
    jl, jcache = japi.prefill(JLayerCtx(cfg=jcfg), jp, jnp.asarray(tokens),
                              jnp.asarray(lengths),
                              japi.init_cache(JDenseLayout(b, s_max)))
    tl, tcache = tapi.prefill(LayerCtx(cfg=tcfg, plan=make_plan(backend)),
                              tp, torch.from_numpy(tokens),
                              torch.from_numpy(lengths),
                              tapi.init_cache(DenseLayout(b, s_max),
                                              device="cpu"))
    _close(tl, jl, dtype)
    _close(tcache["k"][:, :, :s], jcache["k"][:, :, :s], dtype)


def test_unported_families_and_modes_raise():
    with pytest.raises(NotImplementedError, match="slice 7"):
        tget_model(tconfigs.smoke(tconfigs.get("dbrx-132b")))
    _, tcfg = _cfgs("float32")
    from repro_torch.core.plan import DecodeFusionPlan, ExecutionPlan
    with pytest.raises(NotImplementedError, match="decode-fusion"):
        LayerCtx(cfg=tcfg, plan=ExecutionPlan(
            decode_fusion=DecodeFusionPlan(granularity="looped")))


def test_init_params_draws_reference_distributions():
    """init_params on the CPU: the reference's shapes, unit norms, zero
    biases, and weights with std ≈ fan_in^-1/2."""
    jcfg, tcfg = _cfgs("float32")
    gen = torch.Generator().manual_seed(0)
    tp = tget_model(tcfg).init_params(gen, device="cpu")
    jshapes = jax.eval_shape(jget_model(jcfg).init_params,
                             jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape, path
    lay = tp["layers"]
    assert torch.equal(lay["attn_norm"]["scale"],
                       torch.ones_like(lay["attn_norm"]["scale"]))
    assert not lay["attn"]["bq"].any()
    std = lay["mlp"]["w_down"].std().item()
    assert abs(std - tcfg.d_ff ** -0.5) < 0.1 * tcfg.d_ff ** -0.5
