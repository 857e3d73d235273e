"""The port's train losses (``repro_torch.models.*.train_loss``) and their
gradients against the JAX package's, on the CPU, for every family at its
smoke config (2 layers, d 128), seq 32, batch 2: the same params (carried
across by ``params_from_numpy``) and the same batch (``SyntheticTokens``,
bitwise the JAX package's stream, with internvl2's vision prefix and
whisper's frames).

This file holds f32 (``param_dtype`` and ``activation_dtype`` set to
"float32"); ``test_torch_train_bf16.py`` holds bf16.

Tolerances (f32): the loss within 1e-6 relative; each leaf's gradient
within F32_GRAD_TOL of the largest magnitude in the JAX leaf (the same
math in another summation order: measured at most 5e-6 of it). Remat on
and off give the port's loss and every gradient bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.models.layers import LayerCtx as JLayerCtx
from repro_torch import configs
from repro_torch.config import ShapeConfig
from repro_torch.core.plan import DEFAULT_PLAN
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import LayerCtx
from repro_torch.models.stack import tree_leaves
from repro_torch.training.data import SyntheticTokens, device_batch
from repro_torch.training.train_state import value_and_grad

FAMILIES = ["qwen2-0.5b", "internvl2-76b", "dbrx-132b", "rwkv6-1.6b",
            "hymba-1.5b", "whisper-tiny"]
F32_GRAD_TOL = 5e-5
TORCH_PLAN = DEFAULT_PLAN.with_overrides(backend="torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the small tensors here: under the suite's
    parallel workers a thread pool per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch, dtype):
    f = dict(param_dtype=dtype, activation_dtype=dtype)
    return (dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **f),
            dataclasses.replace(configs.smoke(configs.get(arch)), **f))


def setup(arch, dtype, seq=32, batch=2):
    """(jcfg, tcfg, JAX params, the port's params, numpy batch)."""
    jcfg, tcfg = cfgs(arch, dtype)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    hb = SyntheticTokens(tcfg, ShapeConfig("t", seq, batch, "train"),
                         seed=1).batch_at(0)
    return jcfg, tcfg, jp, tp, hb


def jax_loss_and_grads(jcfg, jp, hb, remat=True):
    batch = {k: jnp.asarray(v) for k, v in hb.items()}
    return jax.value_and_grad(
        lambda p: jget_model(jcfg).train_loss(JLayerCtx(cfg=jcfg), p, batch,
                                              remat=remat))(jp)


def port_loss_and_grads(tcfg, tp, hb, remat=True):
    ctx = LayerCtx(cfg=tcfg, plan=TORCH_PLAN)
    api = get_model(tcfg)
    return value_and_grad(
        lambda p, b: api.train_loss(ctx, p, b, remat=remat), tp,
        device_batch(hb, "cpu"))


def grad_pairs(tg, jg, path=""):
    """(path, port leaf as f32 numpy, JAX leaf as f32 numpy) for every
    leaf."""
    if isinstance(tg, dict):
        assert set(tg) == set(jg), path
        for k in tg:
            yield from grad_pairs(tg[k], jg[k], f"{path}/{k}")
        return
    yield path, tg.float().numpy(), np.asarray(jg, np.float32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference_f32(arch):
    jcfg, tcfg, jp, tp, hb = setup(arch, "float32")
    jl, jg = jax_loss_and_grads(jcfg, jp, hb)
    tl, tg = port_loss_and_grads(tcfg, tp, hb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for path, a, b in grad_pairs(tg, jax.device_get(jg)):
        assert a.shape == b.shape, path
        bound = F32_GRAD_TOL * max(np.abs(b).max(), 1e-12)
        assert np.abs(a - b).max() <= bound, (path, np.abs(a - b).max(),
                                              bound)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_equals_off_bitwise(arch):
    """Recomputing each block in the backward pass (and each loss chunk,
    always) changes no bit of the loss or of any gradient."""
    _, tcfg, _, tp, hb = setup(arch, "bfloat16")
    on_l, on_g = port_loss_and_grads(tcfg, tp, hb, remat=True)
    off_l, off_g = port_loss_and_grads(tcfg, tp, hb, remat=False)
    assert torch.equal(on_l, off_l)
    for a, b in zip(tree_leaves(on_g), tree_leaves(off_g)):
        assert torch.equal(a, b)


def test_prefix_positions_carry_no_loss():
    """internvl2's vision prefix enters the backbone ahead of the tokens
    (so it moves the loss) but its positions carry no label: the loss is
    the mean over the token positions only."""
    _, tcfg, _, tp, hb = setup("internvl2-76b", "float32")
    api = get_model(tcfg)
    ctx = LayerCtx(cfg=tcfg, plan=TORCH_PLAN)
    batch = device_batch(hb, "cpu")
    with torch.no_grad():
        base = api.train_loss(ctx, tp, batch)
        moved = api.train_loss(ctx, tp, dict(
            batch, prefix_embeds=batch["prefix_embeds"] * 50.0))
    assert batch["prefix_embeds"].shape[1] == 8      # n_image_tokens(32)
    assert batch["tokens"].shape[1] == 24
    assert torch.isfinite(base) and not torch.equal(base, moved)


def test_cross_entropy_masks_the_padded_vocabulary():
    """Logits past ``vocab_size`` are masked to -1e9: with an lm head
    whose padded columns are huge the loss does not move."""
    from repro_torch.models import layers as L
    _, tcfg, _, tp, hb = setup("qwen2-0.5b", "float32")
    tcfg = dataclasses.replace(tcfg, vocab_size=500)     # 512 padded
    ctx = LayerCtx(cfg=tcfg, plan=TORCH_PLAN)
    x = torch.randn((2, 32, tcfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    labels = torch.from_numpy(hb["labels"] % 500)
    emb = tp["embedding"].clone()
    base = L.cross_entropy_loss(ctx, {"embedding": emb}, x, labels)
    emb[500:] = 1e4
    hot = L.cross_entropy_loss(ctx, {"embedding": emb}, x, labels)
    assert torch.equal(base, hot)
