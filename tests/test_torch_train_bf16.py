"""The port's train losses and gradients against the JAX package's in
bf16 (the configs' own dtypes), for every family at its smoke config,
seq 32, batch 2; the same params and batch as
``test_torch_train_loss.py``.

Tolerances: ``conftest.TOL["bfloat16"]`` on the loss and on every leaf's
gradient (the frameworks round at other points: measured at most 4e-3
absolute on a gradient, 6e-4 relative on the loss). One leaf is the
exception, RWKV6's ``bonus_u`` (gradients up to 17, summed over every
position and channel): there the JAX package's own bf16 gradient misses
its f32 gradient by 0.53, outside TOL, and the port's by as much. Where
the reference's own bf16 gradient misses its f32 gradient beyond TOL,
the port's bf16 gradient is held to the f32 gradient instead, within
REF_NOISE times the reference's own bf16 error.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import TOL
from repro_torch.models.stack import tree_leaves
from test_torch_train_loss import (FAMILIES, grad_pairs,
                                   jax_loss_and_grads, port_loss_and_grads,
                                   setup)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_NOISE = 1.5


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference_bf16(arch):
    jcfg, tcfg, jp, tp, hb = setup(arch, "bfloat16")
    jl, jg = jax_loss_and_grads(jcfg, jp, hb)
    tl, tg = port_loss_and_grads(tcfg, tp, hb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL["bfloat16"])
    off = {}
    for path, a, b in grad_pairs(tg, jax.device_get(jg)):
        assert a.shape == b.shape, path
        if not np.allclose(a, b, **TOL["bfloat16"]):
            off[path] = (a, b)
    if off:
        # the f32 gradient (the two packages agree on it to 5e-6 of each
        # leaf's scale: test_torch_train_loss.py)
        jcfg32, _, jp32, _, _ = setup(arch, "float32")
        _, jg32 = jax_loss_and_grads(jcfg32, jp32, hb)
        truth = {p: b for p, _, b in grad_pairs(tg, jax.device_get(jg32))}
        for path, (a, b) in off.items():
            ref_err = np.abs(b - truth[path]).max()
            assert not np.allclose(b, truth[path], **TOL["bfloat16"]), (
                f"{path}: the port misses the reference's bf16 gradient "
                "where the reference's own bf16 rounding is within TOL")
            assert np.abs(a - truth[path]).max() <= REF_NOISE * ref_err, path
    # each gradient keeps its param's dtype, as jax.grad's does
    for g, p in zip(tree_leaves(tg), tree_leaves(tp)):
        assert g.dtype == p.dtype
