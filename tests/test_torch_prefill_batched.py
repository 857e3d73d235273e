"""The engine's one-shot batched prefill (``Engine._prefill_batched``) for
every family, on the CPU at smoke size.

The JAX engine prefills an admission wave into a scratch cache of its own
layout (``max_seq`` wide) and copies every cache leaf of each row to the
row's slot on axis 1. The port does the same:

  * every leaf of the recurrent and encoder-decoder caches (RWKV6's
    ``state`` / ``tm_x`` / ``cm_x``, Hymba's ring ``k`` / ``v`` and
    ``state``, Whisper's ``k`` / ``v`` / ``xk`` / ``xv``) lands at the
    admitted requests' slots, equal (f32, ``conftest.TOL``) to a prefill
    of that prompt alone, and the other slots stay zero;
  * Hymba's ring is ``min(window, max_seq)`` wide even when the prompt
    bucket is narrower than the window;
  * the dense family stays bitwise what it was before (the scratch was
    the prompt bucket wide and only its ``k`` / ``v`` rows were copied):
    the same tokens and the same KV below each row's length.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import TOL
from repro_torch import configs
from repro_torch.models.api import get_model
from repro_torch.models.kvlayout import DenseLayout, pow2_bucket
from repro_torch.serving import engine as eng_mod
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, **over):
    cfg = dataclasses.replace(configs.smoke(configs.get(arch)), **F32,
                              **over)
    gen = torch.Generator().manual_seed(0)
    return cfg, get_model(cfg).init_params(gen, device="cpu")


@pytest.mark.parametrize("arch,over", [
    ("rwkv6-1.6b", {}),
    ("hymba-1.5b", {}),
    # a 256-slot window over 20-token prompts: the bucket (64) is
    # narrower than the ring
    ("hymba-1.5b", {"sliding_window": 256}),
    ("whisper-tiny", {}),
], ids=["rwkv6", "hymba", "hymba-wide-window", "whisper"])
def test_every_leaf_lands_at_its_slot(arch, over):
    cfg, params = _model(arch, **over)
    max_seq = 512 if over else 128
    eng = Engine(cfg, params, num_slots=3, max_seq=max_seq, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n).astype(np.int32)
               for n in (20, 11)]
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=4))
    eng._admit()                   # admission alone: one batched prefill
    slots = {state.slot: p for state, p in zip(
        sorted(eng.by_slot.values(), key=lambda s: s.rid), prompts)}
    assert len(slots) == 2
    api = get_model(cfg)
    if arch == "hymba-1.5b":
        assert eng.cache["k"].shape[2] == min(cfg.sliding_window, max_seq)
    for idx in range(3):
        if idx not in slots:
            for name, leaf in eng.cache.items():
                assert not leaf[:, idx].any(), (name, idx)
            continue
        p = slots[idx]
        alone = api.init_cache(DenseLayout(1, max_seq), device="cpu")
        _, alone = api.prefill(eng.ctx, params, torch.from_numpy(p)[None],
                               torch.tensor([len(p)], dtype=torch.int32),
                               alone)
        assert set(alone) == set(eng.cache)
        for name, leaf in eng.cache.items():
            got, want = leaf[:, idx], alone[name][:, 0]
            if arch == "whisper-tiny" and name in ("k", "v"):
                # the self-attention cache past the prompt holds the
                # bucket's padding rows, which no step reads
                got, want = got[:, :len(p)], want[:, :len(p)]
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **TOL["float32"], err_msg=name)


class _BucketScratchEngine(Engine):
    """The dense family's one-shot prefill as it was: a scratch cache the
    prompt bucket wide, and only its k / v rows copied."""

    def _prefill_batched(self, items):
        seqs = {idx: state.prefill_tokens() for idx, state in items}
        padded = pow2_bucket(
            max(len(s) for s in seqs.values()), lo=eng_mod.PROMPT_BUCKET,
            hi=-(-self.max_seq // eng_mod.PROMPT_BUCKET)
            * eng_mod.PROMPT_BUCKET)
        toks = np.zeros((self.num_slots, padded), np.int32)
        lens = np.zeros((self.num_slots,), np.int32)
        for row, (idx, _) in enumerate(items):
            toks[row, :len(seqs[idx])] = seqs[idx]
            lens[row] = len(seqs[idx])
        scratch = self.api.init_cache(DenseLayout(self.num_slots, padded),
                                      device=self.device)
        logits, scratch = self.api.prefill(
            self.ctx, self.params, self._i32(toks), self._i32(lens), scratch)
        span = min(padded, self.max_seq)
        final = {}
        for row, (idx, _) in enumerate(items):
            for name in ("k", "v"):
                self.cache[name][:, idx, :span] = scratch[name][:, row, :span]
            final[idx] = logits[row:row + 1]
        return self._first_tokens(items, final)


def test_dense_family_is_bitwise_unchanged():
    cfg = configs.smoke(configs.get("qwen2-0.5b"))
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 500, size=n).astype(np.int32),
             SamplingParams(max_new_tokens=6)) for n in (70, 9, 33, 100, 5)]
    out, admitted = [], []
    for cls in (Engine, _BucketScratchEngine):
        kw = dict(num_slots=2, max_seq=112, prefill_chunk=0, device="cpu")
        out.append(cls(cfg, params, **kw).run(reqs))
        eng = cls(cfg, params, **kw)
        for p, sp in reqs[:2]:
            eng.submit(p, sp)
        eng._admit()
        admitted.append(eng)
    assert out[0] == out[1]
    new, old = admitted
    for idx, state in new.by_slot.items():
        n = len(state.prefill_tokens())
        for name in ("k", "v"):
            assert torch.equal(new.cache[name][:, idx, :n],
                               old.cache[name][:, idx, :n])


@pytest.mark.parametrize("arch,kw", [("whisper-tiny", {}),
                                     ("qwen2-0.5b", {"prefill_chunk": 0})],
                         ids=["whisper", "qwen2-one-shot"])
def test_bucket_past_max_seq_is_served(arch, kw):
    """A JAX-package fault the port does not copy: with ``max_seq`` not a
    multiple of 64 a prompt's bucket can pass it (70 tokens -> 128 >
    100), and the JAX engine's one-shot prefill then raises (its dense
    and encoder-decoder prefills pad the KV to ``max_seq`` by a negative
    amount). The port drops the bucket's padding rows past ``max_seq``;
    its tokens are the JAX engine's at a ``max_seq`` the bucket fits
    (f32)."""
    import jax

    from repro import configs as jconfigs
    from repro.models.api import get_model as jget_model
    from repro.serving.engine import Engine as JEngine
    from repro_torch.models.convert import params_from_numpy

    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(arch)), **F32)
    tcfg = dataclasses.replace(configs.smoke(configs.get(arch)), **F32)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    prompt = np.random.default_rng(9).integers(1, 500, size=70).astype(
        np.int32)
    with pytest.raises(ValueError, match="negative"):
        JEngine(jcfg, jp, num_slots=2, max_seq=100, **kw).run([prompt])
    want = JEngine(jcfg, jp, num_slots=2, max_seq=128, **kw).run([prompt])
    got = Engine(tcfg, tp, num_slots=2, max_seq=100, device="cpu",
                 **kw).run([prompt])
    assert got == want
