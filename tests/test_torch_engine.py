"""The port's dense serving engine (repro_torch.serving.engine) on the CPU.

Parity: the port's Engine (default "cuda" plan — the kernels' plain
versions on CPU tensors) against the JAX package's Engine on the same
prompts with the same params (the reference's ``init_params(PRNGKey(0))``
carried across), in f32, with chunked prefill and with
``prefill_chunk=0``: identical greedy tokens and finish reasons.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.api import get_model as jget_model
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import FinishReason, SamplingParams

ARCH = "qwen2-0.5b"
F32 = dict(param_dtype="float32", activation_dtype="float32")


def _jax_side():
    cfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **F32)
    return cfg, jget_model(cfg).init_params(jax.random.PRNGKey(0))


def _port_cfg(**over):
    return dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **over)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, int(p)).astype(np.int32)
            for p in rng.integers(3, 90, n)]


@pytest.mark.parametrize("prefill_chunk", [16, 0])
def test_engine_matches_reference_greedy(prefill_chunk):
    jcfg, jparams = _jax_side()
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
    prompts = _prompts(5)
    budgets = [6, 3, 9, 1, 5]
    jeng = JEngine(jcfg, jparams, num_slots=2, max_seq=128,
                   prefill_chunk=prefill_chunk)
    want = jeng.run([(p, JSamplingParams(max_new_tokens=m))
                     for p, m in zip(prompts, budgets)])
    teng = Engine(_port_cfg(**F32), tparams, num_slots=2, max_seq=128,
                  prefill_chunk=prefill_chunk, device="cpu")
    got = teng.run([(p, SamplingParams(max_new_tokens=m))
                    for p, m in zip(prompts, budgets)])
    assert got == want
    assert teng.ticks == jeng.ticks
    for rid in want:
        assert (teng.finish_reason(rid).value
                == jeng.finish_reason(rid).value)


def _port_engine(**kw):
    cfg = _port_cfg()
    params = tget_model(cfg).init_params(torch.Generator().manual_seed(0),
                                         device="cpu")
    return Engine(cfg, params, device="cpu", **kw)


def test_engine_stop_token_and_finish_reason():
    """A sampled stop token ends the request with reason ``stop``; it joins
    the output only under ``include_stop=True`` and never burns budget.
    The stop is the first greedy token that differs from the first one,
    so it cannot fire at index 0."""
    prompt = np.random.default_rng(0).integers(1, 50, 8).astype(np.int32)
    probe = _port_engine(num_slots=1, max_seq=128)
    toks = probe.run([(prompt, SamplingParams(max_new_tokens=10))])[0]
    j = next((i for i, t in enumerate(toks) if t != toks[0]), None)
    assert j is not None, f"greedy output is constant: {toks}"
    stop = toks[j]
    eng = _port_engine(num_slots=1, max_seq=128)
    out = eng.run([
        (prompt, SamplingParams(max_new_tokens=10, stop_tokens=(stop,))),
        (prompt, SamplingParams(max_new_tokens=10, stop_tokens=(stop,),
                                include_stop=True)),
        (prompt, SamplingParams(max_new_tokens=10)),
    ])
    assert out[0] == toks[:j]
    assert out[1] == toks[:j + 1]
    assert out[2] == toks
    assert eng.finish_reason(0) is FinishReason.STOP
    assert eng.finish_reason(1) is FinishReason.STOP
    assert eng.finish_reason(2) is FinishReason.LENGTH
    for rid in out:
        streamed = [e.token for e in eng.requests[rid].events
                    if e.token is not None]
        assert streamed == out[rid], rid
    assert eng.requests[0].events[-1].token is None


def test_engine_sampling_is_per_request_and_seeded():
    """Sampled output depends only on the request's own generator: the
    same (seed, rid) repeats exactly, batch-mates do not perturb it, and
    top_k=1 is greedy."""
    prompts = _prompts(3, seed=1)
    sp = SamplingParams(max_new_tokens=6, temperature=1.0)
    a = _port_engine(num_slots=3, max_seq=128, seed=7).run(
        [(p, sp) for p in prompts])
    b = _port_engine(num_slots=1, max_seq=128, seed=7).run(
        [(p, sp) for p in prompts])
    assert a == b
    c = _port_engine(num_slots=3, max_seq=128, seed=8).run(
        [(p, sp) for p in prompts])
    assert c != a
    greedy = _port_engine(num_slots=3, max_seq=128).run(
        [(p, SamplingParams(max_new_tokens=6)) for p in prompts])
    topk1 = _port_engine(num_slots=3, max_seq=128).run(
        [(p, SamplingParams(max_new_tokens=6, temperature=0.7, top_k=1))
         for p in prompts])
    assert topk1 == greedy


def test_engine_generate_and_abort():
    eng = _port_engine(num_slots=2, max_seq=128)
    prompt = _prompts(1)[0]
    events = list(eng.generate(prompt, SamplingParams(max_new_tokens=4)))
    assert [e.index for e in events] == [0, 1, 2, 3]
    assert events[-1].finished and events[-1].finish_reason.value == "length"
    rid = eng.submit(prompt, SamplingParams(max_new_tokens=50))
    eng.step()
    assert eng.abort(rid)
    assert eng.finish_reason(rid) is FinishReason.ABORT
    assert not eng.by_slot and not eng.abort(rid)


def test_engine_defaults_to_cuda_and_raises_without_it():
    """Entry points run on the card unless told otherwise; on a machine
    without CUDA they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    cfg = _port_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tget_model(cfg).init_params()
    params = tget_model(cfg).init_params(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params)
    with pytest.raises(NotImplementedError, match="paged"):
        Engine(cfg, params, cache_kind="paged", device="cpu")


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-seq", "96", "--max-new", "3",
                       "--prompt-len", "20", "--prefill-chunk", "0"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    assert out.count("  req ") == 3
