"""Carry the JAX package's params, or a KV cache, into the port.

:func:`params_from_numpy` takes a reference tree as a nested dict of
numpy arrays (``jax.device_get`` of ``init_params``, or of a cache from
``init_cache`` and the steps after it) and returns the port's tree leaf
by leaf under the same names and shapes — both keep layer params and
cache leaves stacked on a leading L axis — for every family (the
encoder-decoder's ``enc_layers``, the recurrent families' f32 decay and
SSM leaves and their state caches alike). bfloat16 and float8_e4m3fn
leaves (numpy's ``ml_dtypes`` types, which torch cannot read) are
reinterpreted bit for bit, so a quantized weight's ``{"codes", "scale"}``
dict and a quantized pool's int8 / fp8 codes with their f32
``k_scale`` / ``v_scale`` steps convert through the same recursion with
every bit unchanged.

:func:`state_from_numpy` / :func:`state_to_numpy` carry a training state
(step, params and the AdamW moments) across in either direction, leaf
for leaf and bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


# ml_dtypes leaves: (bit container, torch dtype)
_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in _BITCAST:
        bits, dtype = _BITCAST[a.dtype.name]
        t = torch.from_numpy(np.ascontiguousarray(a).view(bits).copy())
        return t.view(dtype).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(tree)


def state_from_numpy(state, device="cuda"):
    """The JAX package's ``TrainState`` with numpy leaves (``jax.
    device_get`` of one) -> the port's, on ``device``."""
    from repro_torch.training.train_state import TrainState
    return TrainState(step=_leaf(state.step, resolve(device)),
                      params=params_from_numpy(state.params, device),
                      m=params_from_numpy(state.m, device),
                      v=params_from_numpy(state.v, device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 / fp8 as numpy's ``ml_dtypes`` types (imported
    here: only a caller carrying state to the JAX package needs them)."""
    import ml_dtypes
    t = t.detach().to("cpu", copy=True)
    for name, (bits, dtype) in _BITCAST.items():
        if t.dtype == dtype:
            wide = torch.int16 if bits == np.uint16 else torch.uint8
            return t.view(wide).numpy().view(bits).view(
                getattr(ml_dtypes, name))
    return t.numpy()


def state_to_numpy(state) -> dict:
    """The port's ``TrainState`` -> ``{"step", "params", "m", "v"}`` with
    numpy leaves, for the JAX package's ``TrainState(**...)``."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _numpy(node)

    return {name: conv(getattr(state, name))
            for name in ("step", "params", "m", "v")}
