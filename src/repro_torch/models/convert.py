"""Carry the JAX package's params into the port.

:func:`params_from_numpy` takes the reference's param tree as a nested
dict of numpy arrays (``jax.device_get`` of ``init_params``) and returns
the port's tree leaf by leaf under the same names and shapes — both keep
layer params stacked on a leading L axis. bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(tree)
