"""Quantize-at-load for GEMM weights: int8 / fp8 codes with one f32 step
per output channel.

The port of the JAX package's ``models/wquant.py``. At decode's small M
every layer GEMM is bound by its weight stream, so storing the weights in
1-byte codes halves the bytes a tick reads. A weight ``(…, K, N)`` is
quantized along K with one step per N column, ``step[n] = max_k |w[k,
n]| / qmax``; the step factors out of the GEMM's K sum, so the kernels
multiply it onto the f32 accumulator once, in the epilogue, and the bf16
weight never exists in device memory.

A quantized leaf is the plain dict ``{"codes": (…, K, N) int8 or
float8_e4m3fn, "scale": (…, N) f32}``: the stacked-L layer params slice
per layer through :mod:`repro_torch.models.stack`'s ``tree_map`` /
``unstack`` unchanged, and ``ops.*`` take the dict as the one signal that
a weight is quantized, so model call sites never change. Only the leaves
named in :data:`WEIGHT_KEYS` quantize; biases, norms, the embedding and
the LM head stay full precision.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant

# the GEMM weight leaves of the dense-transformer families
WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})


def is_quantized_leaf(w) -> bool:
    """True for the ``{"codes", "scale"}`` dict a quantized leaf becomes."""
    return isinstance(w, dict) and "codes" in w and "scale" in w


def quantize_weight(w: torch.Tensor, spec: quant.QuantSpec) -> dict:
    """One leaf ``(…, K, N)`` -> ``{"codes": (…, K, N), "scale": (…, N)}``:
    transposed to (…, N, K), the last-axis ``compute_step`` / ``encode``,
    the codes transposed back (contiguous)."""
    wt = torch.transpose(w, -1, -2)                   # (…, N, K)
    step = quant.compute_step(wt, spec, axes=-1)      # (…, N)
    codes = torch.transpose(quant.encode(wt, step, spec), -1, -2)
    return {"codes": codes.contiguous(), "scale": step.float()}


def dequantize_weight(wq: dict) -> torch.Tensor:
    """``codes * step`` back to a full (…, K, N) f32 weight (tests and
    error bounds; the serving path never materializes this)."""
    wt = quant.decode(torch.transpose(wq["codes"], -1, -2), wq["scale"])
    return torch.transpose(wt, -1, -2)


def quantize_params(params: dict, spec: quant.QuantSpec) -> dict:
    """Quantize every :data:`WEIGHT_KEYS` leaf under ``params["layers"]``.

    Returns a new tree; other leaves, and everything outside the layer
    stack, pass through by identity. Stacked leaves ``(L, K, N)``
    quantize per (layer, output channel); leaves that are quantized
    already pass through."""
    def walk(tree):
        if isinstance(tree, dict):
            return {key: (quantize_weight(v, spec)
                          if key in WEIGHT_KEYS and not isinstance(v, dict)
                          else walk(v))
                    for key, v in tree.items()}
        return tree

    out = dict(params)
    if "layers" in out:
        out["layers"] = walk(out["layers"])
    return out


def gemm_weight_bytes(params: dict) -> int:
    """Stored bytes of a decode tick's GEMM weight stream: every
    :data:`WEIGHT_KEYS` leaf under ``params["layers"]``, codes and scales
    as stored (bf16 leaves at full width). The embedding and LM head are
    excluded: they are not per-layer streams and never quantize."""
    total = 0

    def walk(tree):
        nonlocal total
        if not isinstance(tree, dict):
            return
        for key, v in tree.items():
            if key in WEIGHT_KEYS:
                if is_quantized_leaf(v):
                    total += v["codes"].nbytes + v["scale"].nbytes
                else:
                    total += v.nbytes
            elif isinstance(v, dict):
                walk(v)

    walk(params.get("layers", {}))
    return total
