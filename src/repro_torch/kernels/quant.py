"""Symmetric 8-bit quantization primitives (int8 and fp8 e4m3 codes).

The port of the JAX package's ``kernels/quant.py``, expression for
expression, so that codes and steps come out bitwise equal to the
reference's. One f32 "step" scales a group of values (a (page, kv head)
of a KV page, or one output channel of a GEMM weight,
:mod:`repro_torch.models.wquant`): ``step = amax / qmax``, the codes are
the scaled values rounded into the code dtype, and dequantization is the
elementwise ``codes.float() * step``, cheap enough to run on a kernel's
f32 accumulator or in its registers.

Three precisions:

  * ``bf16`` — passthrough: no codes, no steps.
  * ``int8`` — 8-bit symmetric integers, qmax 127, round half to even.
  * ``fp8``  — ``torch.float8_e4m3fn``, qmax 448 (the format's largest
    finite value); the cast itself rounds (to nearest even).

A step of exactly 0.0 marks an all-zero group: its codes are zero and
decode to zeros. CPU tensors have no float8 arithmetic, so every
expression here casts codes to f32 before it computes with them.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

KV_DTYPES = ("bf16", "int8", "fp8")


def fp8_supported() -> bool:
    """True when this torch can store and cast float8_e4m3fn tensors."""
    return _fp8_probe()


@functools.lru_cache(maxsize=1)
def _fp8_probe() -> bool:
    try:
        z = torch.zeros((2,), dtype=torch.float8_e4m3fn)
        _ = (z.float() + 1.0).to(torch.float8_e4m3fn)
        return True
    except (AttributeError, RuntimeError, TypeError):
        return False


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one code format."""
    name: str
    qmax: float          # largest representable |code|
    is_int: bool         # integer codes (explicit round + clip) vs fp8 cast

    @property
    def code_dtype(self) -> torch.dtype:
        return torch.int8 if self.is_int else torch.float8_e4m3fn


INT8 = QuantSpec(name="int8", qmax=127.0, is_int=True)
FP8 = QuantSpec(name="fp8", qmax=448.0, is_int=False)

_BY_NAME = {"int8": INT8, "fp8": FP8}


def spec_for(name: str) -> QuantSpec | None:
    """QuantSpec for a dtype name; None for the bf16 passthrough."""
    if name == "bf16":
        return None
    if name not in _BY_NAME:
        raise ValueError(f"unknown kv_dtype {name!r}; expected {KV_DTYPES}")
    if name == "fp8" and not fp8_supported():
        raise ValueError("'fp8' needs float8_e4m3fn support in this torch")
    return _BY_NAME[name]


def spec_for_dtype(dtype: torch.dtype) -> QuantSpec | None:
    """QuantSpec from a stored tensor's dtype (None = full precision)."""
    if dtype == torch.int8:
        return INT8
    if fp8_supported() and dtype == torch.float8_e4m3fn:
        return FP8
    return None


# ---------------------------------------------------------------------------
# Elementwise primitives. Convention: ``x`` is (..., D) full-precision and
# ``step`` broadcasts against ``x.shape[:-1]`` (one step per group, shared
# across the last axis).
# ---------------------------------------------------------------------------


def compute_step(x: torch.Tensor, spec: QuantSpec, axes) -> torch.Tensor:
    """amax/qmax over ``axes`` (f32). Zero input -> step exactly 0.0.

    The divisor is a tensor on purpose: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which can differ from the
    correctly rounded quotient in the last bit; tensor by tensor it is a
    true division on every device, so the card's steps are the CPU's and
    the reference's bit for bit."""
    amax = torch.amax(torch.abs(x.float()), dim=axes)
    return amax / torch.full_like(amax, spec.qmax)


def encode(x: torch.Tensor, step: torch.Tensor,
           spec: QuantSpec) -> torch.Tensor:
    """Quantize ``x`` under ``step`` into the code dtype. ``step == 0``
    rows encode through a divisor of 1.0; their content is all zeros, so
    the codes come out zero too."""
    x = x.float()
    safe = torch.where(step > 0.0, step, 1.0)[..., None]
    y = torch.clamp(x / safe, -spec.qmax, spec.qmax)
    if spec.is_int:
        return torch.round(y).to(torch.int8)
    return y.to(torch.float8_e4m3fn)


def decode(codes: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Dequantize codes back to f32: ``codes * step`` elementwise, the one
    dequant expression every kernel's plain version also uses."""
    return codes.float() * step[..., None].float()


def rescale_codes(codes: torch.Tensor, old_step: torch.Tensor,
                  new_step: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Re-express codes quantized under ``old_step`` in ``new_step`` units.

    A ratio of 1 is exact (codes round-trip through f32 unchanged for int8
    and fp8), so untouched groups are bitwise stable; ``old_step == 0``
    (a fresh group) forces ratio 0, zeroing stale codes."""
    ratio = torch.where(new_step > 0.0,
                        old_step / torch.where(new_step > 0.0, new_step, 1.0),
                        torch.where(old_step > 0.0, 1.0, 0.0))
    y = codes.float() * ratio[..., None]
    if spec.is_int:
        return torch.round(torch.clamp(y, -spec.qmax, spec.qmax)).to(
            torch.int8)
    return torch.clamp(y, -spec.qmax, spec.qmax).to(torch.float8_e4m3fn)


def logits_guard_tol(spec: QuantSpec) -> float:
    """Relative logit tolerance of the quantized paths' accuracy guard.

    Quantization perturbs each stored element by at most its format's
    half-step relative error (``0.5/qmax`` for int8, half an ulp, ``2^-4``,
    for fp8 e4m3 normals); logits move by a small multiple of that at logit
    scale, and the 64x headroom covers its passage through the softmax.
    Use as ``atol = logits_guard_tol(spec) * max(|logits|_max, 1.0)``.
    """
    rel = 0.5 / spec.qmax if spec.is_int else 2.0 ** -4
    return 64.0 * rel


def roundtrip_bound(x: torch.Tensor, step: torch.Tensor,
                    spec: QuantSpec) -> torch.Tensor:
    """Analytic elementwise bound on ``|decode(encode(x)) - x|``.

    int8: half a step. fp8 e4m3: half-ulp relative error for normals
    (2^-4 of the magnitude) with an absolute floor of half the subnormal
    quantum (2^-10) in scaled units."""
    step_b = step[..., None].float()
    if spec.is_int:
        return 0.5 * step_b * torch.ones_like(x, dtype=torch.float32)
    return torch.maximum(torch.abs(x.float()) * 2.0 ** -4,
                         step_b * 2.0 ** -10)
