"""Write-time quantization of block-paged KV: the pool side of the
``kv_dtype`` precision (:mod:`repro_torch.kernels.quant` holds the
elementwise code math).

The port of the JAX package's ``serving/kvquant.py``. Beside the code
pools ``(NP, PS, HK, D)`` (int8 or float8_e4m3fn), each of K and V carries
an f32 step pool ``(NP, HK)``: one symmetric scale per (page, kv head).
Both ride in the cache dict as extra leaves (``k_scale`` / ``v_scale``),
so every page-indexed copy the engine makes (the COW fork) moves the
steps with the codes.

The scatter appends tokens as codes; each touched page's step is the
running amax / qmax over everything written to it while live:

  * **enters-at-zero reset**: a write that covers a page's position 0
    zeroes that page's step first, so a reused page never inherits a
    stale step (a zero old step then launders its stale codes to zero);
  * **monotone rescale**: when a write raises a page's amax, the page's
    codes are re-expressed under the new step; a ratio of exactly 1 is a
    bitwise no-op.

Codes are therefore a pure function of (page content, write partition),
and page-aligned writes equal one-shot :func:`quantize_pages`.

Unlike the JAX package, which returns new arrays, :meth:`QuantWrite.put`
updates the layer's views of the cache leaves in place, reads nothing
back to the host, and so runs inside a captured CUDA graph. Lanes that
the reference sends to the out-of-range index ``NP`` (``mode="drop"``)
are folded into the index the way :class:`~repro_torch.models.layers.
KVWrite` folds them, so they write nothing and never race a kept lane.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import quant
from repro_torch.models.layers import KVWrite

# cache leaf names of the step pools (present iff the pool is quantized)
K_SCALE = "k_scale"
V_SCALE = "v_scale"


def cache_is_quantized(cache: dict) -> bool:
    return K_SCALE in cache


@dataclasses.dataclass(frozen=True)
class QuantWrite:
    """Where one step's appended tokens land in a quantized pool, and
    which pages they touch: the index half of the scatter, the same for
    every layer of a step (the model builds it once per step, as it
    builds a :class:`KVWrite` for bf16 pools).

    ``tokens`` writes codes into the pool's ``(NP * PS, HK, D)`` rows;
    ``reset`` and ``pages`` write whole pages (the step pool's rows and
    the code pool's pages); ``span`` names each touched page (clamped
    into the pool) and ``tok_page`` / ``tok_lands`` each appended
    token's page and whether it lands (inside its chunk, on a real
    page)."""

    tokens: KVWrite
    reset: KVWrite
    pages: KVWrite
    span: torch.Tensor        # (B * S,) int64 touched pages, clamped
    tok_page: torch.Tensor    # (B * C,) int64 each token's page, clamped
    tok_lands: torch.Tensor   # (B * C,) bool

    @classmethod
    def build(cls, block_tables, lengths, chunk_lens, c: int,
              num_pages: int, page_size: int) -> "QuantWrite":
        """Row b appends its first ``chunk_lens[b]`` of ``c`` tokens at
        positions ``lengths[b]...`` through its block table; past
        ``chunk_lens``, and on the sentinel ``NP``, nothing lands."""
        np_, ps = num_pages, page_size
        dev = block_tables.device
        bt = block_tables.long()
        nb = bt.shape[1]
        lengths = lengths.to(dev).long()
        chunk_lens = chunk_lens.to(dev).long()
        ar = torch.arange(c, device=dev)
        pos = lengths[:, None] + ar[None, :]                      # (B, C)
        valid = ar[None, :] < chunk_lens[:, None]
        phys = torch.gather(bt, 1, (pos // ps).clamp(0, nb - 1))
        phys = torch.where(valid, phys, torch.full_like(phys, np_))

        # logical pages this write can touch: a static span bound
        nspan = (c + ps - 2) // ps + 1
        span_log = (lengths // ps)[:, None] + torch.arange(
            nspan, device=dev)[None, :]
        end = lengths + chunk_lens
        touched = ((span_log * ps < end[:, None]) & (chunk_lens[:, None] > 0)
                   & (span_log < nb))
        span_phys = torch.gather(bt, 1, span_log.clamp(0, nb - 1))
        span_phys = torch.where(touched, span_phys,
                                torch.full_like(span_phys, np_))
        # the write covers the page's position 0: it enters at zero
        entered = (span_log * ps >= lengths[:, None]) & touched
        lands = phys < np_
        span_lands = span_phys < np_
        return cls(
            tokens=KVWrite.build(phys * ps + pos % ps, lands, np_ * ps),
            reset=KVWrite.build(span_phys, entered & span_lands, np_),
            pages=KVWrite.build(span_phys, span_lands, np_),
            span=span_phys.reshape(-1).clamp(0, np_ - 1),
            tok_page=phys.reshape(-1).clamp(0, np_ - 1),
            tok_lands=lands.reshape(-1))

    def put(self, codes: torch.Tensor, steps: torch.Tensor,
            new: torch.Tensor) -> None:
        """Append ``new`` (B, C, HK, D) into one layer's code pool ``codes``
        (NP, PS, HK, D) and step pool ``steps`` (NP, HK), both contiguous,
        in place: the JAX package's seven steps in its order."""
        spec = quant.spec_for_dtype(codes.dtype)
        if spec is None:
            raise TypeError(f"quantized scatter needs int8 / float8_e4m3fn "
                            f"codes, got {codes.dtype}")
        np_, ps, hk, d = codes.shape
        b, c = new.shape[:2]
        nspan = self.span.shape[0] // b
        step_rows = steps.view(np_, hk, 1)
        # 1) enters-at-zero reset
        self.reset.put(step_rows, torch.zeros(
            (self.span.shape[0], hk, 1), dtype=steps.dtype,
            device=steps.device))
        # 2) each touched page's step as its current codes were encoded
        old_step = steps.index_select(0, self.span).view(b, nspan, hk)
        # 3) fold the chunk's per-token amax / qmax into the step pool
        # (scatter-max is order-free; a dropped lane adds 0.0, a no-op
        # since steps are >= 0)
        contrib = quant.compute_step(new, spec, axes=-1).reshape(-1, hk)
        contrib = torch.where(self.tok_lands[:, None], contrib,
                              torch.zeros_like(contrib))
        steps.scatter_reduce_(0, self.tok_page[:, None].expand(-1, hk),
                              contrib, "amax", include_self=True)
        # 4) the settled step of each touched page and appended token
        new_step = steps.index_select(0, self.span).view(b, nspan, hk)
        tok_step = steps.index_select(0, self.tok_page).view(b, c, hk)
        # 5) re-express each touched page's codes under its new step
        # codes move as uint8: bits, whatever ops the code dtype has on
        # this device
        u8 = codes.view(torch.uint8)
        old_codes = u8.index_select(0, self.span).view(codes.dtype).view(
            b, nspan, ps, hk, d)
        requant = quant.rescale_codes(old_codes, old_step[:, :, None, :],
                                      new_step[:, :, None, :], spec)
        # 6) the pages back, then 7) the new tokens on top
        self.pages.put(u8.view(np_, ps * hk, d), requant.view(torch.uint8))
        self.tokens.put(u8, quant.encode(new, tok_step, spec).view(
            torch.uint8))


def scatter_chunk_quantized(codes, steps, new, block_tables, lengths,
                            chunk_lens, spec: quant.QuantSpec):
    """Append a (possibly ragged) token chunk into one layer's quantized
    pools: the JAX function's arguments, with ``spec`` checked against the
    pool's code dtype. Updates ``codes`` and ``steps`` in place and
    returns them."""
    if quant.spec_for_dtype(codes.dtype) is not spec:
        raise TypeError(f"codes of dtype {codes.dtype} are not {spec.name}")
    QuantWrite.build(block_tables, lengths, chunk_lens, new.shape[1],
                     codes.shape[0], codes.shape[1]).put(codes, steps, new)
    return codes, steps


# ---------------------------------------------------------------------------
# Whole-page helpers (tests, the smoke, oracles)
# ---------------------------------------------------------------------------


def quantize_pages(x: torch.Tensor, spec: quant.QuantSpec):
    """One-shot quantization of full page slabs: x (..., PS, HK, D) ->
    (codes of the same shape, steps (..., HK)). Equals what the scatter
    leaves in a page written by one page-aligned chunk."""
    step = quant.compute_step(x, spec, axes=(-3, -1))
    return quant.encode(x, step[..., None, :], spec), step


def dequantize_pages(codes: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """f32 view of quantized page slabs: codes (..., PS, HK, D) * steps."""
    return quant.decode(codes, steps[..., None, :])
