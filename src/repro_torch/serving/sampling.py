"""Token sampling: greedy / temperature / top-k / top-p over vocab-padded
logits (the pad columns past ``vocab_size`` are masked here).

The engine drives this with a *per-request* ``torch.Generator`` seeded
from ``(seed, rid)``, so one request's sampling order can never perturb
another's. The JAX package's keys give other bits from the same seed:
greedy output matches across the two; sampled output matches only in
distribution.
"""
from __future__ import annotations

from typing import Optional

import torch


def _top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of tokens (by descending
    probability) whose cumulative probability reaches ``top_p``; the top
    token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs      # exclusive cumsum
    keep = cum_before < top_p
    kth = torch.where(keep, sorted_logits,
                      torch.full_like(sorted_logits, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < kth, float("-inf"))


def mask_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """f32 logits with the padded vocab tail at -inf."""
    logits = logits.float()
    if vocab_size and vocab_size < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab_size:] = float("-inf")
    return logits


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], *,
           temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
           vocab_size: int = 0) -> torch.Tensor:
    """logits (B, V_padded) -> (B,) int64 next tokens."""
    logits = mask_vocab(logits, vocab_size)
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        logits = _top_p_mask(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
