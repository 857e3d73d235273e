"""φ calibration — choosing the unified max value per model (paper Fig. 5).

The paper picks φ from the empirical distribution of pre-softmax logits
(``x_i``) of each model: Llama2-7B logits concentrate in a narrow band, so a
static φ plus a safety band ``[a, b]`` covers >99.99 % of rows; OPT-6.7B's
range is too wide and the technique is disabled for it.

The workflow:
  * :class:`LogitStats` — streaming min/max/mean/var stats accumulated
    over calibration batches (``update`` takes a tensor).
  * :func:`calibrate` — turns stats into a :class:`SoftmaxPhiConfig`;
    disables T1 when the observed range exceeds what one exp band can hold
    (the OPT case).
  * per-arch defaults in :data:`PHI_REGISTRY` — attention logits of trained
    RoPE transformers land in a small band around 0; archs not calibrated
    here get a conservative φ=0 with a wide f32-safe band.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from repro_torch.config import SoftmaxPhiConfig

# exp() in f32 is finite below ~88.7; keep headroom for the Σ over kv_len
# (a 512k context: ln(2^19) ≈ 13.2) and for bf16 intermediates.
F32_EXP_SAFE = 80.0


@dataclasses.dataclass
class LogitStats:
    count: int = 0
    minimum: float = float("inf")
    maximum: float = float("-inf")
    mean: float = 0.0
    m2: float = 0.0  # Welford

    def update(self, x: torch.Tensor) -> "LogitStats":
        x = torch.as_tensor(x).detach().to(torch.float32).reshape(-1)
        n = int(x.numel())
        if n == 0:
            return self
        mn = float(x.min())
        mx = float(x.max())
        mu = float(x.mean())
        var = float(x.var(correction=0))
        # Chan parallel-variance merge
        tot = self.count + n
        delta = mu - self.mean
        new_mean = self.mean + delta * n / tot if tot else mu
        new_m2 = self.m2 + var * n + delta**2 * self.count * n / tot
        return LogitStats(
            count=tot,
            minimum=min(self.minimum, mn),
            maximum=max(self.maximum, mx),
            mean=new_mean,
            m2=new_m2,
        )

    @property
    def std(self) -> float:
        return (self.m2 / self.count) ** 0.5 if self.count else 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "LogitStats":
        return LogitStats(**json.loads(s))


def calibrate(
    stats: LogitStats,
    *,
    sigma: float = 6.0,
    safe: float = F32_EXP_SAFE,
) -> SoftmaxPhiConfig:
    """Derive (φ, band) from calibration stats, or disable T1 (the OPT case).

    φ is centered on the observed mean; the band is ``±max(sigma·std,
    observed range)`` with margin. If that band cannot fit inside the
    f32-safe exponent range, the unified-max technique is disabled and the
    engine uses the synchronized scheme everywhere — what the paper does
    for OPT-6.7B.
    """
    if stats.count == 0:
        return SoftmaxPhiConfig(phi=0.0, band=(-safe, safe), enabled=True)
    phi = stats.mean
    half = max(sigma * stats.std, stats.maximum - phi, phi - stats.minimum)
    half *= 1.25  # margin
    if half > safe:
        return SoftmaxPhiConfig(phi=None, band=(-safe, safe), enabled=False)
    # keep a wide-but-safe band: false fallbacks are cheap, overflow is not
    half = max(half, 8.0)
    return SoftmaxPhiConfig(phi=float(phi), band=(-float(half), float(half)))


def collect_attention_logit_stats(
    q: torch.Tensor, k: torch.Tensor, *, scale: Optional[float] = None,
    stats: Optional[LogitStats] = None,
) -> LogitStats:
    """Accumulate stats over one batch of attention logits (calibration).

    q: (..., S, HQ, D); k: (..., S, HK, D) — GQA-aware (kv heads repeated
    for their query-head groups). The logits are taken in f32.
    """
    d = q.shape[-1]
    groups = q.shape[-2] // k.shape[-2]
    if groups > 1:
        k = torch.repeat_interleave(k, groups, dim=-2)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("...qhd,...khd->...hqk", q.float() * scale, k.float())
    return (stats or LogitStats()).update(s)


# Per-arch defaults. Trained-transformer attention logits sit in a narrow
# band; without real weights the conservative φ=0 wide band ships (still
# exercising the async dataflow) with the calibration tool for refining
# it on the card. ``None`` φ = T1 disabled (the paper's OPT case).
PHI_REGISTRY: dict[str, SoftmaxPhiConfig] = {
    "default": SoftmaxPhiConfig(phi=0.0, band=(-F32_EXP_SAFE, F32_EXP_SAFE)),
    "llama2-7b": SoftmaxPhiConfig(phi=0.0, band=(-16.0, 16.0)),
    "opt-6.7b": SoftmaxPhiConfig(phi=None, enabled=False),
}


def phi_for(arch: str) -> SoftmaxPhiConfig:
    return PHI_REGISTRY.get(arch, PHI_REGISTRY["default"])
