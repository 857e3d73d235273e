"""Three-term roofline from dry-run counts (one H100 SXM a chip).

  compute    = FLOPs            / (chips x peak bf16 FLOP/s)
  memory     = bytes            / (chips x HBM bandwidth)
  collective = collective bytes / (chips x NVLINK_BW)

On a mesh the collective bytes are a rank's counted bytes times the chips
(the dry run's records keep the rank's), so the term is a rank's bytes
over one card's NVLink rate.

The port of the JAX package's ``repro.analysis.roofline``. FLOPs, bytes
and collective bytes come from :mod:`repro_torch.analysis.cost`, counted
by the dry run (``repro_torch.launch.dryrun``) over two probes of one and
three layers, which this module decomposes linearly,

  total(L) = outside + L x per_layer,

exact since every layer is identical. The peaks are the card's datasheet
figures (``hardware.H100_SXM``), so every term is a bound, not a
measurement. :func:`bound` gives one kernel's least time on the same
definitions (``chip_smoke.py``'s kernel table).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch import hardware
from repro_torch.config import ModelConfig, ShapeConfig

# NVLink 4 on the H100 SXM: 900 GB/s a card over its 18 links, 450 GB/s a
# direction (NVIDIA H100 data sheet). Kept here, not in HardwareSpec: the
# spec's fields hash into every tuned plan's provenance. It is taken for
# every hop: on the pod meshes (16 x 16, 2 x 16 x 16) a 16-rank ``model``
# group spans two 8-card NVLink nodes and the batch groups span many, whose
# hops between nodes run at the network's rate, far below NVLink's, so
# the collective term is a lower bound there.
NVLINK_BW = 450e9


@dataclasses.dataclass
class ProbeCost:
    """Counted cost of one probe; all values are global (all chips)."""

    num_layers: int
    flops: float
    bytes_accessed: float
    collective_bytes: float


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float       # MODEL_FLOPS / counted FLOPs
    bottleneck: str
    bound_s: float            # max of the three terms
    per_device_bytes: Optional[int] = None  # from the full-depth run

    def to_dict(self):
        return dataclasses.asdict(self)


def extrapolate(probes: list[ProbeCost], num_layers: int) -> ProbeCost:
    """Linear L-decomposition from two probes; exact for identical layers.

    Collective bytes keep the JAX package's clamping (a per-layer slope
    and a depth-0 intercept below 0 become 0): there a partitioner could
    change strategy between probe depths; here it is a guard only."""
    if len(probes) < 2:
        raise ValueError("extrapolate needs two probes")
    a, b = probes[0], probes[-1]
    dl = b.num_layers - a.num_layers
    if dl <= 0:
        raise ValueError("the last probe must be deeper than the first")

    def project(va: float, vb: float, *, clamp: bool) -> float:
        per_layer = (vb - va) / dl
        if clamp:
            per_layer = max(per_layer, 0.0)
        out = va - a.num_layers * per_layer
        if clamp:
            out = max(out, 0.0)
        return out + num_layers * per_layer

    return ProbeCost(
        num_layers=num_layers,
        flops=project(a.flops, b.flops, clamp=False),
        bytes_accessed=project(a.bytes_accessed, b.bytes_accessed,
                               clamp=False),
        collective_bytes=project(a.collective_bytes, b.collective_bytes,
                                 clamp=True),
    )


def model_flops_estimate(
    *, params_active: int, tokens: int, kind: str,
    kv_len: int = 0, num_layers: int = 0, d_model: int = 0,
    num_kv_heads: int = 0, head_dim: int = 0, num_q_heads: int = 0,
    seq_len: int = 0,
) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for fwd-only (+ attention).

    Attention score/value FLOPs are added explicitly since 6ND ignores them
    (they matter at 32k+ context).
    """
    base = (6.0 if kind == "train" else 2.0) * params_active * tokens
    attn = 0.0
    if num_layers and num_q_heads:
        if kind == "decode":
            # one new token vs kv_len cache
            attn = (
                num_layers * tokens * num_q_heads * head_dim * kv_len * 2 * 2.0
            )
        else:
            # causal prefill/train: S^2/2 per head pair, x2 matmuls
            attn = (
                num_layers * tokens * num_q_heads * head_dim * seq_len * 0.5
                * 2 * 2.0
            )
            if kind == "train":
                attn *= 3  # fwd + 2x bwd
    return base + attn


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """A cell's MODEL_FLOPS, as the JAX package's roofline report takes
    them: active params over the cell's tokens, plus the attention of the
    softmax-attention archs (a sliding window caps its length)."""
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = b if kind == "decode" else b * s
    kv_len = s if kind == "decode" else 0
    seq_for_attn = s
    if cfg.sliding_window:
        seq_for_attn = min(s, cfg.sliding_window)
        kv_len = min(kv_len, cfg.sliding_window)
    return model_flops_estimate(
        params_active=cfg.active_param_count(),
        tokens=tokens, kind=kind, kv_len=kv_len,
        num_layers=cfg.num_layers + cfg.encoder_layers,
        d_model=cfg.d_model, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        num_q_heads=cfg.num_heads if cfg.has_softmax_attention else 0,
        seq_len=seq_for_attn,
    )


def terms_from(
    *, arch: str, shape: str, mesh: str, chips: int,
    cost: ProbeCost, model_flops: float,
    per_device_bytes: Optional[int] = None,
    spec: hardware.HardwareSpec = hardware.H100_SXM,
) -> RooflineTerms:
    compute_s = cost.flops / (chips * spec.peak_flops_bf16)
    memory_s = cost.bytes_accessed / (chips * spec.hbm_bw)
    collective_s = cost.collective_bytes / (chips * NVLINK_BW)
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    bottleneck = max(terms, key=terms.get)
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=model_flops,
        useful_ratio=model_flops / cost.flops if cost.flops else 0.0,
        bottleneck=bottleneck, bound_s=terms[bottleneck],
        per_device_bytes=per_device_bytes,
    )


def bound(nbytes: float, flops: float,
          spec: hardware.HardwareSpec = hardware.H100_SXM
          ) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time one card takes
    to move ``nbytes`` and do ``flops``, and which of the two bounds it
    (ties go to bytes)."""
    t = terms_from(arch="", shape="", mesh="1", chips=1,
                   cost=ProbeCost(0, flops, nbytes, 0.0), model_flops=flops,
                   spec=spec)
    return (max(t.memory_s, t.compute_s),
            "bytes" if t.memory_s >= t.compute_s else "operations")


def save_report(path: str, rows: list[RooflineTerms]) -> None:
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in rows], f, indent=2)


def load_report(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def format_table(rows: list[dict]) -> str:
    hdr = (
        f"{'arch':<16}{'shape':<13}{'mesh':<10}{'compute_s':>12}"
        f"{'memory_s':>12}{'collect_s':>12}{'bottleneck':>12}"
        f"{'useful':>8}{'GB/dev':>8}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        gb = (r.get("per_device_bytes") or 0) / 2**30
        lines.append(
            f"{r['arch']:<16}{r['shape']:<13}{r['mesh']:<10}"
            f"{r['compute_s']:>12.4e}{r['memory_s']:>12.4e}"
            f"{r['collective_s']:>12.4e}{r['bottleneck']:>12}"
            f"{r['useful_ratio']:>8.2f}{gb:>8.2f}"
        )
    return "\n".join(lines)
