"""Assigned architectures (public literature) + the paper's own model.

One module per arch; ``REGISTRY`` maps the assignment's ``--arch`` ids
(dashes) to :class:`~repro_torch.config.ModelConfig`. ``smoke(cfg)`` derives the
reduced same-family config used by the per-arch CPU smoke tests (the full
configs are only exercised via the dry-run's ShapeDtypeStructs).
"""
from __future__ import annotations

import dataclasses

from repro_torch.config import ModelConfig, MoEConfig, SSMConfig

from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_05B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.phi3_mini_3_8b import CONFIG as PHI3_MINI
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.internvl2_76b import CONFIG as INTERNVL2_76B
from repro_torch.configs.grok_1_314b import CONFIG as GROK_1
from repro_torch.configs.dbrx_132b import CONFIG as DBRX
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
from repro_torch.configs.llama2_7b import CONFIG as LLAMA2_7B

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        QWEN2_05B, MINITRON_8B, DEEPSEEK_67B, PHI3_MINI, WHISPER_TINY,
        INTERNVL2_76B, GROK_1, DBRX, HYMBA, RWKV6, LLAMA2_7B,
    )
}

ASSIGNED = [
    "qwen2-0.5b", "minitron-8b", "deepseek-67b", "phi3-mini-3.8b",
    "whisper-tiny", "internvl2-76b", "grok-1-314b", "dbrx-132b",
    "hymba-1.5b", "rwkv6-1.6b",
]


def get(name: str) -> ModelConfig:
    return REGISTRY[name]


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kv = min(cfg.num_kv_heads, 2)
    heads = max(kv * 2, 4) if cfg.family != "ssm" else 2
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv if cfg.family != "ssm" else heads,
        head_dim=128 // heads if cfg.family != "ssm" else 0,
        d_ff=256,
        vocab_size=512,
        max_seq_len=4096,
    )
    if cfg.moe is not None:
        updates["moe"] = MoEConfig(
            num_experts=4,
            num_experts_per_tok=min(2, cfg.moe.num_experts_per_tok),
        )
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(
            state_size=cfg.ssm.state_size, head_dim=64, expand=2
        )
        updates["d_model"] = 128
        if cfg.family == "ssm":
            updates["num_heads"] = 2
            updates["num_kv_heads"] = 2
            updates["head_dim"] = 0
    if cfg.encoder_layers:
        updates["encoder_layers"] = 2
    if cfg.sliding_window:
        updates["sliding_window"] = 64
    return dataclasses.replace(cfg, **updates)
