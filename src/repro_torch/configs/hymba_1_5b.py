"""Hymba-1.5B — hybrid parallel attention+mamba heads. [arXiv:2411.13676; hf]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    sliding_window=1024,
    ssm=SSMConfig(state_size=16, head_dim=64, expand=2),
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
)
