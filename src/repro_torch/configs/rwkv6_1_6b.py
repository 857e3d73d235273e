"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,   # d_model / ssm head_dim — API bookkeeping only
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(state_size=64, head_dim=64),
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-1b6",
)
