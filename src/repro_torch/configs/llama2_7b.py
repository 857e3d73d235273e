"""Llama2-7B — the paper's own evaluation model (Table 2). [arXiv:2307.09288]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    head_dim=128,
    source="arXiv:2307.09288; paper Table 2",
)
