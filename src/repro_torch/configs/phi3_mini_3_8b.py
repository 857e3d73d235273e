"""Phi-3-mini 3.8B — RoPE SwiGLU, MHA-equal GQA (kv=32). [arXiv:2404.14219; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    source="arXiv:2404.14219; hf:microsoft/Phi-3-mini-4k-instruct",
)
