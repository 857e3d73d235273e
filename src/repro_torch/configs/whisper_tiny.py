"""Whisper-tiny — enc-dec audio backbone; conv frontend STUB. [arXiv:2212.04356; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    source="arXiv:2212.04356; hf:openai/whisper-tiny",
)
