"""InternVL2-76B — InternViT (STUB) + LLaMA3-70B-style LM backbone. [arXiv:2404.16821; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    frontend="vision",
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-Llama3-76B",
)
