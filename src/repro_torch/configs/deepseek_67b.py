"""DeepSeek-67B — llama-architecture dense GQA, 95 layers. [arXiv:2401.02954; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
