"""Qwen2.5-7B — the paper's primary evaluation model. [arXiv:2412.15115]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    arch_type="dense",
    citation="arXiv:2412.15115 (Qwen2.5); AsyncFlow §6.1",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
)
