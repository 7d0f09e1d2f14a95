"""Qwen2.5-32B — the paper's large evaluation model. [arXiv:2412.15115]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    arch_type="dense",
    citation="arXiv:2412.15115 (Qwen2.5); AsyncFlow §6.1",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152_064,
    qkv_bias=True,
)
