"""Grok-1 314B — MoE, 8 experts top-2, GQA kv=8. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    citation="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131_072,
    num_experts=8,
    top_k=2,
    activation="gelu",
)
