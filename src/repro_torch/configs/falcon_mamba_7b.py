"""Falcon-Mamba-7B — attention-free mamba-1 SSM. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    citation="arXiv:2410.05355 (Falcon Mamba)",
    num_layers=64,
    d_model=4096,
    num_heads=1,
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
