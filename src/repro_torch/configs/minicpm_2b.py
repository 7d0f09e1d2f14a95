"""MiniCPM-2B — llama-like dense decoder trained with the WSD
(warmup-stable-decay) schedule. [arXiv:2404.06395]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    citation="arXiv:2404.06395 (MiniCPM)",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    lr_schedule="wsd",
    tie_embeddings=True,
)
