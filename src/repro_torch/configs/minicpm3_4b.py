"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    citation="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    attention="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_rope_head_dim=32,
    qk_nope_head_dim=64,
    v_head_dim=64,
    tie_embeddings=True,
)
