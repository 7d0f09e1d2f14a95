"""StableLM-2-12B — dense decoder, GQA kv=8. [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    citation="hf:stabilityai/stablelm-2-1_6b (family card)",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100_352,
    norm="layernorm",
    activation="silu",
)
