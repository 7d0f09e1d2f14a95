"""RecurrentGemma-9B — Griffin hybrid: RG-LRU recurrent blocks + local
attention in a 2:1 pattern. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    citation="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    rglru_block_pattern=("recurrent", "recurrent", "attention"),
    rnn_width=4096,
    local_window=2048,
    activation="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)
