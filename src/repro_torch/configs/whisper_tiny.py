"""Whisper-tiny — encoder-decoder audio transformer backbone; mel+conv
frontend is STUBBED per assignment (input_specs provides frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    citation="arXiv:2212.04356 (Whisper)",
    num_layers=4,
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    encoder_frames=1500,
    max_target_positions=448,
    learned_positions=True,
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
)
