"""InternVL2-26B — VLM: InternViT vision encoder (STUBBED; input_specs
provides projected patch embeddings) + InternLM2-20B language backbone.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    citation="arXiv:2404.16821 (InternVL2)",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    vision_tokens=1024,
)
