"""DeepSeek-V2 236B — MoE with MLA. 2 shared + 160 routed experts top-6,
kv_lora_rank=512, fine-grained experts d_ff=1536. [arXiv:2405.04434]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    citation="arXiv:2405.04434 (DeepSeek-V2)",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,  # dense layers (first_dense_layers)
    moe_d_ff=1536,
    vocab_size=102_400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
)
