"""The moe family's small sizes for the CPU tests, beside the dense
family's in ``tiny.py``, so that every configuration of
``BENCHMARK.json`` has a small cell: DeepSeek-V2's block at d 64, 4
heads, latent 32 + 16, q_lora 48, 16 experts in 4 groups (top 2 groups,
top 4 experts), 4 held, one shared, 1 dense + 2 MoE layers."""
from perfbench.tests import tiny

TINY_MOE = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                head_dim=16, d_ff=96, vocab_size=512, kv_lora_rank=32,
                q_lora_rank=48, qk_rope_head_dim=16, qk_nope_head_dim=16,
                v_head_dim=16, num_experts=16, moe_ep_degree=4,
                moe_device_limit=2, top_k=4, moe_held_experts=4,
                num_shared_experts=1, moe_d_ff=32)

tiny.TINY_PORT.setdefault("moe", TINY_MOE)
