"""Frozen arithmetic: the model FLOPs of DeepSeek-V2's block (latent
attention, a dense first layer, shared experts and one chip's held
experts), from the program's counters and the configuration's widths.

``perfbench/core/flops.py`` counts dense GQA and Mamba-1 only, so the
MLA and MoE families are counted here. Products count 2 FLOPs per
multiply-add; norms, rotary, softmax and the embedding gather count
nothing. A live token (no padding, no idle slot) pays every layer's
latent projections (``W_uk``/``W_uv`` too: the prefill expands the
latent with them, the absorbed decode folds them into the query and the
output, the same products), the dense layer's MLP and each MoE layer's
shared experts and router; a pick routed to a held expert pays its
SwiGLU; a query-key pair pays the scores and the weighted sum, over
``dn + dr`` and ``dv`` in the prefill and over the latent's ``r + dr``
and ``r`` in the absorbed decode; an appended token pays the
unembedding once.
"""
from __future__ import annotations

from perfbench.core.flops import PEAK_BF16_FLOPS
from perfbench.core.registry import total


def _sizes(c: dict):
    return (c["d_model"], c["num_heads"], c["kv_lora_rank"],
            c["q_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"],
            c["v_head_dim"])


def attn_proj_flops(c: dict) -> float:
    """One token through one layer's latent projections."""
    d, H, r, qr, dr, dn, dv = _sizes(c)
    q = d * qr + qr * H * (dn + dr) if qr else d * H * (dn + dr)
    return 2.0 * (q + d * (r + dr) + r * H * (dn + dv) + H * dv * d)


def token_flops(c: dict) -> float:
    """One live token through every layer, held experts and attention
    pairs apart."""
    d, L, nd = c["d_model"], c["num_layers"], c["first_dense_layers"]
    shared = 6.0 * d * c["num_shared_experts"] * c["moe_d_ff"]
    router = 2.0 * d * c["num_experts"]
    return (L * attn_proj_flops(c) + nd * 6.0 * d * c["d_ff"]
            + (L - nd) * (shared + router))


def pick_flops(c: dict) -> float:
    """One pick through its held expert's SwiGLU (up, gate, down)."""
    return 6.0 * c["d_model"] * c["moe_d_ff"]


def pair_flops(c: dict, phase: str) -> float:
    """One query-key pair through every layer's attention."""
    d, H, r, qr, dr, dn, dv = _sizes(c)
    per = (2.0 * H * (r + dr) + 2.0 * H * r if phase == "decode"
           else 2.0 * H * (dn + dr) + 2.0 * H * dv)
    return c["num_layers"] * per


def unembed_flops(c: dict) -> float:
    return 2.0 * c["d_model"] * c["vocab_size"]


def model_flops(c: dict, delta: dict):
    """The window's model FLOPs from the registry's differences, or None
    where the program has no such counters."""
    if not any(n == "rollout_model_tokens_total" for n, _ in delta):
        return None
    fl = 0.0
    for ph in ("prefill", "decode"):
        fl += token_flops(c) * total(delta, "rollout_model_tokens_total",
                                     "value", phase=ph)
        fl += pair_flops(c, ph) * total(delta, "rollout_attended_pairs_total",
                                        "value", phase=ph)
    fl += pick_flops(c) * total(delta, "moe_held_picks_total", "value")
    fl += unembed_flops(c) * total(delta, "rollout_tokens_total", "value")
    return fl


def mfu(c: dict, delta: dict, window_s: float):
    """Model FLOPs over the window at the bf16 peak, in %, or None."""
    fl = model_flops(c, delta)
    if fl is None or window_s <= 0:
        return None
    return 100.0 * fl / (window_s * PEAK_BF16_FLOPS)
