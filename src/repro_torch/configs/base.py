"""Config system for the AsyncFlow reproduction.

A single frozen dataclass describes every supported architecture family:
dense (GQA/MHA/MLA), MoE, SSM (mamba-1), hybrid (RG-LRU + local attention),
encoder-decoder (whisper) and VLM (vision-stub + LM backbone).

Configs are plain data — models are built from them in ``repro_torch.models.model``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (global, before sharding).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``arch_type`` selects the block assembly:
      dense   — homogeneous decoder blocks (attention + MLP)
      moe     — decoder blocks with MoE FFN (optionally shared experts)
      ssm     — attention-free mamba-1 blocks
      hybrid  — Griffin pattern: (recurrent, recurrent, local-attention) tiles
      audio   — whisper-style encoder-decoder (conv frontend stubbed)
      vlm     — LM backbone consuming stubbed vision patch embeddings
    """

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    citation: str

    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000

    # attention details
    attention: str = "gqa"  # gqa | mla
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention; >0 = window (tokens)
    local_window: int = 2048  # hybrid local-attention window
    # long-context decode policy: window applied only for the long_500k shape
    long_context_window: int = 16_384

    # MLA (DeepSeek-V2 / MiniCPM3 style)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # DeepSeek-V2's published MLA (each off by default, as the reference
    # computes it): RMSNorms on the q and kv latents; YaRN rotary on the
    # rope dims (factor > 1), its correction range from beta_fast/slow at
    # the original positions, and the softmax scale times
    # mscale(factor, mscale_all_dim)^2 (cos and sin stay unscaled: the
    # published mscale equals mscale_all_dim)
    mla_latent_norm: bool = False
    yarn_factor: float = 1.0
    yarn_original_positions: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # expert hidden dim (deepseek-style fine-grained)
    first_dense_layers: int = 0  # deepseek: first k layers dense
    router_aux_coef: float = 0.01
    moe_device_limit: int = 0  # >0: route each token to <=M device groups
    moe_ep_degree: int = 16    # device groups for device-limited routing
    # DeepSeek-V2's published gate and one chip's share of an expert
    # layer (defaults: today's gate, every expert held, capacity drops)
    moe_router_fp32: bool = False   # the gate's product in fp32
    moe_norm_topk: bool = True      # renormalise the top-k weights
    moe_routed_scale: float = 1.0   # routed_scaling_factor
    moe_held_first: int = 0         # this layer holds experts
    moe_held_experts: int = 0       # [first, first + held); 0 = all
    moe_dropless: bool = False      # dispatch every pick (serving)

    # SSM (mamba-1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model/16)
    ssm_chunk: int = 0    # >0: chunked selective scan (§Perf HC1)

    # hybrid (RG-LRU)
    rglru_block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    rnn_width: int = 0  # 0 -> d_model

    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_frames: int = 1500  # whisper 30s @ 50Hz after conv stride 2
    max_target_positions: int = 448
    learned_positions: bool = False

    # vlm
    vision_tokens: int = 1024  # stubbed patch embeddings per image
    vision_embed_dim: int = 0  # 0 -> d_model (projector output)

    # norm / activations / embeddings
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu (swiglu) | gelu
    tie_embeddings: bool = False

    # training
    lr_schedule: str = "cosine"  # cosine | wsd
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.vision_embed_dim == 0:
            object.__setattr__(self, "vision_embed_dim", self.d_model)
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", max(1, (self.d_model + 15) // 16))
        if self.arch_type == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived quantities -------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """long_500k applicability: SSM/hybrid natively; dense via the
        sliding-window variant; enc-dec (whisper) skipped (448 positions)."""
        return self.arch_type != "audio"

    @property
    def held_experts(self) -> range:
        """The routed experts an expert layer holds: all of them, or the
        share ``moe_held_experts`` from ``moe_held_first``."""
        n = self.moe_held_experts or self.num_experts
        return range(self.moe_held_first, self.moe_held_first + n)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Total parameter count (all experts)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        return _param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        changes = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads * 4 // self.num_heads)),
            head_dim=64,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_frames=32 if self.arch_type == "audio" else self.encoder_frames,
            vision_tokens=16 if self.arch_type == "vlm" else self.vision_tokens,
            local_window=64,
            long_context_window=64,
            rnn_width=0,  # re-derived from reduced d_model in __post_init__
        )
        if self.num_experts:
            changes.update(
                num_experts=4,
                top_k=min(2, self.top_k),
                moe_d_ff=128,
                num_shared_experts=min(1, self.num_shared_experts),
                first_dense_layers=min(1, self.first_dense_layers),
            )
        if self.attention == "mla":
            changes.update(
                kv_lora_rank=64, q_lora_rank=0,
                qk_rope_head_dim=32, qk_nope_head_dim=32, v_head_dim=32,
            )
        return dataclasses.replace(self, **changes)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)

    if cfg.attention == "mla":
        q_dim = nh * (cfg.qk_rope_head_dim + cfg.qk_nope_head_dim)
        attn = d * q_dim  # q proj (no q_lora here unless set)
        if cfg.q_lora_rank:
            attn = d * cfg.q_lora_rank + cfg.q_lora_rank * q_dim
        attn += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)  # kv down + k_rope
        attn += cfg.kv_lora_rank * nh * (cfg.qk_nope_head_dim + cfg.v_head_dim)
        attn += nh * cfg.v_head_dim * d  # o proj
    else:
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d

    def mlp_params(dff: int) -> int:
        mult = 3 if cfg.activation == "silu" else 2  # swiglu has gate
        return mult * d * dff

    if cfg.arch_type == "ssm":
        di, ds = cfg.d_inner, cfg.ssm_state
        blk = d * 2 * di + di * cfg.ssm_conv + di * (cfg.ssm_dt_rank + 2 * ds)
        blk += cfg.ssm_dt_rank * di + di * ds + di + di * d
        return emb + cfg.num_layers * blk

    if cfg.arch_type == "hybrid":
        w = cfg.rnn_width
        rec = d * 2 * w + w * 4 + 2 * w + w * d  # in-proj x2, conv-ish gates, out
        att = attn
        n_rec = sum(1 for _ in range(cfg.num_layers)
                    if cfg.rglru_block_pattern[_ % len(cfg.rglru_block_pattern)] == "recurrent")
        n_att = cfg.num_layers - n_rec
        return emb + n_rec * (rec + mlp_params(cfg.d_ff)) + n_att * (att + mlp_params(cfg.d_ff))

    if cfg.arch_type == "moe":
        dense_layers = cfg.first_dense_layers
        moe_layers = cfg.num_layers - dense_layers
        router = d * cfg.num_experts
        shared = cfg.num_shared_experts * mlp_params(cfg.moe_d_ff)
        experts_total = cfg.num_experts * mlp_params(cfg.moe_d_ff)
        experts_active = cfg.top_k * mlp_params(cfg.moe_d_ff)
        per_moe = attn + router + shared + (experts_active if active_only else experts_total)
        per_dense = attn + mlp_params(cfg.d_ff)
        return emb + moe_layers * per_moe + dense_layers * per_dense

    # dense / vlm / audio decoder
    per = attn + mlp_params(cfg.d_ff)
    n = cfg.num_layers
    total = emb + n * per
    if cfg.arch_type == "audio":
        enc_attn = 4 * d * d
        total += cfg.encoder_layers * (enc_attn + mlp_params(cfg.d_ff))
        total += cfg.num_layers * (4 * d * d)  # cross attention
    return total
