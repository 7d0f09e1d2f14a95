"""Hybrid cost model (paper §4.3): the analytical half.

Closed-form FLOP / HBM-byte / collective-byte volumes per architecture and
step kind, parameterized by mesh shape. Used by
  * the roofline analysis (EXPERIMENTS.md §Roofline) — the CPU backend's
    ``cost_analysis()`` cannot multiply while-loop (layer-scan) bodies by
    their trip counts, so analytic volumes are the ground truth, cross-
    validated against an unrolled lowering on small configs;
  * the resource planner / discrete-event simulator (Fig. 10 scaling).

Assumptions (documented in EXPERIMENTS.md):
  * bf16 compute (2 bytes) for weights/activations, fp32 (4 B) optimizer;
  * flash attention on the card — no O(S²) HBM traffic for attention;
  * backward = 2x forward FLOPs; optimizer = elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card hardware constants of one NVIDIA H100 80GB HBM3 (SXM) at
    its 700 W power limit. A card set to a lower limit runs slower under
    load; the figures below are not scaled for it."""
    # bf16 FLOP/s, dense: NVIDIA's H100 SXM data sheet (NVIDIA H100 80GB
    # HBM3, 700 W); the bound of the kernels' table in PERF.md §6
    peak_flops: float = 989e12
    # B/s: the same data sheet (NVIDIA H100 80GB HBM3, 700 W)
    hbm_bw: float = 3.35e12
    # B/s between cards: the data sheet's NVLink figure, 900 GB/s
    # (NVIDIA H100 80GB HBM3, 700 W). Not measured: one card
    ici_bw: float = 900e9
    # bytes: what torch.cuda.get_device_properties reports (NVIDIA H100
    # 80GB HBM3, 700 W; PERF.md §5-6)
    hbm_bytes: float = 85.0e9
    # B/s of the host path of the async weight sync: the measured
    # device-to-pinned-memory copy, 4.36 GB in 0.080 s (NVIDIA H100 80GB
    # HBM3, 700 W; PERF.md §5)
    host_net_bw: float = 54.5e9


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _attn_linear_flops(cfg: ModelConfig, tokens: float) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.attention == "mla":
        q_dim = cfg.num_heads * (cfg.qk_rope_head_dim + cfg.qk_nope_head_dim)
        f = d * q_dim if not cfg.q_lora_rank else \
            d * cfg.q_lora_rank + cfg.q_lora_rank * q_dim
        f += d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        f += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim
                                                 + cfg.v_head_dim)
        f += cfg.num_heads * cfg.v_head_dim * d
    else:
        f = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
            + cfg.num_heads * hd * d
    return 2.0 * tokens * f


def _attn_quadratic_flops(cfg: ModelConfig, B: float, S: float,
                          window: int = 0) -> float:
    """Scores + PV, causal (×1/2), optionally windowed."""
    if cfg.attention == "mla":
        hd_eff = cfg.qk_rope_head_dim + cfg.qk_nope_head_dim + cfg.v_head_dim
    else:
        hd_eff = 2 * cfg.head_dim
    span = min(S, window) if window else S
    causal = 0.5 if not window or window >= S else 1.0
    return 2.0 * B * S * span * causal * cfg.num_heads * hd_eff


def _mlp_flops(cfg: ModelConfig, tokens: float, dff: int) -> float:
    mult = 3 if cfg.activation == "silu" else 2
    return 2.0 * tokens * mult * cfg.d_model * dff


def _layer_counts(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.arch_type == "hybrid":
        pat = cfg.rglru_block_pattern
        n_att = sum(1 for i in range(cfg.num_layers)
                    if pat[i % len(pat)] == "attention")
        return {"attention": n_att, "recurrent": cfg.num_layers - n_att}
    if cfg.arch_type == "moe":
        return {"dense": cfg.first_dense_layers,
                "moe": cfg.num_layers - cfg.first_dense_layers}
    return {cfg.arch_type: cfg.num_layers}


def forward_flops(cfg: ModelConfig, B: float, S: float, *,
                  window: int = 0, kv_len: float = None) -> float:
    """One forward pass over B sequences of S *new* tokens (kv_len = extra
    context attended to, for decode)."""
    tokens = B * S
    total = 2.0 * tokens * cfg.d_model * cfg.vocab_size  # unembed
    if cfg.arch_type == "vlm" and S > 1:
        # vision prefix processed during train/prefill; decode attends to
        # it through the KV cache only (kv_len covers it)
        tokens = B * (S + cfg.vision_tokens)
    counts = _layer_counts(cfg)

    for kind, n in counts.items():
        if n == 0:
            continue
        if kind == "ssm":
            di, ds = cfg.d_inner, cfg.ssm_state
            per = 2.0 * tokens * (cfg.d_model * 2 * di          # in_proj
                                  + di * (cfg.ssm_dt_rank + 2 * ds)
                                  + cfg.ssm_dt_rank * di
                                  + di * cfg.d_model)            # out
            per += 6.0 * tokens * di * ds                        # scan
            total += n * per
        elif kind == "recurrent":
            w = cfg.rnn_width
            per = 2.0 * tokens * (cfg.d_model * 2 * w + 2 * w * w
                                  + w * cfg.d_model)
            per += 8.0 * tokens * w                              # RG-LRU
            per += _mlp_flops(cfg, tokens, cfg.d_ff)
            total += n * per
        elif kind == "attention":
            per = _attn_linear_flops(cfg, tokens)
            per += _attn_quadratic_flops(cfg, B, S,
                                         window=cfg.local_window)
            per += _mlp_flops(cfg, tokens, cfg.d_ff)
            total += n * per
        elif kind == "moe":
            per = _attn_linear_flops(cfg, tokens)
            if kv_len is not None:
                per += 2.0 * B * S * kv_len * cfg.num_heads * (
                    2 * cfg.head_dim if cfg.attention != "mla" else
                    cfg.qk_rope_head_dim + cfg.qk_nope_head_dim
                    + cfg.v_head_dim)
            else:
                per += _attn_quadratic_flops(cfg, B, S, window=window)
            per += 2.0 * tokens * cfg.d_model * cfg.num_experts  # router
            per += cfg.top_k * _mlp_flops(cfg, tokens, cfg.moe_d_ff)
            per += cfg.num_shared_experts * _mlp_flops(cfg, tokens,
                                                       cfg.moe_d_ff)
            total += n * per
        else:  # dense / vlm / audio decoder
            per = _attn_linear_flops(cfg, tokens)
            if kv_len is not None:
                hd_eff = (2 * cfg.head_dim if cfg.attention != "mla" else
                          cfg.qk_rope_head_dim + cfg.qk_nope_head_dim
                          + cfg.v_head_dim)
                per += 2.0 * B * S * kv_len * cfg.num_heads * hd_eff
            else:
                per += _attn_quadratic_flops(cfg, B, S, window=window)
            per += _mlp_flops(cfg, tokens, cfg.d_ff)
            total += n * per

    if cfg.arch_type == "audio":
        F = cfg.encoder_frames
        enc_tokens = B * F
        enc_per = (2.0 * enc_tokens * 4 * cfg.d_model * cfg.d_model
                   + 2.0 * 2 * B * F * F * cfg.num_heads * cfg.head_dim / 2
                   + _mlp_flops(cfg, enc_tokens, cfg.d_ff))
        total += cfg.encoder_layers * enc_per
        # cross attention in decoder
        total += cfg.num_layers * (2.0 * tokens * 4 * cfg.d_model * cfg.d_model
                                   + 2.0 * B * S * F * cfg.num_heads
                                   * cfg.head_dim * 2)
    return total


def step_flops(cfg: ModelConfig, shape_name: str) -> float:
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    if shp.kind == "train":
        return 3.0 * forward_flops(cfg, B, S)
    if shp.kind == "prefill":
        return forward_flops(cfg, B, S)
    # decode: 1 new token against a cache of length (window-capped) S
    from repro_torch.models.model import decode_window
    length, _ = decode_window(cfg, shape_name)
    return forward_flops(cfg, B, 1, kv_len=length)


# ---------------------------------------------------------------------------
# HBM bytes (per chip, given mesh degree sharding)
# ---------------------------------------------------------------------------


def _kv_shard_degree(cfg: ModelConfig, tp: int, kv_seq_shard: bool) -> int:
    """How many ways the KV cache shards over the model axis: by kv heads
    when divisible, by the sequence dim under the kv_seq_shard policy
    (§Perf HC3), else replicated."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return tp  # state/channel dims shard over model
    if cfg.attention == "mla":
        return tp if kv_seq_shard else 1   # latent is per-token, headless
    if cfg.num_kv_heads % max(tp, 1) == 0:
        return tp
    return tp if kv_seq_shard else 1


def step_hbm_bytes(cfg: ModelConfig, shape_name: str, n_chips: int, *,
                   mesh_shape: Dict[str, int] = None,
                   kv_seq_shard: bool = False) -> float:
    """Per-chip HBM traffic of one step (weights after sharding +
    activation reads/writes; flash attention assumed).

    Training shards weights over (data-FSDP x model); inference replicates
    weights across data, so each chip reads P/tp per token."""
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    P_total = cfg.param_count()
    P_active = cfg.active_param_count()
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    if mesh_shape:
        tp = mesh_shape.get("model", 1)
        dp = n_chips // max(tp, 1)
    else:
        tp = min(16, n_chips)
        dp = n_chips // tp

    if shp.kind == "train":
        tokens = B * S
        # fwd reads weights + bwd reads + grads write + AdamW (p,m,v fp32
        # read+write) — weights fully sharded across chips (FSDP x TP)
        w_traffic = P_total * (BF16 * 3 + F32 * 6) / n_chips
        act = tokens * d * L * BF16 * 8 / n_chips
        logits = tokens * V * BF16 * 2 / n_chips
        return w_traffic + act + logits
    if shp.kind == "prefill":
        tokens = B * S
        w = P_active * BF16 / tp               # replicated across data
        act = tokens * d * L * BF16 * 4 / n_chips
        cache_w = kv_cache_bytes(cfg, B, S) / n_chips
        return w + act + cache_w
    # decode
    from repro_torch.models.model import decode_window
    length, _ = decode_window(cfg, shape_name)
    w = P_active * BF16 / tp                   # whole shard read per token
    kv_deg = _kv_shard_degree(cfg, tp, kv_seq_shard)
    b_deg = dp if B % dp == 0 and B > 1 else (dp if B == 1 else 1)
    if B == 1:
        # batch can't shard; long_500k shards the seq/state dim over data
        b_deg = dp if cfg.arch_type not in ("ssm",) else 1
    cache = kv_cache_bytes(cfg, B, length) / (b_deg * kv_deg)
    return w + cache


def kv_cache_bytes(cfg: ModelConfig, B: int, length: int) -> float:
    if cfg.arch_type == "ssm":
        return B * cfg.num_layers * (cfg.d_inner * cfg.ssm_state
                                     + (cfg.ssm_conv - 1) * cfg.d_inner) * F32
    if cfg.arch_type == "hybrid":
        counts = _layer_counts(cfg)
        att = counts.get("attention", 0)
        rec = counts.get("recurrent", 0)
        return B * (att * min(length, cfg.local_window) * 2
                    * cfg.num_kv_heads * cfg.head_dim * BF16
                    + rec * 4 * cfg.rnn_width * F32)
    if cfg.attention == "mla":
        return B * cfg.num_layers * length * (cfg.kv_lora_rank
                                              + cfg.qk_rope_head_dim) * BF16
    per = 2 * cfg.num_kv_heads * cfg.head_dim * BF16
    total = B * cfg.num_layers * length * per
    if cfg.arch_type == "audio":
        total += B * cfg.num_layers * cfg.encoder_frames * per  # cross K/V
    return total


# ---------------------------------------------------------------------------
# Collective bytes (per chip)
# ---------------------------------------------------------------------------


def step_collective_bytes(cfg: ModelConfig, shape_name: str,
                          mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """Per-chip collective traffic of one step under the sharding scheme of
    repro.distributed.sharding (ring-collective cost: all-reduce 2x, all-
    gather/reduce-scatter 1x the shard-aggregated payload)."""
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1)
    pod = mesh_shape.get("pod", 1)
    d, L = cfg.d_model, cfg.num_layers
    P_total = cfg.param_count()
    out = {"tp_allreduce": 0.0, "fsdp_allgather": 0.0,
           "grad_reducescatter": 0.0, "pod_allreduce": 0.0,
           "moe_all2all": 0.0}

    if shp.kind == "decode":
        from repro_torch.models.model import decode_window
        S_eff = 1
    else:
        S_eff = S
    tokens_local = B * S_eff / (dp * pod) if B * S_eff >= dp * pod else B * S_eff

    n_att_layers = L if cfg.arch_type != "hybrid" else \
        _layer_counts(cfg)["attention"]
    n_mix_layers = L

    if tp > 1:
        # all-reduces per layer: attn-out + ffn-out for attention blocks,
        # one out-proj for ssm blocks; ring all-reduce moves 2x payload.
        if cfg.arch_type == "ssm":
            ar_per_layer = 1.0
        elif cfg.arch_type == "hybrid":
            c = _layer_counts(cfg)
            ar_per_layer = (2 * c["attention"] + 2 * c["recurrent"]) / L
        else:
            ar_per_layer = 2.0
        per_layer = ar_per_layer * tokens_local * d * BF16 * 2 * ((tp - 1) / tp)
        mult = 2 if shp.kind == "train" else 1
        out["tp_allreduce"] = n_mix_layers * per_layer * mult

    if shp.kind == "train" and dp > 1:
        # FSDP: all-gather params fwd + bwd, reduce-scatter grads
        shard = P_total * BF16 * ((dp - 1) / dp) / tp
        out["fsdp_allgather"] = 2 * shard
        out["grad_reducescatter"] = P_total * F32 * ((dp - 1) / dp) / tp
    if shp.kind == "train" and pod > 1:
        out["pod_allreduce"] = 2 * P_total * F32 * ((pod - 1) / pod) / (dp * tp)

    if cfg.arch_type == "moe" and cfg.num_experts % max(tp, 1) == 0 and tp > 1:
        n_moe = _layer_counts(cfg)["moe"]
        # fan-out per token: top_k target devices, capped by the
        # device-limited routing bound (§Perf HC4) and by tp itself
        fan = min(cfg.top_k, tp)
        if cfg.moe_device_limit:
            fan = min(fan, cfg.moe_device_limit)
        per = 2 * tokens_local * fan * d * BF16 * ((tp - 1) / tp)
        mult = 3 if shp.kind == "train" else 1   # fwd + bwd dispatch+combine
        out["moe_all2all"] = n_moe * per * mult

    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ---------------------------------------------------------------------------
# Step-time estimate (for the planner/simulator)
# ---------------------------------------------------------------------------


def roofline_terms(cfg: ModelConfig, shape_name: str,
                   mesh_shape: Dict[str, int], hw: HW = HW(), *,
                   kv_seq_shard: bool = False) -> dict:
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v
    fl = step_flops(cfg, shape_name)
    hb = step_hbm_bytes(cfg, shape_name, n_chips, mesh_shape=mesh_shape,
                        kv_seq_shard=kv_seq_shard)
    co = step_collective_bytes(cfg, shape_name, mesh_shape)
    t_c = fl / (n_chips * hw.peak_flops)
    t_m = hb / hw.hbm_bw
    t_x = co["total"] / hw.ici_bw
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    return {"flops": fl, "hbm_bytes_per_chip": hb,
            "collective_bytes_per_chip": co,
            "t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
            "t_step_lower_bound": max(t_c, t_m, t_x),
            "bottleneck": dom, "n_chips": n_chips}
