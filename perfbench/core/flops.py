"""Frozen arithmetic: the chip's peaks, model FLOPs and the kernels' least
bytes and FLOPs per call.

The model FLOPs follow the port's planner cost model
(``src/repro_torch/core/planner/cost_model.py``, ``forward_flops``) for
the dense GQA and Mamba-1 families, copied here so that a later change to
the planner cannot move the yardstick. Products count 2 FLOPs per
multiply-add; the embedding gather counts nothing; causal attention
counts the keys each query sees.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 80 GB data sheet, dense (no sparsity), 700 W.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _dtr(c: dict) -> int:
    return c.get("ssm_dt_rank") or math.ceil(c["d_model"] / 16)


def layer_flops_per_token(c: dict) -> float:
    """Weight-product FLOPs of one token through one layer (the scan's
    elementwise work counted as the cost model does, 6 per state)."""
    d = c["d_model"]
    if c["arch_type"] == "ssm":
        di, ds, dtr = c["ssm_expand"] * d, c["ssm_state"], _dtr(c)
        return 2.0 * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di
                      + di * d) + 6.0 * di * ds
    H, KV, hd, F = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["d_ff"]
    mult = 3 if c.get("activation", "silu") == "silu" else 2
    return 2.0 * (d * (H + 2 * KV) * hd + H * hd * d) + 2.0 * mult * d * F


def attention_flops(c: dict, keys: float) -> float:
    """Scores and the weighted sum over ``keys`` query-key pairs, all
    layers (0 for an attention-free model)."""
    if c["arch_type"] == "ssm":
        return 0.0
    return 4.0 * keys * c["num_heads"] * c["head_dim"] * c["num_layers"]


def unembed_flops(c: dict, positions: float) -> float:
    return 2.0 * positions * c["d_model"] * c["vocab_size"]


def forward_flops(c: dict, tokens: float, keys: float,
                  logit_positions: float) -> float:
    """A forward over ``tokens`` new tokens attending ``keys`` query-key
    pairs in all, with logits at ``logit_positions`` positions."""
    return (tokens * c["num_layers"] * layer_flops_per_token(c)
            + attention_flops(c, keys) + unembed_flops(c, logit_positions))


def causal_keys(n: int, start: int = 0) -> float:
    """Query-key pairs of tokens start..n-1 each seeing every key up to
    itself."""
    return (n * (n + 1) - start * (start + 1)) / 2.0


def grpo_sample_flops(c: dict, prompt: int, response: int) -> float:
    """Model FLOPs one trained sample costs: its generation (one forward
    over prompt and response, logits for the response), the reference's
    forward and the actor's forward and backward (3 forwards), each with
    logits for the response positions."""
    n = prompt + response
    one = forward_flops(c, n, causal_keys(n), response)
    return 5.0 * one


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def fused_rl_loss_fwd(N: int, V: int, elem: int) -> tuple:
    """(bytes, FLOPs) of one forward call over (N, V) logits: the logits
    read once, int64 targets and three float32 vectors read, six float32
    vectors written. Its arithmetic is a few operations a logit, far
    under the bytes' time at the tensor peak, so FLOPs count 0."""
    return N * V * elem + N * (8 + 3 * 4) + 6 * N * 4, 0.0


def fused_rl_loss_bwd(N: int, V: int, elem: int) -> tuple:
    """(bytes, FLOPs) of one backward call: the logits read, dx written,
    the targets and four float32 row vectors read."""
    return 2 * N * V * elem + N * (8 + 4 * 4), 0.0


def decode_attention(B: int, S: int, H: int, KVH: int, hd: int,
                     keys: int, elem: int) -> tuple:
    """(bytes, FLOPs) of one call: q and out, the (B, S) bool mask, and
    the K and V rows of the ``keys`` valid keys of all rows (the only
    bytes the function needs); 4 FLOPs a query head, key and dim."""
    nbytes = 2 * B * H * hd * elem + 2 * keys * KVH * hd * elem + B * S
    return nbytes, 4.0 * keys * H * hd
