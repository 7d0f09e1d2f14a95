"""Policy-gradient losses (GRPO / PPO) with the fused RL hot-path kernels.

All losses are masked to response tokens. The actor update goes through
``fused_actor_loss``: logprob + entropy + k3 KL + clipped surrogate in one
pass over the (B, S, V) logits forward and one backward
(``kernels/fused_rl_loss``). ``token_logprobs`` serves inference-side
logprobs (the reference-inference stage) through ``kernels/grpo_logprob``.
Both reach their CUDA kernels for CUDA tensors and their plain versions for
CPU tensors; there is no switch. The unfused primitives
(``clipped_policy_loss``/``kl_penalty``) remain for tests, and
``value_loss`` for the critic.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_rl_loss import fused_rl_loss
from repro_torch.kernels.grpo_logprob import grpo_logprob


def token_logprobs(logits, targets):
    """logits: (B, S, V) for predicting targets (B, S).
    Returns (logprob (B,S) f32, entropy (B,S) f32)."""
    V = logits.shape[-1]
    lp, ent = grpo_logprob(logits.reshape(-1, V), targets.reshape(-1))
    return lp.reshape(targets.shape), ent.reshape(targets.shape)


def _denom(mask):
    return torch.clamp(mask.sum(), min=1.0)


def clipped_policy_loss(logp_new, logp_old, advantages, mask, *,
                        clip_eps: float = 0.2):
    """PPO/GRPO clipped surrogate.

    logp_new/logp_old: (B, S) per-token; advantages: (B,) per sample
    (GRPO) or (B, S) per token (PPO+GAE); mask: (B, S) response mask.
    """
    if advantages.dim() == 1:
        advantages = advantages[:, None]
    ratio = torch.exp(logp_new - logp_old)
    unclipped = ratio * advantages
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * advantages
    per_tok = -torch.minimum(unclipped, clipped)
    denom = _denom(mask)
    loss = (per_tok * mask).sum() / denom
    clip_frac = (((ratio - 1).abs() > clip_eps) * mask).sum() / denom
    return loss, {"ratio_mean": (ratio * mask).sum() / denom,
                  "clip_frac": clip_frac}


def fused_actor_loss(logits, targets, old_logprob, advantages, mask, *,
                     ref_logprob=None, clip_eps: float = 0.2,
                     kl_coef: float = 0.0, entropy_coef: float = 0.0):
    """The GRPO/PPO actor objective in one fused pass over the logits.

    logits (B, S, V) predicting targets (B, S); old_logprob (B, S);
    advantages (B,) per sample (GRPO) or (B, S) per token (PPO+GAE);
    mask (B, S). Returns ``(loss, stats)`` with the same masked-mean
    semantics and stat keys as the unfused composition.
    """
    if advantages.dim() == 1:
        advantages = advantages[:, None].expand(targets.shape)
    use_kl = bool(kl_coef) and ref_logprob is not None
    ref = ref_logprob if use_kl else torch.zeros_like(old_logprob)
    lp, ent, kl, pl_tok, ratio = fused_rl_loss(
        logits, targets, old_logprob, ref, advantages, clip_eps=clip_eps)
    denom = _denom(mask)
    pl_loss = (pl_tok * mask).sum() / denom
    ent_mean = (ent * mask).sum() / denom
    loss = pl_loss
    if use_kl:
        loss = loss + kl_coef * (kl * mask).sum() / denom
    if entropy_coef:
        loss = loss - entropy_coef * ent_mean
    stats = {"policy_loss": pl_loss, "entropy": ent_mean,
             "ratio_mean": (ratio * mask).sum() / denom,
             "clip_frac": (((ratio - 1).abs() > clip_eps)
                           * mask).sum() / denom}
    return loss, stats


def kl_penalty(logp_new, logp_ref, mask):
    """k3 estimator (Schulman): exp(ref-new) - (ref-new) - 1 >= 0."""
    d = logp_ref - logp_new
    k3 = torch.exp(d) - d - 1.0
    return (k3 * mask).sum() / _denom(mask)


def value_loss(values, returns, old_values, mask, *, clip_eps: float = 0.2):
    """Clipped value loss (PPO critic)."""
    v_clip = old_values + torch.clamp(values - old_values, -clip_eps,
                                      clip_eps)
    l1 = torch.square(values - returns)
    l2 = torch.square(v_clip - returns)
    return 0.5 * (torch.maximum(l1, l2) * mask).sum() / _denom(mask)
