"""Advantage estimators: GRPO group-relative and GAE (for PPO)."""
from __future__ import annotations

import numpy as np
import torch


def grpo_advantages(rewards, eps: float = 1e-6):
    """Group-relative advantages (GRPO): rewards (G,) for one prompt's G
    responses -> (r - mean) / (std + eps), in float32. Works on numpy
    arrays (and lists) or torch tensors; std is the population std, as
    numpy's and the reference's."""
    if isinstance(rewards, torch.Tensor):
        r = rewards.to(torch.float32)
        return (r - r.mean()) / (r.std(correction=0) + eps)
    r = np.asarray(rewards, dtype=np.float32)
    return (r - r.mean()) / (r.std() + eps)


def gae(rewards, values, *, gamma: float = 1.0, lam: float = 0.95):
    """Generalized advantage estimation over a (T,) trajectory.
    values has length T+1 (bootstrap). Returns (advantages, returns)."""
    rewards = np.asarray(rewards, np.float32)
    values = np.asarray(values, np.float32)
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    for t in reversed(range(T)):
        delta = rewards[t] + gamma * values[t + 1] - values[t]
        last = delta + gamma * lam * last
        adv[t] = last
    return adv, adv + values[:-1]
