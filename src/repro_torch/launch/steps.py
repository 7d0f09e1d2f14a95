"""The three production step functions every architecture runs:

  train_step   — GRPO actor update (fwd + clipped policy loss + bwd + AdamW)
  prefill_step — rollout prefill: full-sequence forward building the KV cache
  serve_step   — one-token decode against a seq_len cache

These are what the dry run traces for every (arch x input-shape x mesh).
Each runs what the port runs on the card: prefill and decode through the
kernels (``flash_attention``, the scans, ``decode_attention``), the actor
update on the plain attention and scan routes with the fused loss
kernels. The reference's steps lower its plain route throughout (its
``use_pallas`` defaults to False).
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, forward
from repro_torch.rl.grpo import GRPOConfig, grpo_train_step
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_state import TrainState


def make_train_step(cfg, rl: GRPOConfig = None,
                    opt_cfg: OptimizerConfig = None):
    rl = rl or GRPOConfig()
    opt_cfg = opt_cfg or OptimizerConfig()

    def train_step(state: TrainState, batch):
        return grpo_train_step(state, cfg, rl, opt_cfg, batch)

    return train_step


def make_prefill_step(cfg):
    """Returns (last-token logits, cache-or-None)."""
    want_cache = cfg.arch_type not in ("ssm",)

    @torch.no_grad()
    def prefill_step(params, batch):
        out = forward(params, cfg, batch, return_cache=want_cache)
        if want_cache:
            logits, aux, cache = out
        else:
            logits, aux = out
            cache = None
        return logits[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg, *, ring: bool = False):
    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        return decode_step(params, cfg, cache, token, pos, ring=ring)

    return serve_step
