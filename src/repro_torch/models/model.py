"""Unified model facade, as in the reference:

    params = init_params(seed, cfg, device="cuda")
    logits, aux = forward(params, cfg, batch)              # train/prefill
    logits, cache = decode_step(params, cfg, cache, token, pos)

``batch`` is a dict holding tokens (B,S). Only the dense family is ported;
the others raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer


def init_params(seed: int, cfg, *, device=None):
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (``cuda`` unless the caller passes another)."""
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the audio family is not ported yet (ROADMAP §1, "
            "item 'the other model families')")
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return transformer.init_lm(gen, cfg)


def forward(params, cfg, batch, *, window=0, use_flash=True,
            return_cache=False):
    """Full-sequence forward. Returns (logits, aux[, cache]).

    ``use_flash`` chooses the causal attention route, as the reference's
    ``use_pallas`` does: True (serving, prefill, reference inference) takes
    ``kernels/flash_attention``, forward only; False (the actor update)
    takes the plain, differentiable ``sdpa``."""
    logits, aux, cache = transformer.forward_lm(
        params, cfg, batch["tokens"], window=window,
        return_cache=return_cache, use_flash=use_flash)
    if return_cache:
        return logits, aux, cache
    return logits, aux


def init_cache(cfg, batch_size, length, dtype=torch.bfloat16, *,
               device=None):
    return transformer.init_cache(cfg, batch_size, length, dtype,
                                  device=resolve_device(device))


def decode_step(params, cfg, cache, token, pos, *, ring=False):
    """One-token decode. token/pos: (B,). Returns (logits (B,V), cache);
    the cache is updated in place."""
    return transformer.decode_lm(params, cfg, cache, token, pos, ring=ring)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())
