"""AdamW + LR schedules (cosine, and WSD for MiniCPM) over the port's param
trees, as the reference's ``training/optimizer.py``.

State mirrors params: {"m": tree, "v": tree, "count": int}. Supports
global-norm clipping and decoupled weight decay.

Where the reference is functional, the port updates ``m`` and ``v`` in
place (only the optimizer holds them) but returns NEW parameter tensors:
rollout workers sample with the tensors of the version they swapped in, and
an asynchronous publish snapshots the old tensors while the trainer steps
on, so a step must never write into a tensor that it did not create.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-5
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "constant"  # constant | cosine | wsd
    warmup_steps: int = 10
    total_steps: int = 1000
    stable_frac: float = 0.8    # WSD: fraction of steps at peak LR
    min_lr_frac: float = 0.1


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    def sched(step):
        step = float(step)
        warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
        if cfg.schedule == "constant":
            frac = 1.0
        elif cfg.schedule == "cosine":
            t = min(max((step - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps), 0.0),
                    1.0)
            frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + math.cos(math.pi * t))
        elif cfg.schedule == "wsd":
            # warmup -> stable plateau -> 1-sqrt decay (MiniCPM §WSD)
            decay_start = cfg.stable_frac * cfg.total_steps
            t = min(max((step - decay_start)
                        / max(1.0, cfg.total_steps - decay_start), 0.0), 1.0)
            frac = 1.0 if step < decay_start else (
                cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - math.sqrt(t)))
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * warm * frac
    return sched


def init_opt_state(params):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "count": 0}


def global_norm(grads):
    """sqrt of the sum of squares of every leaf, in fp32, as a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in tree_leaves(grads)]))


def _clip_scale(gnorm, max_norm):
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to at most ``max_norm``, the norm before scaling); no
    host sync: the scale stays a device tensor."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale, grads), gnorm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig):
    """Returns (new_params, state, grad_norm): new parameter tensors, and
    ``state`` with its moments updated in place and ``count`` advanced."""
    lr = make_schedule(cfg)(state["count"])
    # clipping as clip_by_global_norm, one leaf at a time inside upd: a
    # clipped copy of the whole tree would cost one more model's memory
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    count = state["count"] + 1
    b1, b2 = cfg.betas
    mh_scale = 1.0 / (1 - b1 ** count)
    vh_scale = 1.0 / (1 - b2 ** count)

    def upd(p, g, m, v):
        g = g * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = (m * mh_scale).div_((v * vh_scale).sqrt_().add_(cfg.eps))
        step.add_(p, alpha=cfg.weight_decay)
        return torch.sub(p, step, alpha=lr).to(p.dtype)

    new_params = tree_map(upd, params, grads, state["m"], state["v"])
    state["count"] = count
    return new_params, state, gnorm
