"""Gradients of a loss over a parameter tree: the port's stand-in for
``jax.value_and_grad(loss_fn, has_aux=True)``."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_unflatten


def grad_and_metrics(loss_fn, params, *args, zero_unused=False):
    """``loss_fn(params, *args) -> (loss, metrics)``. Returns a tree like
    ``params`` of fresh gradient tensors, and the detached metrics.

    Autograd records on detached aliases of the parameters, so the tensors
    in ``params`` (which rollout workers may be sampling with) are neither
    marked as requiring grad nor given a ``.grad``; grad mode is switched
    on here because the caller's thread may have it off.

    A parameter that autograd did not reach raises: for a loss that every
    parameter feeds, that is a route that recorded no graph. Where the loss
    leaves some parameters out by design (the PPO critic never reads its
    backbone's ``lm_head``), ``zero_unused`` gives them zero gradients, as
    ``jax.grad`` does."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=zero_unused)
    if zero_unused:
        grads = [torch.zeros_like(p, requires_grad=False) if g is None
                 else g for p, g in zip(live, grads)]
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})
