"""GRPO actor-update step (the paper's evaluated RL algorithm, §6.1).

``grpo_loss_fn`` is forward (plain attention route) + the fused actor loss
(+ optional KL-to-reference); ``grpo_grad_step`` its gradients, which the
train engine accumulates over streamed micro-batches before one AdamW step.

``grpo_dataflow`` declares GRPO as a streaming stage graph (§3.3/§4.1):

    generate → [ref_inference] → reward/advantage → actor_update

Each task streams independently through one shared TransferQueue; group
advantages are emitted by the reward stage as deferred writes once every
member of a group has streamed through.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.workflow.stage_graph import (StageGraph, StageSpec,
                                                   register_dataflow)
from repro_torch.models import forward
from repro_torch.rl.loss import fused_actor_loss
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    """The reference's fields but ``use_pallas_logprob``: the port's loss
    reaches its CUDA kernels for CUDA tensors and their plain versions for
    CPU tensors, with no switch."""
    clip_eps: float = 0.2
    kl_coef: float = 0.0          # >0 adds KL-to-reference penalty
    entropy_coef: float = 0.0


def grpo_loss_fn(params, cfg, batch, rl: GRPOConfig, ref_logprob=None):
    """batch:
      tokens (B, S)           — prompt + response (+pad)
      response_mask (B, S)    — 1 on response tokens (as *targets*)
      old_logprob (B, S)      — behavior-policy per-token logprobs
      advantage (B,)          — group-relative advantage per sample
      ref_logprob (B, S)      — optional frozen-reference logprobs (KL)

    The forward takes the plain attention route (``use_flash=False``), as
    the reference's does: the flash kernel has no backward.
    """
    if ref_logprob is None:
        ref_logprob = batch.get("ref_logprob")
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, {"tokens": tokens}, use_flash=False)
    S = tokens.shape[1]
    logits = logits[:, -S:, :]
    mask = batch["response_mask"][:, 1:]

    # one fused pass over the (B, S, V) logits: logprob + entropy + KL +
    # clipped surrogate, backward by its own kernel (kernels/fused_rl_loss)
    actor_loss, stats = fused_actor_loss(
        logits[:, :-1], tokens[:, 1:], batch["old_logprob"][:, 1:],
        batch["advantage"], mask,
        ref_logprob=ref_logprob[:, 1:] if ref_logprob is not None else None,
        clip_eps=rl.clip_eps, kl_coef=rl.kl_coef,
        entropy_coef=rl.entropy_coef)
    loss = actor_loss + aux
    return loss, {"loss": loss, **stats}


def grpo_grad_step(params, cfg, rl: GRPOConfig, batch):
    """Gradients only (for streaming gradient accumulation): a tree like
    ``params`` of fresh gradient tensors, and the detached metrics.

    Autograd records on detached aliases of the parameters, so the tensors
    in ``params`` (which rollout workers may be sampling with) are neither
    marked as requiring grad nor given a ``.grad``; grad mode is switched
    on here because the caller's thread may have it off. Every parameter
    of a dense model reaches the loss, so one that autograd did not reach
    (a route that recorded no graph) raises."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = grpo_loss_fn(tree_unflatten(params, live), cfg,
                                     batch, rl)
        grads = torch.autograd.grad(loss, live)
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def grpo_dataflow(*, kl_coef: float = 0.0, **_) -> StageGraph:
    """GRPO as a streaming stage graph (see module docstring). With
    ``kl_coef > 0`` the frozen-reference inference runs as its own
    streaming task between generation and the actor update."""
    g = StageGraph(source_columns=("prompt",))
    g.add(StageSpec("generate", inputs=("prompt",),
                    outputs=("response", "logprob", "response_mask",
                             "response_ids", "group", "answer", "version"),
                    engine="rollout", verb="generate_sequences",
                    kind="generate"))
    if kl_coef > 0:
        g.add(StageSpec("ref_inference", inputs=("response",),
                        outputs=("ref_logprob",),
                        engine="rollout", verb="compute_log_prob"))
    g.add(StageSpec("reward", inputs=("response_ids", "answer", "group"),
                    outputs=("reward", "advantage"),
                    engine="rollout", verb="compute_rewards"))
    train_in = ["response", "logprob", "response_mask", "reward",
                "advantage", "version"]
    if kl_coef > 0:
        train_in.append("ref_logprob")
    g.add(StageSpec("actor_update", inputs=tuple(train_in),
                    engine="actor", verb="update_actor",
                    kind="train", drives_steps=True))
    return g


register_dataflow("grpo", grpo_dataflow)
