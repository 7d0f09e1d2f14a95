"""PPO actor + critic update ("under development" in the paper §6.1 —
completed in the reference, and ported here). The critic is a value head
over the same backbone trunk; reference/reward models plug in as
additional RL tasks through TransferQueue exactly like the GRPO flow.

``ppo_dataflow`` declares PPO as a streaming stage graph (§3.3/§4.1):

    generate → [ref_inference] → values → reward → advantage(GAE)
             → actor_update + critic_update

Each task streams independently through one shared TransferQueue; the
actor update drives training steps and weight publication while the
critic update streams alongside as its own consumer (``train_stream``).

The losses take the plain, differentiable routes (``use_kernels=False``)
for their forwards, as ``grpo_loss_fn`` does; the actor objective goes
through ``fused_actor_loss`` with per-token advantages, so on CUDA tensors
it runs the ``fused_rl_loss`` kernels forward and backward. The critic's
value inference (``CriticEngine.compute_values``) is forward only and
takes the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.autodiff import grad_and_metrics
from repro_torch.core.workflow.stage_graph import (StageGraph, StageSpec,
                                                   register_dataflow)
from repro_torch.models import forward, transformer
from repro_torch.models.layers import dense, init_dense
from repro_torch.rl.advantage import gae
from repro_torch.rl.loss import fused_actor_loss, value_loss
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The reference's fields but ``use_pallas_logprob`` (see
    ``GRPOConfig``)."""
    clip_eps: float = 0.2
    value_clip_eps: float = 0.2
    vf_coef: float = 0.5
    kl_coef: float = 0.0
    entropy_coef: float = 0.0


def init_critic_params(gen, cfg):
    """Critic = backbone + scalar value head, drawn on ``gen``'s device."""
    return {"backbone": transformer.init_lm(gen, cfg),
            "value_head": init_dense(gen, cfg.d_model, 1)}


def critic_forward(critic, cfg, tokens, *, use_kernels=True):
    """Per-token values (B, S): value head over the backbone's final-norm
    hidden states. ``use_kernels`` picks the route as ``forward`` does."""
    hidden = transformer.forward_hidden(critic["backbone"], cfg, tokens,
                                        use_kernels=use_kernels)
    v = dense(critic["value_head"], hidden, hidden.dtype)
    return v[..., 0].to(torch.float32)


def _actor_loss(params, cfg, batch, rl):
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, {"tokens": tokens},
                          use_kernels=False)
    mask = batch["response_mask"][:, 1:]
    ref_lp = batch.get("ref_logprob")
    actor_loss, stats = fused_actor_loss(
        logits[:, :-1], tokens[:, 1:], batch["old_logprob"][:, 1:],
        batch["advantage"][:, 1:], mask,
        ref_logprob=ref_lp[:, 1:] if ref_lp is not None else None,
        clip_eps=rl.clip_eps, kl_coef=rl.kl_coef,
        entropy_coef=rl.entropy_coef)
    return actor_loss + aux, stats


def _value_loss(critic_params, cfg, batch, rl):
    values = critic_forward(critic_params, cfg, batch["tokens"],
                            use_kernels=False)[:, :-1]
    mask = batch["response_mask"][:, 1:]
    return value_loss(values, batch["returns"][:, 1:],
                      batch["old_values"][:, 1:], mask,
                      clip_eps=rl.value_clip_eps)


def ppo_loss_fn(actor_params, critic_params, cfg, batch, rl: PPOConfig):
    """batch: tokens, response_mask, old_logprob, advantage (B,S),
    returns (B,S), old_values (B,S), optional ref_logprob."""
    actor_loss, stats = _actor_loss(actor_params, cfg, batch, rl)
    vf = _value_loss(critic_params, cfg, batch, rl)
    loss = actor_loss + rl.vf_coef * vf
    return loss, {"loss": loss, "value_loss": vf, **stats}


def ppo_actor_loss_fn(params, cfg, batch, rl: PPOConfig):
    """Actor-only PPO loss for the ``actor_update`` stage: clipped policy
    objective over per-token GAE advantages (+ optional KL / entropy).
    The value term lives in the separate ``critic_update`` stage."""
    loss, stats = _actor_loss(params, cfg, batch, rl)
    return loss, {"loss": loss, **stats}


def ppo_critic_loss_fn(critic_params, cfg, batch, rl: PPOConfig):
    """Critic-only PPO loss for the ``critic_update`` stage."""
    vf = _value_loss(critic_params, cfg, batch, rl)
    return vf, {"value_loss": vf}


def gae_stage(batch, *, gamma: float = 1.0, lam: float = 0.95, **kw):
    """Stage fn for the ``advantage`` task: per-token GAE advantages and
    returns from streamed reward + critic values (terminal reward on the
    last response token, as in the verifiable-reward setting). Numpy on
    the stage's thread: it touches no tensor."""
    advs, rets = [], []
    for mask, reward, values in zip(batch["response_mask"], batch["reward"],
                                    batch["values"]):
        mask = np.asarray(mask)
        v = np.asarray(values, np.float32)
        adv = np.zeros(len(mask), np.float32)
        ret = np.zeros(len(mask), np.float32)
        idx = np.where(mask > 0)[0]
        if len(idx):
            traj_r = np.zeros(len(idx), np.float32)
            traj_r[-1] = float(reward)
            vv = np.concatenate([v[idx], [0.0]])
            a, r = gae(traj_r, vv, gamma=gamma, lam=lam)
            adv[idx] = a
            ret[idx] = r
        advs.append(adv)
        rets.append(ret)
    # returns before advantage: the actor update gates on "advantage", so
    # by the time the step driver can consume a row (and end the run) the
    # critic's "returns" column is already written — the critic_update
    # drain after shutdown then sees every row
    return {"updates": {"returns": rets, "advantage": advs}}


def ppo_dataflow(*, kl_coef: float = 0.0, gamma: float = 1.0,
                 lam: float = 0.95, **_) -> StageGraph:
    """PPO as a streaming stage graph (see module docstring)."""
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
    g.add(StageSpec("values", inputs=("response",), outputs=("values",),
                    engine="critic", verb="compute_values"))
    g.add(StageSpec("reward", inputs=("response_ids", "answer", "group"),
                    outputs=("reward",),
                    engine="rollout", verb="compute_rewards",
                    kw={"group_advantage": False}))
    g.add(StageSpec("advantage",
                    inputs=("response_mask", "reward", "values"),
                    outputs=("advantage", "returns"),
                    fn=gae_stage, kw={"gamma": gamma, "lam": lam}))
    actor_in = ["response", "logprob", "response_mask", "reward",
                "advantage", "version"]
    if kl_coef > 0:
        actor_in.append("ref_logprob")
    g.add(StageSpec("actor_update", inputs=tuple(actor_in),
                    engine="actor", verb="update_actor",
                    kind="train", drives_steps=True))
    g.add(StageSpec("critic_update",
                    inputs=("response", "response_mask", "returns",
                            "values", "version"),
                    engine="critic", verb="update_critic",
                    kind="train_stream"))
    return g


register_dataflow("ppo", ppo_dataflow)


def ppo_train_step(actor_state: TrainState, critic_state: TrainState,
                   cfg, rl: PPOConfig, opt_cfg: OptimizerConfig, batch):
    """One whole-batch PPO step of both networks: the actor on the full
    PPO loss (the value term does not reach its parameters), the critic
    on the value loss. Returns (new actor state, new critic state,
    metrics)."""
    a_grads, metrics = grad_and_metrics(
        lambda p: ppo_loss_fn(p, critic_state.params, cfg, batch, rl),
        actor_state.params)
    c_grads, _ = grad_and_metrics(
        lambda p: ppo_critic_loss_fn(p, cfg, batch, rl),
        critic_state.params, zero_unused=True)
    new_actor, agn = actor_state.apply_gradients(a_grads, opt_cfg)
    new_critic, cgn = critic_state.apply_gradients(c_grads, opt_cfg)
    metrics.update(actor_grad_norm=agn, critic_grad_norm=cgn)
    return new_actor, new_critic, metrics
