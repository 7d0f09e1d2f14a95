from repro_torch.rl.advantage import gae, grpo_advantages
from repro_torch.rl.grpo import (GRPOConfig, grpo_dataflow, grpo_grad_step,
                                 grpo_loss_fn, grpo_train_step)
from repro_torch.rl.loss import (clipped_policy_loss, fused_actor_loss,
                                 kl_penalty, token_logprobs, value_loss)
from repro_torch.rl.ppo import (PPOConfig, critic_forward, gae_stage,
                                init_critic_params, ppo_actor_loss_fn,
                                ppo_critic_loss_fn, ppo_dataflow, ppo_loss_fn,
                                ppo_train_step)
from repro_torch.rl.reward import math_reward
from repro_torch.rl.sampling import generate

__all__ = ["grpo_advantages", "gae", "GRPOConfig", "grpo_train_step",
           "grpo_grad_step", "grpo_loss_fn", "grpo_dataflow", "PPOConfig",
           "ppo_train_step", "ppo_loss_fn", "ppo_actor_loss_fn",
           "ppo_critic_loss_fn", "ppo_dataflow", "gae_stage",
           "init_critic_params", "critic_forward", "math_reward",
           "generate", "token_logprobs", "clipped_policy_loss",
           "fused_actor_loss", "kl_penalty", "value_loss"]
