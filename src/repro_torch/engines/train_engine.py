"""Training engines — the training-cluster backend.

``TrainEngine`` implements the actor-update stage verb (``update_actor``):
it accumulates gradients over streamed micro-batches and applies the AdamW
step once a full global batch has passed through (so streaming
micro-consumption is algorithm-identical to whole-batch training), with the
GRPO loss over scalar group advantages (``algorithm="grpo"``) or the
actor-only PPO loss over per-token GAE advantages (``algorithm="ppo"``).

``CriticEngine`` implements the PPO value-side stage verbs:
``compute_values`` (the streaming critic-inference task) and
``update_critic`` (the streaming critic-update task), with the same
gradient-accumulation contract as the actor.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.autodiff import grad_and_metrics
from repro_torch.device import resolve_device
from repro_torch.engines.adapter import EngineRegistry, RLAdapter
from repro_torch.rl.grpo import GRPOConfig, grpo_loss_fn
from repro_torch.rl.ppo import (PPOConfig, critic_forward, ppo_actor_loss_fn,
                                ppo_critic_loss_fn)
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_state import TrainState
from repro_torch.tree import tree_leaves, tree_map


def pack_rows(batch: Dict[str, list], seq_len: int, device=None) -> dict:
    """Variable-length rows from TransferQueue -> fixed-shape tensors on
    ``device`` (``cuda`` unless the caller passes another).

    Packs whatever per-token columns are present (logprob, ref_logprob,
    returns, values) plus the advantage — per-token (PPO/GAE) or scalar
    per-sample (GRPO) — so one packer serves every train-side stage."""
    dev = resolve_device(device)
    n = len(batch["response"])
    S = seq_len

    def pad2(rows, dtype=np.float32):
        a = np.zeros((n, S), dtype)
        for i, r in enumerate(rows):
            r = np.asarray(r)[:S]
            a[i, :len(r)] = r
        return a

    def put(a):
        return torch.from_numpy(a).to(dev)

    tokens = pad2(batch["response"], np.int64)
    if "response_mask" in batch:
        masks = pad2(batch["response_mask"])
    else:
        masks = np.zeros((n, S), np.float32)
        for i, r in enumerate(batch["response"]):
            masks[i, :min(S, len(np.asarray(r)))] = 1.0
    out = {"tokens": put(tokens), "response_mask": put(masks)}
    if "logprob" in batch:
        out["old_logprob"] = put(pad2(batch["logprob"]))
    if "advantage" in batch:
        adv = batch["advantage"]
        if n and np.ndim(np.asarray(adv[0])) >= 1:   # per-token (PPO)
            out["advantage"] = put(pad2(adv))
        else:                                         # scalar (GRPO)
            out["advantage"] = put(np.asarray(adv, np.float32))
    for col, key in (("ref_logprob", "ref_logprob"),
                     ("returns", "returns"), ("values", "old_values")):
        if col in batch:
            out[key] = put(pad2(batch[col]))
    return out


class _AccumulatingEngine(RLAdapter):
    """Shared gradient-accumulation consumer: collect micro-batch grads
    until a full global batch streamed through, then step the optimizer.

    The summed gradients live in buffers only this engine holds, so they
    are added to, and divided by the micro-batch count, in place. The step
    itself makes new parameter tensors (``training/optimizer.py``)."""

    def __init__(self, cfg, init_params, *, opt: Optional[OptimizerConfig],
                 global_batch: int, seq_len: int):
        self.cfg = cfg
        self.opt_cfg = opt or OptimizerConfig(lr=3e-4, warmup_steps=2)
        self.state = TrainState.create(init_params)
        self.device = tree_leaves(init_params)[0].device
        self.global_batch = global_batch
        self.seq_len = seq_len
        self._accum = None
        self._accum_n = 0
        self._accum_metrics: List[dict] = []
        self.version = 0

    @property
    def params(self):
        return self.state.params

    def _grad(self, jb):
        raise NotImplementedError

    def _consume(self, batch: Dict[str, list]) -> dict:
        jb = pack_rows(batch, self.seq_len, self.device)
        grads, metrics = self._grad(jb)
        if self._accum is None:
            self._accum = grads
        else:
            tree_map(lambda a, g: a.add_(g), self._accum, grads)
        del grads
        self._accum_n += len(batch["response"])
        self._accum_metrics.append(
            {k: float(v) for k, v in metrics.items()})

        if self._accum_n >= self.global_batch:
            n_micro = max(1, len(self._accum_metrics))
            tree_map(lambda a: a.div_(float(n_micro)), self._accum)
            self.state, gnorm = self.state.apply_gradients(self._accum,
                                                           self.opt_cfg)
            self.version += 1
            out = {k: float(np.mean([m[k] for m in self._accum_metrics]))
                   for k in self._accum_metrics[0]}
            out["grad_norm"] = float(gnorm)
            if "reward" in batch:
                out["mean_reward"] = float(np.mean(batch["reward"]))
            self._accum, self._accum_n = None, 0
            self._accum_metrics = []
            return out
        return {}

    def get_weights(self):
        return self.state.params

    def load_weights(self, weights) -> None:
        self.state = self.state._replace(params=weights)


@EngineRegistry.register("torch_train")
class TrainEngine(_AccumulatingEngine):
    """Actor-update stage engine (GRPO or PPO-actor loss). ``init_params``
    live on the device the engine trains on."""

    def __init__(self, cfg, init_params, *, rl=None,
                 opt: Optional[OptimizerConfig] = None,
                 global_batch: int = 16, seq_len: int = 32,
                 algorithm: str = "grpo"):
        super().__init__(cfg, init_params, opt=opt,
                         global_batch=global_batch, seq_len=seq_len)
        self.algorithm = algorithm
        if algorithm == "ppo":
            self.rl = rl or PPOConfig()
            self._loss_fn = ppo_actor_loss_fn
        else:
            self.rl = rl or GRPOConfig()
            self._loss_fn = grpo_loss_fn

    def _grad(self, jb):
        return grad_and_metrics(self._loss_fn, self.state.params, self.cfg,
                                jb, self.rl)

    def update(self, batch: Dict[str, list]) -> dict:
        return self._consume(batch)

    def update_actor(self, batch, **kw):
        return self._consume(batch)


@EngineRegistry.register("torch_critic")
class CriticEngine(_AccumulatingEngine):
    """PPO value-side stage engine: streaming critic inference
    (``compute_values``) and critic updates (``update_critic``).
    ``critic_params`` ({"backbone", "value_head"}) live on the device the
    engine runs on."""

    def __init__(self, cfg, critic_params, *, rl: Optional[PPOConfig] = None,
                 opt: Optional[OptimizerConfig] = None,
                 global_batch: int = 16, seq_len: int = 32):
        super().__init__(cfg, critic_params, opt=opt,
                         global_batch=global_batch, seq_len=seq_len)
        self.rl = rl or PPOConfig()

    def compute_values(self, batch, **kw):
        """Stage verb: per-token values over each row's full sequence,
        through the forward-only kernels (padded to a multiple of 8, as
        the reference pads for XLA's compile reuse)."""
        arrs = [np.asarray(r) for r in batch["response"]]
        S = max(len(a) for a in arrs)
        S = ((S + 7) // 8) * 8
        toks = np.zeros((len(arrs), S), np.int64)
        for i, a in enumerate(arrs):
            toks[i, :len(a)] = a
        with torch.no_grad():
            vals = critic_forward(self.state.params, self.cfg,
                                  torch.from_numpy(toks).to(self.device),
                                  use_kernels=True).cpu().numpy()
        return {"updates": {"values":
                            [vals[i, :len(a)].astype(np.float32)
                             for i, a in enumerate(arrs)]}}

    def _grad(self, jb):
        # the value head reads the final-norm hidden states, so the
        # backbone's lm_head never reaches the loss: its gradient is zero
        return grad_and_metrics(ppo_critic_loss_fn, self.state.params,
                                self.cfg, jb, self.rl, zero_unused=True)

    def update_critic(self, batch, **kw):
        return self._consume(batch)

    def update(self, batch):
        return self._consume(batch)
