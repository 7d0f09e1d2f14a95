"""User-level interface: the RL algorithm controller (paper §5.1).

``Trainer`` is the single entry point researchers modify: it owns the
algorithm choice, builds engines through the backend adapters, and runs
the post-training workflow in any of the three modes. Minimal config in,
WorkflowResult out.

``TrainerConfig(algorithm=...)`` selects a registered streaming dataflow
(``rl/grpo.py`` / ``rl/ppo.py`` declare the built-ins; custom graphs
register through :func:`repro_torch.core.workflow.register_dataflow` or
the service API) and compiles it onto one shared TransferQueue via
:class:`StageRunner` — every RL task (generate, ref_inference, reward,
advantage, actor/critic update) streams as its own pipeline stage. It runs
on ``cuda`` unless ``device="cpu"`` is given. With ``checkpoint_dir`` the
run writes durable snapshots, and ``fit(resume=...)`` cold-resumes from
them. ``auto_size_workers`` sizes the stages' worker pools from the
planner's cost model (``core/planner``), and ``elastic_interval_s > 0``
rebalances them live. The reference's ``use_pallas`` has no counterpart:
the port's kernels serve CUDA tensors and their plain versions CPU
tensors.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.workflow import (StageRunner, WorkflowConfig,
                                       build_dataflow)
from repro_torch.data import PromptDataset
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.engines import CriticEngine, RolloutEngine, TrainEngine
from repro_torch.models import init_params
from repro_torch.rl.grpo import GRPOConfig
from repro_torch.rl.ppo import PPOConfig, init_critic_params
from repro_torch.rl.reward import math_reward, math_reward_shaped
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TrainerConfig:
    arch: str = "qwen2_5_7b"
    reduced: bool = True               # CPU-scale variant
    algorithm: str = "grpo"            # any registered dataflow (grpo | ppo)
    mode: str = "async"                # baseline | streaming | async
    num_steps: int = 8
    prompts_per_step: int = 4
    group_size: int = 4
    max_new_tokens: int = 8
    rollout_workers: int = 2
    rollout_batch: int = 2
    train_micro_batch: int = 4
    staleness: int = 1
    staggered: bool = False
    lr: float = 3e-4
    seed: int = 0
    seq_len: int = 32
    policy: Any = "fifo"       # str, or {task: str} per consumer stage
    num_storage_units: int = 2
    reward: str = "exact"              # exact | shaped
    kl_coef: float = 0.0               # >0: adds the ref_inference stage
    chunk_tokens: int = 0              # >0: partial rollout (k1.5-style)
    rollout_backend: str = "fixed"     # fixed | continuous (slot batcher)
    cb_slots: int = 4                  # continuous backend: decode slots
    cb_page_size: int = 8              # continuous backend: KV page size
    gamma: float = 1.0                 # PPO/GAE discount
    gae_lambda: float = 0.95           # PPO/GAE lambda
    checkpoint_dir: str = ""           # run-snapshot dir; also gets a
                                       # legacy "<dir>/final" state dump
    checkpoint_interval_steps: int = 1  # snapshot every N steps (0 = only
                                        # run start/end + failure)
    checkpoint_keep_last: int = 3      # snapshot retention (keep-last-k)
    supervise_trainer: bool = True     # warm trainer restart on crash
    max_trainer_restarts: int = 4      # warm-restart budget
    channel_bandwidth_gbps: float = 0.0  # simulated host-net weight path
    metrics_jsonl: str = ""            # periodic metrics snapshots (JSONL)
    metrics_interval_s: float = 0.25   # sampler cadence when enabled
    auto_size_workers: bool = False    # planner-size stages left at 0
    elastic_interval_s: float = 0.0    # >0: live rebalance cadence (s)
    max_stage_workers: int = 8         # auto-size / elastic pool cap
    # -- supervision & fault tolerance --------------------------------
    supervise: bool = True             # generator-fleet crash recovery
    max_replica_restarts: int = 8      # fleet-wide respawn budget
    heartbeat_timeout_s: float = 10.0  # hung-replica detection threshold
    max_stage_retries: int = 2         # retryable-error attempts on top
    retry_backoff_s: float = 0.05      # base exponential backoff
    faults: Optional[Any] = None       # FaultConfig: chaos injection
    device: str = "cuda"               # where params, rollout and updates run


class Trainer:
    """from repro_torch.api import Trainer; Trainer(TrainerConfig()).fit()"""

    def __init__(self, tcfg: TrainerConfig,
                 model_cfg=None, params=None):
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        cfg = model_cfg or get_config(tcfg.arch)
        if tcfg.reduced and model_cfg is None:
            cfg = dataclasses.replace(
                cfg.reduced(), vocab_size=ByteTokenizer.vocab_size)
        self.cfg = cfg
        if params is None:
            params = init_params(tcfg.seed, cfg, device=self.device)
        ref_params = None
        if tcfg.kl_coef > 0:
            ref_params = tree_map(lambda t: t.clone(), params)
        self.rollout_engine = RolloutEngine(
            cfg, group_size=tcfg.group_size,
            max_new_tokens=tcfg.max_new_tokens,
            reward_fn=(math_reward_shaped if tcfg.reward == "shaped"
                       else math_reward),
            ref_params=ref_params, chunk_tokens=tcfg.chunk_tokens,
            backend=tcfg.rollout_backend, cb_slots=tcfg.cb_slots,
            cb_page_size=tcfg.cb_page_size, cb_seed=tcfg.seed,
            ref_rows=tcfg.train_micro_batch, ref_len=tcfg.seq_len,
            device=self.device)
        opt = OptimizerConfig(lr=tcfg.lr, warmup_steps=2,
                              total_steps=tcfg.num_steps,
                              schedule=cfg.lr_schedule
                              if cfg.lr_schedule != "cosine" else "constant")
        global_batch = tcfg.prompts_per_step * tcfg.group_size
        if tcfg.algorithm == "ppo":
            rl_cfg = PPOConfig(kl_coef=tcfg.kl_coef)
            self.train_engine = TrainEngine(
                cfg, params, rl=rl_cfg, opt=opt, algorithm="ppo",
                global_batch=global_batch, seq_len=tcfg.seq_len)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(tcfg.seed + 1)
            self.critic_engine = CriticEngine(
                cfg, init_critic_params(gen, cfg), rl=rl_cfg, opt=opt,
                global_batch=global_batch, seq_len=tcfg.seq_len)
        else:
            self.train_engine = TrainEngine(
                cfg, params, rl=GRPOConfig(kl_coef=tcfg.kl_coef), opt=opt,
                global_batch=global_batch, seq_len=tcfg.seq_len)
            self.critic_engine = None
        self.engines = {"rollout": self.rollout_engine,
                        "actor": self.train_engine}
        if self.critic_engine is not None:
            self.engines["critic"] = self.critic_engine
        self.dataset = PromptDataset(seed=tcfg.seed)

    def fit(self, resume: Optional[str] = None):
        """Run the workflow; the returned ``WorkflowResult`` carries the
        full telemetry dict (per-stage table, busy/wait fractions,
        staleness quantiles, raw metrics snapshot) — render it with
        :func:`repro_torch.core.obs.render_report`.

        ``resume="auto"`` (or an explicit snapshot path) cold-resumes a
        killed run from its newest intact run snapshot under
        ``checkpoint_dir``: engine states, the published weight version,
        rollout sampling bases and the dataset cursor are restored, so a
        fixed-seed resumed run reproduces the uninterrupted run's metrics
        bit-for-bit (synchronous/streaming modes). ``"auto"`` with no
        snapshot on disk silently starts fresh; an explicit path that is
        missing or torn raises."""
        t = self.tcfg
        resume_doc = None
        if resume:
            resume_doc = self._load_resume(resume)
        wcfg = WorkflowConfig(
            mode=t.mode, num_rollout_workers=t.rollout_workers,
            rollout_batch=t.rollout_batch,
            train_micro_batch=t.train_micro_batch,
            prompts_per_step=t.prompts_per_step, group_size=t.group_size,
            num_steps=t.num_steps, staleness=t.staleness,
            staggered=t.staggered, policy=t.policy,
            num_storage_units=t.num_storage_units,
            channel_bandwidth_gbps=t.channel_bandwidth_gbps,
            metrics_jsonl=t.metrics_jsonl,
            metrics_interval_s=t.metrics_interval_s,
            auto_size_workers=t.auto_size_workers,
            elastic_interval_s=t.elastic_interval_s,
            max_stage_workers=t.max_stage_workers,
            supervise=t.supervise,
            max_replica_restarts=t.max_replica_restarts,
            heartbeat_timeout_s=t.heartbeat_timeout_s,
            max_stage_retries=t.max_stage_retries,
            retry_backoff_s=t.retry_backoff_s, faults=t.faults,
            checkpoint_dir=t.checkpoint_dir,
            checkpoint_interval_steps=t.checkpoint_interval_steps,
            checkpoint_keep_last=t.checkpoint_keep_last,
            supervise_trainer=t.supervise_trainer,
            max_trainer_restarts=t.max_trainer_restarts)
        graph = build_dataflow(t.algorithm, kl_coef=t.kl_coef,
                               gamma=t.gamma, lam=t.gae_lambda)
        runner = StageRunner(
            wcfg, graph, engines=self.engines,
            prompt_stream=lambda s: self.dataset.prompts_for_step(
                s, t.prompts_per_step),
            resume=resume_doc)
        result = runner.run()
        if t.checkpoint_dir:
            # legacy single-state dump alongside the run snapshots (the
            # snapshots own the directory root)
            from repro_torch.training import save_checkpoint
            save_checkpoint(os.path.join(t.checkpoint_dir, "final"),
                            self.train_engine.state,
                            step=int(self.train_engine.state.step))
        return result

    def _load_resume(self, resume: str) -> Optional[dict]:
        """Resolve + load a run snapshot and restore engine/rollout state
        in place; returns the run-state doc handed to the StageRunner."""
        t = self.tcfg
        if not t.checkpoint_dir and resume == "auto":
            return None
        from repro_torch.core.recovery import RunCheckpointer
        ckpt = RunCheckpointer(t.checkpoint_dir or ".",
                               keep_last=t.checkpoint_keep_last)
        path = ckpt.resolve(resume)
        if path is None:
            return None                 # auto + nothing intact: fresh run
        doc = ckpt.load(path)
        step = int(doc["step"])
        for key, eng in ((k, e) for k, e in self.engines.items()
                         if hasattr(e, "state")):
            if key in doc.get("engines", []):
                eng.state, _ = ckpt.load_engine(path, key, eng.state)
                if hasattr(eng, "version"):
                    eng.version = step
        roll = doc.get("rollout") or {}
        self.rollout_engine._gid = int(roll.get("gid", 0))
        self.rollout_engine.cb_uid_start = int(roll.get("cb_next_uid", 0))
        return doc

    def restore(self, path: str) -> int:
        """Load a checkpoint into the training engine; returns the step."""
        from repro_torch.training import restore_checkpoint
        state, step = restore_checkpoint(path, self.train_engine.state)
        self.train_engine.state = state
        return step
