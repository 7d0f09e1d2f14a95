"""Execution-time simulator (paper §2 "hardware allocation pre-optimized
through an execution time simulator" + §4.3).

Discrete-event simulation of one RL post-training run at cluster scale:
rollout instances generate variable-length responses (lognormal tail —
the skew StreamRL/RLHFuse also model), the trainer consumes through
TransferQueue, and the workflow mode decides what overlaps:

  * colocated      — verl-like: whole cluster alternates rollout/train
                     with a resharding pause at every transition; static
                     per-DP-group prompt pre-allocation (stragglers gate
                     the switch).
  * separated      — task-separated pools, sequential (the Table-1
                     baseline): train waits for the full global batch.
  * separated_tq   — + TransferQueue: dynamic pull-based dispatch
                     (load-balanced) + micro-batch streaming overlap.
  * separated_async— + delayed parameter update: rollout never pauses at
                     iteration boundaries (≤1-step staleness).

Per-token/per-step costs come from the analytical cost model; the same
code paths accept profiled costs (hybrid cost model, §4.3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner.cost_model import HW, forward_flops, kv_cache_bytes


@dataclasses.dataclass
class Workload:
    prompts_per_step: int = 512
    group_size: int = 8
    prompt_len: int = 512
    mean_response_len: int = 2048
    response_sigma: float = 0.6      # lognormal sigma (long-tail skew)
    num_steps: int = 8
    seq_len_train: int = 4096


@dataclasses.dataclass
class ClusterPlan:
    n_chips: int
    rollout_chips: int
    train_chips: int
    rollout_tp: int = 4              # chips per rollout instance
    train_tp: int = 8
    reshard_s: float = 0.0           # colocated transition cost


class CostOracle:
    """Analytical per-task costs; override entries with profiled numbers
    for the hybrid cost model."""

    def __init__(self, cfg: ModelConfig, hw: HW = HW(),
                 overrides: Optional[Dict[str, float]] = None):
        self.cfg, self.hw = cfg, hw
        self.overrides = overrides or {}

    def decode_token_s(self, batch: int, kv_len: int, chips: int) -> float:
        """One decode step for a `batch` of sequences on one instance."""
        if "decode_token_s" in self.overrides:
            return self.overrides["decode_token_s"]
        fl = forward_flops(self.cfg, batch, 1, kv_len=kv_len)
        by = (self.cfg.active_param_count() * 2
              + kv_cache_bytes(self.cfg, batch, kv_len))
        t_c = fl / (chips * self.hw.peak_flops)
        t_m = by / (chips * self.hw.hbm_bw)
        return max(t_c, t_m)

    def prefill_s(self, batch: int, seq: int, chips: int) -> float:
        fl = forward_flops(self.cfg, batch, seq)
        return fl / (chips * self.hw.peak_flops * 0.5)  # 50% MFU prefill

    def train_microbatch_s(self, n_samples: int, seq: int,
                           chips: int) -> float:
        if "train_microbatch_s" in self.overrides:
            return self.overrides["train_microbatch_s"] * n_samples
        fl = 3.0 * forward_flops(self.cfg, n_samples, seq)
        return fl / (chips * self.hw.peak_flops * 0.45)  # 45% MFU train

    def weight_sync_s(self, chips_from: int, chips_to: int,
                      host_path: bool) -> float:
        nbytes = self.cfg.param_count() * 2
        bw = self.hw.host_net_bw if host_path else self.hw.ici_bw
        return nbytes / (bw * max(1, min(chips_from, chips_to)))


def _draw_response_lens(rng, w: Workload, n: int) -> np.ndarray:
    mu = math.log(w.mean_response_len) - w.response_sigma ** 2 / 2
    return np.maximum(16, rng.lognormal(mu, w.response_sigma, n)).astype(int)


def simulate(cfg: ModelConfig, plan: ClusterPlan, w: Workload, mode: str,
             *, hw: HW = HW(), seed: int = 0,
             oracle: Optional[CostOracle] = None) -> dict:
    """Returns {"throughput_samples_per_s", "step_times", "bubble_fraction"}."""
    rng = np.random.default_rng(seed)
    oracle = oracle or CostOracle(cfg, hw)
    G = w.group_size
    samples_per_step = w.prompts_per_step * G

    if mode == "colocated":
        n_inst = max(1, plan.n_chips // plan.rollout_tp)
        step_times = []
        for _ in range(w.num_steps):
            lens = _draw_response_lens(rng, w, samples_per_step)
            # static pre-allocation: round-robin groups of samples
            per_inst = np.zeros(n_inst)
            order = rng.permutation(samples_per_step)
            for i, s in enumerate(order):
                per_inst[i % n_inst] += lens[s]
            # decode batch per instance
            bsz = max(1, samples_per_step // n_inst)
            tok_s = oracle.decode_token_s(bsz, w.prompt_len
                                          + w.mean_response_len,
                                          plan.rollout_tp)
            t_rollout = (per_inst.max() / bsz) * tok_s \
                + oracle.prefill_s(samples_per_step, w.prompt_len,
                                   plan.n_chips)
            t_train = oracle.train_microbatch_s(
                samples_per_step, w.seq_len_train, plan.n_chips)
            step_times.append(t_rollout + t_train + 2 * plan.reshard_s
                              + oracle.weight_sync_s(plan.n_chips,
                                                     plan.n_chips, False))
        wall = float(np.sum(step_times))
        busy = wall - 2 * plan.reshard_s * w.num_steps
        return _result(wall, w, busy)

    # task-separated family
    n_inst = max(1, plan.rollout_chips // plan.rollout_tp)
    bsz = max(1, samples_per_step // n_inst // 2)
    tok_s = oracle.decode_token_s(bsz, w.prompt_len + w.mean_response_len,
                                  plan.rollout_tp)
    micro = max(1, samples_per_step // 16)
    t_micro_train = oracle.train_microbatch_s(micro, w.seq_len_train,
                                              plan.train_chips)
    n_micro = samples_per_step // micro
    sync_s = oracle.weight_sync_s(plan.train_chips, plan.rollout_chips,
                                  host_path=(mode == "separated_async"))

    inst_free = np.zeros(n_inst)       # next-free time per rollout instance
    trainer_t = 0.0
    train_busy = 0.0
    step_times = []
    t_prev_step_end = 0.0
    for step in range(w.num_steps):
        lens = _draw_response_lens(rng, w, samples_per_step)
        if mode == "separated":
            # static split, full-batch wait
            per_inst = np.zeros(n_inst)
            order = rng.permutation(samples_per_step)
            for i, s in enumerate(order):
                per_inst[i % n_inst] += lens[s]
            start = max(trainer_t, inst_free.max())
            rollout_done = start + (per_inst.max() / bsz) * tok_s
            t_train = n_micro * t_micro_train
            trainer_t = rollout_done + t_train + sync_s
            train_busy += t_train
            inst_free[:] = trainer_t    # rollout idles during train + sync
        else:
            # dynamic pull (TransferQueue): greedy balance by current load
            start = inst_free.copy()
            if mode == "separated_tq":
                start = np.maximum(start, trainer_t - 0.0)
            chunks = np.array_split(rng.permutation(lens),
                                    max(1, samples_per_step // bsz))
            done_times = []
            for ch in chunks:
                i = int(np.argmin(start))
                dt = ch.sum() / bsz * tok_s
                start[i] += dt
                done_times.append((start[i], len(ch)))
            done_times.sort()
            # trainer streams micro-batches as they complete
            acc = 0
            t = trainer_t
            for done_at, k in done_times:
                acc += k
                while acc >= micro:
                    t = max(t, done_at) + t_micro_train
                    train_busy += t_micro_train
                    acc -= micro
            if acc:
                t = max(t, done_times[-1][0]) + t_micro_train * acc / micro
                train_busy += t_micro_train * acc / micro
            if mode == "separated_tq":
                # on-policy: rollout instances wait for the new weights
                trainer_t = t + sync_s
                inst_free[:] = trainer_t
            else:
                # async: weight transfer overlaps; rollout continues
                trainer_t = t
                inst_free = start
        step_times.append(trainer_t - t_prev_step_end)
        t_prev_step_end = trainer_t

    wall = trainer_t
    return _result(wall, w, train_busy)


def _result(wall: float, w: Workload, train_busy: float) -> dict:
    n = w.num_steps * w.prompts_per_step * w.group_size
    return {"throughput_samples_per_s": n / wall,
            "wall_s": wall,
            "trainer_busy_fraction": train_busy / wall}
