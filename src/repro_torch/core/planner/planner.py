"""Graph-based task resource planner (paper §4.3).

Searches (rollout_chips : train_chips split) x (TP degrees) under a fixed
cluster size, scoring each candidate with the simulator + analytical cost
model (the fast path); candidates within ``profile_top_k`` of the best can
be re-scored with profiled costs (the accurate path) — the hybrid scheme
of the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner.cost_model import HW
from repro_torch.core.planner.simulator import (ClusterPlan, CostOracle, Workload,
                                          simulate)


@dataclasses.dataclass
class PlanResult:
    plan: ClusterPlan
    throughput: float
    candidates_scored: int


def candidate_plans(n_chips: int) -> List[ClusterPlan]:
    out = []
    for frac in (0.25, 0.375, 0.5, 0.625, 0.75):
        r = int(n_chips * frac)
        t = n_chips - r
        if r < 4 or t < 4:
            continue
        for rtp in (1, 2, 4, 8):
            if r % rtp:
                continue
            for ttp in (4, 8, 16):
                if t % ttp:
                    continue
                out.append(ClusterPlan(n_chips, r, t, rtp, ttp))
    return out


def plan_resources(cfg: ModelConfig, n_chips: int, w: Workload,
                   mode: str = "separated_async", *, hw: HW = HW(),
                   profile_fn: Optional[Callable[[ClusterPlan], dict]] = None,
                   profile_top_k: int = 3) -> PlanResult:
    cands = candidate_plans(n_chips)
    scored = []
    for plan in cands:
        r = simulate(cfg, plan, w, mode, hw=hw)
        scored.append((r["throughput_samples_per_s"], plan))
    scored.sort(key=lambda x: -x[0])

    if profile_fn is not None:
        # hybrid: re-score the shortlist with profiled block times
        best = []
        for tput, plan in scored[:profile_top_k]:
            overrides = profile_fn(plan)
            oracle = CostOracle(cfg, hw, overrides)
            r = simulate(cfg, plan, w, mode, hw=hw, oracle=oracle)
            best.append((r["throughput_samples_per_s"], plan))
        best.sort(key=lambda x: -x[0])
        tput, plan = best[0]
        return PlanResult(plan, tput, len(cands) + profile_top_k)

    tput, plan = scored[0]
    return PlanResult(plan, tput, len(cands))
