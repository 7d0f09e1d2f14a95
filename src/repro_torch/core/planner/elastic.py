"""Planner-driven elastic stage sizing (paper §4.3 meets §3.3).

Two halves, both consumed by :class:`~repro_torch.core.workflow.StageRunner`:

1. **Static auto-sizing** — ``estimate_stage_costs`` prices every stage
   of a :class:`StageGraph` in *seconds per experience row* using the
   analytical cost model (``CostOracle``: prefill + per-token decode for
   the generate stage, one forward for inference-style verbs, 3×forward
   for train verbs), with profiled per-stage latencies (from
   ``profiling.stage_latencies_from_registry`` or any override dict)
   taking precedence. ``auto_size_workers`` then picks worker counts so
   every stage keeps up with the step-driving trainer's consumption
   rate — replacing hand-tuned ``num_workers`` wherever a spec left it
   at 0. Only the *relative* stage costs matter for sizing, so the
   analytic TPU-scale numbers transfer to the CPU-reduced runs.

2. **Live rebalance** — :class:`ElasticController` watches the
   ``core/obs`` starvation signals (``stage_stalls_total``, the
   controllers' ``tq_blocked_wait_seconds_total``) and, on sustained
   starvation of a stage, grows the worker pool of the stages producing
   its inputs (or, when those are already at the cap, shrinks the
   starved — i.e. idle — stage back toward one worker). Decisions are
   mechanical and observable: ``stage_workers{stage}`` gauges plus a
   ``stage_rebalance_total{stage, action}`` counter.

``simulate_stage_pipeline`` is the planner-side estimate of a sized
pipeline's wall time (bottleneck service rate + fill latency); tests use
it to assert elastic counts beat deliberately starved hand-tuned ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.planner.cost_model import HW
from repro_torch.core.planner.simulator import CostOracle

# seconds per row for pure-python fn stages (reward parsing, GAE, ...)
DEFAULT_FN_STAGE_S = 1e-4

# inference-style engine verbs priced as one forward pass
_FORWARD_VERBS = ("compute_log_prob", "compute_values")


@dataclasses.dataclass
class StageCost:
    """Estimated cost of one stage, normalized per experience row."""
    name: str
    seconds_per_row: float
    source: str          # "profiled" | "analytic" | "default"
    kind: str = "transform"


def _forward_s(oracle: CostOracle, seq: int) -> float:
    # one forward ≈ one third of the 3×forward train microbatch
    return oracle.train_microbatch_s(1, seq, 1) / 3.0


def estimate_stage_costs(graph, engines: Dict[str, Any], *,
                         seq_len: int = 32, group_size: int = 1,
                         hw: HW = HW(),
                         profiled: Optional[Dict[str, float]] = None,
                         ) -> Dict[str, StageCost]:
    """Price every stage of ``graph`` in seconds per experience row.

    ``profiled`` entries (stage name -> s/row) win over the analytic
    estimate; stages whose engine exposes no ``ModelConfig`` fall back to
    ``DEFAULT_FN_STAGE_S``.
    """
    profiled = profiled or {}
    costs: Dict[str, StageCost] = {}
    for spec in graph.stages.values():
        if spec.name in profiled:
            costs[spec.name] = StageCost(spec.name,
                                         max(profiled[spec.name], 1e-9),
                                         "profiled", spec.kind)
            continue
        engine = engines.get(spec.engine) if spec.engine else None
        model_cfg = getattr(engine, "cfg", None)
        if model_cfg is None or not hasattr(model_cfg, "vocab_size"):
            costs[spec.name] = StageCost(spec.name, DEFAULT_FN_STAGE_S,
                                         "default", spec.kind)
            continue
        oracle = CostOracle(model_cfg, hw)
        if spec.kind == "generate":
            g = max(int(getattr(engine, "group_size", group_size)), 1)
            max_new = max(int(getattr(engine, "max_new_tokens", seq_len)), 1)
            prompt_len = max(seq_len - max_new, 1)
            per_prompt = (oracle.prefill_s(g, prompt_len, 1)
                          + max_new * oracle.decode_token_s(
                              g, prompt_len + max_new, 1))
            s_row = per_prompt / g
        elif spec.kind in ("train", "train_stream"):
            s_row = oracle.train_microbatch_s(1, seq_len, 1)
        elif spec.verb in _FORWARD_VERBS:
            s_row = _forward_s(oracle, seq_len)
        else:
            # engine-backed transforms without a forward pass (reward
            # scoring etc.) are cheap relative to model stages
            s_row = DEFAULT_FN_STAGE_S
        costs[spec.name] = StageCost(spec.name, max(s_row, 1e-9),
                                     "analytic", spec.kind)
    return costs


def auto_size_workers(graph, costs: Dict[str, StageCost], *,
                      headroom: float = 1.25, max_workers: int = 8,
                      ) -> Dict[str, int]:
    """Worker counts per stage so every stage matches the step driver's
    row rate (with ``headroom`` slack), clamped to [1, max_workers].

    The drives_steps stage is the sink that defines throughput; it always
    gets exactly one worker (step semantics are single-threaded).
    """
    driver = next(s for s in graph.stages.values() if s.drives_steps)
    target_rate = 1.0 / costs[driver.name].seconds_per_row   # rows/s
    sizes: Dict[str, int] = {}
    for spec in graph.stages.values():
        if spec.name == driver.name:
            sizes[spec.name] = 1
            continue
        need = costs[spec.name].seconds_per_row * target_rate * headroom
        sizes[spec.name] = max(1, min(max_workers, math.ceil(need)))
    return sizes


def simulate_stage_pipeline(costs: Dict[str, StageCost],
                            workers: Dict[str, int], n_rows: int) -> float:
    """Planner-side wall-time estimate of a sized linear pipeline:
    ``n_rows`` through the bottleneck service rate plus one fill latency
    per stage. Monotone in worker counts — more workers on the slow
    stage is never worse."""
    rates = [workers.get(n, 1) / c.seconds_per_row for n, c in costs.items()]
    fill = sum(c.seconds_per_row for c in costs.values())
    return n_rows / min(rates) + fill


class ElasticController:
    """Live rebalance from ``core/obs`` starvation signals.

    One ``step()`` per interval reads counter deltas:

    * a stage *starves* in an interval when its empty-fetch counter
      (``stage_stalls_total{stage}``) or its controller's blocked wait
      (``tq_blocked_wait_seconds_total{task}``, summed over consumers)
      grew while no batch completed there.
    * ``patience`` consecutive starved intervals trigger a decision:
      grow the producers of the starved stage's input columns (below
      ``max_workers``), else shrink the starved stage itself (above
      ``min_workers``) — an idle pool whose upstream is maxed out only
      wastes scheduling slots.

    The controller never touches the drives_steps stage and is pure
    bookkeeping: ``apply(stage, delta)`` is the runner-provided callback
    that actually resizes pools.
    """

    def __init__(self, graph, registry, desired: Dict[str, int],
                 apply: Callable[[str, int], bool], *,
                 patience: int = 3, min_workers: int = 1,
                 max_workers: int = 8, wait_threshold_s: float = 0.05):
        self.graph = graph
        self.registry = registry
        self.desired = desired
        self.apply = apply
        self.patience = patience
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.wait_threshold_s = wait_threshold_s
        self._starved: Dict[str, int] = {n: 0 for n in graph.stages}
        self._last: Dict[str, Dict[str, float]] = {}
        # producers of each stage's inputs (source columns have none)
        prod = graph.producers()
        self._upstream: Dict[str, List[str]] = {
            name: sorted({prod[c] for c in spec.inputs if c in prod})
            for name, spec in graph.stages.items()}
        self._driver = next(s.name for s in graph.stages.values()
                            if s.drives_steps)
        self._c_rebalance = registry.counter(
            "stage_rebalance_total",
            "elastic worker-pool resizes (grow/shrink) per stage")

    def _read(self, name: str) -> Dict[str, float]:
        m = self.registry
        stalls = m.counter("stage_stalls_total", "")
        waits = m.counter("tq_blocked_wait_seconds_total", "")
        batches = m.histogram("stage_batch_seconds", "")
        wait_s = sum(row["value"] for row in waits.snapshot()
                     if row["labels"].get("task") == name)
        return {"stalls": stalls.value(stage=name),
                "wait_s": wait_s,
                "batches": batches.summary(stage=name)["count"]}

    def step(self) -> List[dict]:
        """One observation interval; returns the actions taken."""
        actions: List[dict] = []
        for name in self.graph.stages:
            cur = self._read(name)
            prev = self._last.get(name, {"stalls": 0.0, "wait_s": 0.0,
                                         "batches": 0})
            self._last[name] = cur
            # Two starvation shapes: non-blocking pollers stall (counter
            # grows, no batch lands); the blocking driver instead racks up
            # tq_blocked_wait_seconds while still completing batches — so
            # blocked-wait beyond a threshold flags starvation on its own.
            starving = (cur["wait_s"] - prev["wait_s"] > self.wait_threshold_s
                        or (cur["stalls"] > prev["stalls"]
                            and cur["batches"] == prev["batches"]))
            self._starved[name] = self._starved[name] + 1 if starving else 0
            if self._starved[name] < self.patience:
                continue
            self._starved[name] = 0
            grew = False
            for up in self._upstream.get(name, []):
                if up == self._driver:
                    continue
                if self.desired.get(up, 1) < self.max_workers \
                        and self.apply(up, +1):
                    self._c_rebalance.inc(stage=up, action="grow")
                    actions.append({"stage": up, "action": "grow",
                                    "starved": name})
                    grew = True
            if not grew and name != self._driver \
                    and self.desired.get(name, 1) > self.min_workers \
                    and self.apply(name, -1):
                self._c_rebalance.inc(stage=name, action="shrink")
                actions.append({"stage": name, "action": "shrink",
                                "starved": name})
        return actions
