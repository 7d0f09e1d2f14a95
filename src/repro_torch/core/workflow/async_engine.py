"""Producer-consumer asynchronous RL workflow (paper §4) — legacy facade.

``AsyncRLRunner`` keeps the original two-task surface (a fused rollout
engine exposing ``generate``/``generate_chunked`` plus a train engine
exposing ``update``) but no longer hard-codes its own worker loops: it
compiles the fused shape into a two-stage :class:`StageGraph` and runs it
through the generic :class:`StageRunner` over a single shared
TransferQueue. Multi-stage dataflows (generate → ref_inference →
reward/advantage → actor/critic update) are declared in ``rl/grpo.py``
and ``rl/ppo.py`` and run through the same runner — see
``stage_graph.py`` for the mode semantics (baseline / streaming / async),
the staleness gate and delayed parameter update, all of which are owned
by the runner and therefore shared by every dataflow.

Every sample row carries the weight version that produced it; observed
staleness at consumption is recorded and property-tested:
``max(staleness) <= cfg.staleness + 1`` by construction (generation-time
gate + one-step-ahead prompt release), with mean ≤ ``staleness``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from repro_torch.core.workflow.events import EventLog
from repro_torch.core.workflow.stage_graph import (StageGraph, StageRunner,
                                                   StageSpec, WorkflowConfig,
                                                   WorkflowResult)

ROLLOUT_TASK = "actor_rollout"
TRAIN_TASK = "actor_update"


class AsyncRLRunner:
    """Drives a fused rollout producer and a trainer consumer through the
    stage-graph runner under the configured workflow mode.

    rollout_engine — .generate(params, prompts, rng) ->
        list of row dicts: {prompt, response, logprob, reward,
        advantage, token_len}; one row per (prompt x G) sample. Engines
        with ``chunk_tokens > 0`` use .generate_chunked for partial
        rollout (k1.5-style, §4.2.1).
    train_engine   — .update(batch) -> metrics dict or {} (handles its
        own gradient accumulation); exposes .params.
    prompt_stream(step) — prompts for one training step.
    """

    def __init__(self, cfg: WorkflowConfig, *,
                 rollout_engine, train_engine,
                 prompt_stream: Callable[[int], List[Any]],
                 log: Optional[EventLog] = None):
        self.cfg = cfg
        self.rollout_engine = rollout_engine
        self.train_engine = train_engine
        columns = ("response", "logprob", "response_mask", "reward",
                   "advantage") + tuple(cfg.extra_columns)
        chunked = getattr(rollout_engine, "chunk_tokens", 0) > 0

        def _fused_generate(batch, *, params, rng, version=0, **kw):
            if chunked:
                rows, conts = rollout_engine.generate_chunked(
                    params, batch["prompt"], rng, version=version)
            else:
                rows = rollout_engine.generate(params, batch["prompt"], rng)
                conts = []
            return {"rows": rows, "requeue": conts}

        def _fused_update(batch, **kw):
            return train_engine.update(batch)

        graph = StageGraph(source_columns=("prompt",))
        graph.add(StageSpec(ROLLOUT_TASK, inputs=("prompt",),
                            outputs=columns + ("version",),
                            engine="rollout", fn=_fused_generate,
                            kind="generate"))
        graph.add(StageSpec(TRAIN_TASK, inputs=columns + ("version",),
                            engine="train", fn=_fused_update,
                            kind="train", drives_steps=True))
        self.runner = StageRunner(
            cfg, graph,
            engines={"rollout": rollout_engine, "train": train_engine},
            prompt_stream=prompt_stream, log=log)
        self.tq = self.runner.tq
        self.log = self.runner.log

    @property
    def metrics(self) -> List[dict]:
        return self.runner.metrics

    @property
    def staleness_seen(self) -> List[int]:
        return self.runner.staleness_seen

    def run(self) -> WorkflowResult:
        return self.runner.run()
