"""Service-oriented user interface (paper §5.1).

The key APIs the paper lists for industrial workflow automation:
  init_engines, put_prompts_data, put_experience_data,
  get_experience_data, weight_sync_notify
exposed over the in-process service object (an RPC layer would wrap this
1:1 on a real cluster — the surface is the contribution, not the wire).

Workflow automation on top of the stage-graph subsystem: services can
``register_dataflow`` custom algorithm graphs, ``register_stage`` extra
streaming tasks onto an existing graph (e.g. a filtering or auxiliary
scoring stage), and ``run_dataflow`` to compile a graph onto one shared
TransferQueue and drive it under any workflow mode.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.obs import get_registry, render_report
from repro_torch.core.transfer_queue import TransferQueue
from repro_torch.core.workflow.stage_graph import (StageGraph, StageRunner,
                                                   StageSpec, WorkflowConfig,
                                                   build_dataflow,
                                                   register_dataflow)
from repro_torch.core.workflow.weight_sync import (WeightChannel,
                                                   WeightReceiver,
                                                   WeightSender)
from repro_torch.engines.adapter import EngineRegistry


class AsyncFlowService:
    """Single service endpoint orchestrating engines, TransferQueue and
    weight synchronization."""

    def __init__(self):
        self.engines: Dict[str, Any] = {}
        self.queues: Dict[str, TransferQueue] = {}
        self.channel = WeightChannel()
        self.sender: Optional[WeightSender] = None
        self.receivers: List[WeightReceiver] = []
        self._version = 0

    # -- paper §5.1 key APIs -------------------------------------------------

    def init_engines(self, specs: Dict[str, dict]) -> None:
        """specs: {"train": {"engine": "torch_train", ...kwargs},
                   "rollout": {"engine": "torch_rollout", ...}}
        (``torch_critic`` for a PPO critic). The rollout engine takes
        ``device`` (``cuda`` unless given) and the one shape of its
        reference calls (``ref_rows``, ``ref_len``); the train and critic
        engines run where their initial parameters live."""
        for name, spec in specs.items():
            kw = dict(spec)
            engine = kw.pop("engine")
            self.engines[name] = EngineRegistry.create(engine, **kw)

    def create_queue(self, name: str, capacity: int,
                     tasks: Dict[str, Sequence[str]],
                     num_storage_units: int = 2, policy: str = "fifo"
                     ) -> TransferQueue:
        q = TransferQueue(capacity, tasks, num_storage_units, policy)
        self.queues[name] = q
        return q

    def put_prompts_data(self, queue: str, prompts: Sequence[Any]) -> List[int]:
        q = self.queues[queue]
        idxs = q.next_indices(len(prompts))
        q.put_batch(idxs, "prompt", list(prompts))
        return idxs

    def put_experience_data(self, queue: str, columns: Dict[str, Sequence],
                            token_lens: Optional[Sequence[int]] = None
                            ) -> List[int]:
        q = self.queues[queue]
        n = len(next(iter(columns.values())))
        idxs = q.next_indices(n)
        for col, vals in columns.items():
            q.put_batch(idxs, col, list(vals), token_lens=token_lens)
        return idxs

    def get_experience_data(self, queue: str, task: str, batch_size: int,
                            consumer: str = "dp0", timeout: float = None):
        return self.queues[queue].get(task, batch_size, consumer,
                                      timeout=timeout)

    def weight_sync_notify(self, params, version: Optional[int] = None) -> int:
        """Publish new weights to all registered receivers."""
        if self.sender is None:
            self.sender = WeightSender(self.channel, mode="async")
        self._version = version if version is not None else self._version + 1
        self.sender.publish(params, self._version)
        return self._version

    def register_receiver(self, init_params) -> WeightReceiver:
        r = WeightReceiver(self.channel, init_params, version=0)
        self.receivers.append(r)
        return r

    # -- telemetry (the monitoring surface an operator dashboard polls) ------

    def metrics_snapshot(self) -> Dict[str, dict]:
        """JSON-safe snapshot of the process-global metrics registry:
        queue depths, per-stage latency/throughput, weight-sync stats."""
        return get_registry().snapshot()

    def telemetry_report(self, result) -> str:
        """Render a finished run's per-stage telemetry table
        (``WorkflowResult.telemetry``) as fixed-width text."""
        return render_report(result.telemetry)

    # -- stage-graph workflow automation (§5.1) ------------------------------

    def register_dataflow(self, name: str,
                          builder: Callable[..., StageGraph]) -> None:
        """Register a custom algorithm dataflow (``builder(**kw) ->
        StageGraph``) selectable via ``TrainerConfig(algorithm=name)``."""
        register_dataflow(name, builder)

    def build_dataflow(self, name: str, **kw) -> StageGraph:
        return build_dataflow(name, **kw)

    def register_stage(self, graph: StageGraph, spec: StageSpec
                       ) -> StageGraph:
        """Attach a custom streaming task to an existing dataflow; the
        graph re-validates (topology checks) at run time."""
        return graph.add(spec)

    def run_dataflow(self, graph: Union[str, StageGraph],
                     cfg: WorkflowConfig, prompt_stream,
                     engines: Optional[Dict[str, Any]] = None, **kw):
        """Compile a dataflow onto one shared TransferQueue and run it.
        ``engines`` defaults to the engines created via init_engines."""
        if isinstance(graph, str):
            graph = build_dataflow(graph, **kw)
        runner = StageRunner(cfg, graph,
                             engines=engines or self.engines,
                             prompt_stream=prompt_stream)
        return runner.run()
