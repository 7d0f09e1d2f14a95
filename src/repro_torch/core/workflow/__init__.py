from repro_torch.core.supervision import (FaultConfig, FaultInjector, ReplicaCrash,
                                          ReplicaSupervisor, RetryableError,
                                          WeightSyncTimeout)
from repro_torch.core.workflow.async_engine import AsyncRLRunner
from repro_torch.core.workflow.events import Event, EventLog
from repro_torch.core.workflow.stage_graph import (StageGraph, StageRunner,
                                                   StageSpec, WorkflowConfig,
                                                   WorkflowResult, build_dataflow,
                                                   register_dataflow)
from repro_torch.core.workflow.weight_sync import (BroadcastWeightChannel,
                                                   StaggeredUpdateGroup,
                                                   VersionedWeights, WeightChannel,
                                                   WeightReceiver, WeightSender)

__all__ = ["AsyncRLRunner", "BroadcastWeightChannel", "Event", "EventLog",
           "FaultConfig", "FaultInjector", "ReplicaCrash",
           "ReplicaSupervisor", "RetryableError", "StageGraph", "StageSpec",
           "StageRunner", "StaggeredUpdateGroup", "VersionedWeights",
           "WeightChannel", "WeightReceiver", "WeightSender",
           "WeightSyncTimeout", "WorkflowConfig", "WorkflowResult",
           "build_dataflow", "register_dataflow"]
