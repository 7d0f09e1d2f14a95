"""Supervision layer: replica fleet registry + heartbeat recovery,
error taxonomy (retryable vs fatal), bounded retry with deterministic
backoff, and config-driven deterministic fault injection."""
from repro_torch.core.supervision.errors import (ReplicaCrash, RetryableError,
                                                 SupervisionExhausted,
                                                 TransientStageError,
                                                 WeightSyncTimeout, is_retryable,
                                                 register_retryable)
from repro_torch.core.supervision.faults import FaultConfig, FaultInjector
from repro_torch.core.supervision.retry import RetryPolicy, call_with_retry
from repro_torch.core.supervision.supervisor import ReplicaHandle, ReplicaSupervisor

__all__ = ["FaultConfig", "FaultInjector", "ReplicaCrash", "ReplicaHandle",
           "ReplicaSupervisor", "RetryPolicy", "RetryableError",
           "SupervisionExhausted", "TransientStageError",
           "WeightSyncTimeout", "call_with_retry", "is_retryable",
           "register_retryable"]
