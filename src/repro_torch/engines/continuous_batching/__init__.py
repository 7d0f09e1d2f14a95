"""Continuous-batching rollout subsystem: slot scheduler, paged KV
cache, and disaggregated prefill/decode dispatch (AsyncFlow §3.3)."""
from repro_torch.engines.continuous_batching.engine import (
    ContinuousBatchingEngine, SUPPORTED_ARCHS)
from repro_torch.engines.continuous_batching.paged_kv import (
    KVPoolExhausted, PagedKVPool)
from repro_torch.engines.continuous_batching.scheduler import (Sequence,
                                                               SlotScheduler)

__all__ = [
    "ContinuousBatchingEngine",
    "KVPoolExhausted",
    "PagedKVPool",
    "Sequence",
    "SlotScheduler",
    "SUPPORTED_ARCHS",
]
