"""Telemetry layer: the metrics registry (stdlib only). The reference's
JSONL sampler and per-stage report are not ported yet."""
from repro_torch.core.obs.registry import (Counter, Gauge, Histogram,
                                           MetricsRegistry, get_registry,
                                           quantile, scoped, set_registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "quantile", "scoped", "set_registry"]
