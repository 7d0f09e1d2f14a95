"""Unified telemetry layer: metrics registry, periodic JSONL sampler and
the per-stage report. Stdlib-only — safe to import from the control
plane's hot paths."""
from repro_torch.core.obs.registry import (Counter, Gauge, Histogram,
                                           MetricsRegistry, get_registry,
                                           quantile, scoped, set_registry)
from repro_torch.core.obs.report import build_telemetry, render_report
from repro_torch.core.obs.sampler import MetricsSampler

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsSampler", "build_telemetry", "get_registry", "quantile",
           "render_report", "scoped", "set_registry"]
