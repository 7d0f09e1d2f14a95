"""Metrics registry — labeled counters, gauges and histograms.

The unified telemetry layer for the streaming RL dataflow: every hot
layer (TransferQueue controllers, StageRunner workers, the weight-sync
path) records into one :class:`MetricsRegistry`. The registry is
deliberately tiny and dependency-free (stdlib only) so the control plane
can afford to update it inside its scheduling locks:

* :class:`Counter`   — monotonically increasing totals
  (``tq_rows_consumed_total``, ``stage_tokens_total``, ...).
* :class:`Gauge`     — last-write-wins instantaneous values
  (``tq_ready_depth``).
* :class:`Histogram` — value distributions with p50/p95/p99 summaries
  (``stage_batch_seconds``, ``train_staleness``).

Every metric family is labeled: ``counter.inc(3, stage="generate")``
keeps one series per label set. Hot paths pre-bind a label set once with
``metric.labels(stage="generate")`` and call ``.inc()``/``.observe()``
on the bound handle, avoiding per-call label sorting.

A process-global default registry backs everything that does not pass an
explicit registry (``get_registry()``); tests isolate themselves with
``with scoped() as reg: ...`` which swaps the default in and out.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def quantile(xs_sorted: List[float], q: float) -> float:
    """Linearly interpolated quantile of an ascending-sorted list."""
    if not xs_sorted:
        return float("nan")
    if len(xs_sorted) == 1:
        return float(xs_sorted[0])
    pos = q * (len(xs_sorted) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs_sorted) - 1)
    frac = pos - lo
    return float(xs_sorted[lo] * (1.0 - frac) + xs_sorted[hi] * frac)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple, object] = {}

    def label_sets(self) -> List[dict]:
        with self._lock:
            return [dict(k) for k in self._series]


class _BoundCounter:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Counter", key: Tuple):
        self._metric = metric
        self._key = key

    def inc(self, value: float = 1.0) -> None:
        m = self._metric
        with m._lock:
            m._series[self._key] = m._series.get(self._key, 0.0) + value


class Counter(_Metric):
    kind = "counter"

    def labels(self, **labels) -> _BoundCounter:
        return _BoundCounter(self, _label_key(labels))

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": dict(k), "value": float(v)} for k, v in items]


class _BoundGauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Gauge", key: Tuple):
        self._metric = metric
        self._key = key

    def set(self, value: float) -> None:
        m = self._metric
        with m._lock:
            m._series[self._key] = float(value)

    def inc(self, value: float = 1.0) -> None:
        m = self._metric
        with m._lock:
            m._series[self._key] = m._series.get(self._key, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def labels(self, **labels) -> _BoundGauge:
        return _BoundGauge(self, _label_key(labels))

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": dict(k), "value": float(v)} for k, v in items]


class _HistSeries:
    __slots__ = ("count", "total", "mn", "mx", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.mn = float("inf")
        self.mx = float("-inf")
        self.samples: List[float] = []


class _BoundHistogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Histogram", key: Tuple):
        self._metric = metric
        self._key = key

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)


class Histogram(_Metric):
    """Distribution summary. ``count``/``sum``/``min``/``max`` are exact;
    quantiles come from a bounded ring of the most recent ``max_samples``
    observations (older samples are overwritten — a run-scoped summary,
    not an archival reservoir)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", max_samples: int = 65536):
        super().__init__(name, help)
        self.max_samples = max_samples

    def labels(self, **labels) -> _BoundHistogram:
        return _BoundHistogram(self, _label_key(labels))

    def _observe(self, key: Tuple, value: float) -> None:
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries()
            v = float(value)
            s.total += v
            s.mn = min(s.mn, v)
            s.mx = max(s.mx, v)
            if len(s.samples) < self.max_samples:
                s.samples.append(v)
            else:
                s.samples[s.count % self.max_samples] = v
            s.count += 1

    def observe(self, value: float, **labels) -> None:
        self._observe(_label_key(labels), value)

    @staticmethod
    def _summary(s: _HistSeries) -> dict:
        xs = sorted(s.samples)
        return {
            "count": s.count,
            "sum": s.total,
            "min": s.mn if s.count else float("nan"),
            "max": s.mx if s.count else float("nan"),
            "mean": s.total / s.count if s.count else float("nan"),
            "p50": quantile(xs, 0.50),
            "p95": quantile(xs, 0.95),
            "p99": quantile(xs, 0.99),
        }

    def summary(self, **labels) -> dict:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return self._summary(_HistSeries())
            return self._summary(s)

    def snapshot(self) -> List[dict]:
        with self._lock:
            items = [(k, self._summary(s)) for k, s in self._series.items()]
        return [{"labels": dict(k), **summ} for k, summ in items]


class MetricsRegistry:
    """Thread-safe registry of named metric families. ``counter()`` /
    ``gauge()`` / ``histogram()`` are get-or-create: the same name always
    returns the same family (and raises TypeError on a kind mismatch), so
    instrumented layers never need to coordinate creation order."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self.epoch = 0                 # bumped by clear()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 65536) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   max_samples=max_samples)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """{metric_name: {"type", "help", "values": [...]}} — JSON-safe."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"type": m.kind, "help": m.help,
                         "values": m.snapshot()}
                for m in metrics}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self.epoch += 1


# -- process-global default -------------------------------------------------

_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (what instrumented layers use
    when not handed an explicit registry)."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Replace the process-global default; returns the previous one."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = registry
        return prev


class DefaultCounter:
    """One series of a counter of the process default registry, bound
    again whenever that registry is replaced or cleared: for code with no
    construction step to bind at (the model's plain functions). An
    ``inc`` costs two attribute checks beside the counter's own lock."""

    def __init__(self, name: str, help: str = "", **labels):
        self._name, self._help, self._labels = name, help, labels
        self._reg: Optional[MetricsRegistry] = None
        self._epoch = -1
        self._bound: Optional[_BoundCounter] = None

    def inc(self, value: float = 1.0) -> None:
        reg = _default_registry
        if reg is not self._reg or reg.epoch != self._epoch:
            self._bound = reg.counter(self._name, self._help).labels(
                **self._labels)
            self._reg, self._epoch = reg, reg.epoch
        self._bound.inc(value)


@contextmanager
def scoped(registry: Optional[MetricsRegistry] = None
           ) -> Iterator[MetricsRegistry]:
    """Swap a fresh (or given) registry in as the process default for the
    duration of the block — the test-isolation helper."""
    reg = registry if registry is not None else MetricsRegistry()
    prev = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(prev)
