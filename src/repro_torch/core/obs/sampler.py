"""Periodic JSONL metrics emitter.

A daemon thread that appends ``MetricsRegistry.snapshot()`` to a file as
one JSON object per line at a fixed interval — the machine-readable
timeline that pairs with the Chrome trace (spans) and the final report
(aggregates). :class:`StageRunner` starts one when
``WorkflowConfig.metrics_jsonl`` is set and stops it (with a final
flush sample) when the run ends.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from repro_torch.core.obs.registry import MetricsRegistry


class MetricsSampler:
    """Appends one ``{"t": ..., "elapsed_s": ..., "metrics": ...}`` line
    per ``interval_s`` to ``path``. Thread-safe, idempotent stop."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 0.25):
        self.registry = registry
        self.path = path
        self.interval_s = max(0.01, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        self._write_lock = threading.Lock()

    def _emit(self, fh) -> None:
        line = json.dumps({
            "t": time.time(),
            "elapsed_s": round(time.monotonic() - self._t0, 6),
            "metrics": self.registry.snapshot(),
        })
        with self._write_lock:
            fh.write(line + "\n")
            fh.flush()

    def _loop(self) -> None:
        with open(self.path, "a") as fh:
            while not self._stop.wait(self.interval_s):
                self._emit(fh)
            self._emit(fh)   # final sample so short runs never emit zero

    def start(self) -> "MetricsSampler":
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-sampler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
