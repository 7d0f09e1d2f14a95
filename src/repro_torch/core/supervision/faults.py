"""Deterministic fault injection for chaos tests and benchmarks.

Every injection decision is a pure function of (seed, stage, worker,
call-ordinal): the Nth call a given (stage, worker) pair makes always
draws the same uniform, so a chaos run is exactly reproducible under a
fixed seed — the property the crash-recovery determinism tests assert.

The probability bands partition one uniform draw::

    [0, crash_p)                        -> ReplicaCrash
    [crash_p, crash_p + error_p)        -> TransientStageError
    [.., .. + delay_p)                  -> sleep(delay_s)
    otherwise                           -> no fault
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.obs import get_registry
from repro_torch.core.supervision.errors import ReplicaCrash, TransientStageError

__all__ = ["FaultConfig", "FaultInjector"]


@dataclass(frozen=True)
class FaultConfig:
    """Crash/error/delay probabilities per stage call. ``stages`` limits
    injection to the named stages (empty = every stage); ``max_crashes``
    bounds total injected crashes (0 = unlimited) so a bounded restart
    budget cannot be exhausted by the injector itself.
    ``crash_on_calls`` schedules *deterministic* crashes at exact
    per-(stage, worker) call ordinals on top of the probability bands —
    how the trainer-kill arm murders the driver at a chosen mid-run
    step instead of hunting for a seed."""
    crash_p: float = 0.0
    error_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.02
    seed: int = 0
    stages: Tuple[str, ...] = ()
    max_crashes: int = 0
    crash_on_calls: Tuple[int, ...] = ()

    @property
    def active(self) -> bool:
        return (self.crash_p + self.error_p + self.delay_p) > 0.0 \
            or bool(self.crash_on_calls)


class FaultInjector:
    """Config-driven deterministic chaos. Call :meth:`check` once per
    stage invocation; it raises (crash/error), sleeps (delay), or
    returns clean."""

    def __init__(self, cfg: FaultConfig, metrics=None,
                 sleep=time.sleep):
        self.cfg = cfg
        self._sleep = sleep
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[str, int], int] = {}
        self._crashes = 0
        m = metrics if metrics is not None else get_registry()
        self._m_injected = m.counter(
            "faults_injected_total",
            "faults injected per stage and kind (crash | error | delay)")

    def _uniform(self, stage: str, worker: int, ordinal: int) -> float:
        key = f"{self.cfg.seed}:{stage}:{worker}:{ordinal}".encode()
        h = hashlib.blake2b(key, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def crashes_injected(self) -> int:
        with self._lock:
            return self._crashes

    def check(self, stage: str, worker: int = 0) -> None:
        cfg = self.cfg
        if not cfg.active or (cfg.stages and stage not in cfg.stages):
            return
        with self._lock:
            ordinal = self._calls.get((stage, worker), 0)
            self._calls[(stage, worker)] = ordinal + 1
            u = self._uniform(stage, worker, ordinal)
            crash = ordinal in cfg.crash_on_calls or \
                (u < cfg.crash_p and
                 (cfg.max_crashes <= 0 or self._crashes < cfg.max_crashes))
            if crash:
                self._crashes += 1
        if crash:
            self._m_injected.inc(stage=stage, kind="crash")
            raise ReplicaCrash(
                f"injected crash (stage={stage}, worker={worker}, "
                f"call={ordinal})", replica=worker)
        if cfg.crash_p <= u < cfg.crash_p + cfg.error_p:
            self._m_injected.inc(stage=stage, kind="error")
            raise TransientStageError(
                f"injected transient error (stage={stage}, "
                f"worker={worker}, call={ordinal})")
        if cfg.crash_p + cfg.error_p <= u < \
                cfg.crash_p + cfg.error_p + cfg.delay_p:
            self._m_injected.inc(stage=stage, kind="delay")
            self._sleep(cfg.delay_s)
