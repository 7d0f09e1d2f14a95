"""Bounded retry with exponential backoff + deterministic jitter.

The jitter is a pure function of (seed, attempt) so two runs of the same
fixed-seed workload sleep identically — chaos runs stay reproducible,
which the crash-recovery determinism tests rely on.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.supervision.errors import is_retryable

__all__ = ["RetryPolicy", "call_with_retry"]


def _unit_hash(*parts) -> float:
    """Deterministic uniform in [0, 1) from the given key parts."""
    key = ":".join(str(p) for p in parts).encode()
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` total calls (1 = no retries); backoff for attempt
    ``k`` (0-based failure count) is ``base_s * multiplier**k`` capped at
    ``max_backoff_s``, scaled by a deterministic jitter factor in
    ``[1 - jitter, 1)``."""
    max_attempts: int = 3
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def backoff_s(self, attempt: int, key: str = "") -> float:
        raw = min(self.base_s * self.multiplier ** attempt,
                  self.max_backoff_s)
        u = _unit_hash(self.seed, key, attempt)
        return raw * (1.0 - self.jitter * u)


def call_with_retry(fn: Callable, *args, policy: RetryPolicy,
                    key: str = "",
                    on_retry: Optional[Callable] = None,
                    sleep: Callable[[float], None] = time.sleep, **kw):
    """Call ``fn``; on a retryable exception back off and retry up to
    ``policy.max_attempts`` total attempts. Non-retryable exceptions and
    the final failure propagate unchanged. ``on_retry(attempt, exc)`` is
    invoked before each backoff (metrics hook)."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kw)
        except BaseException as e:                   # noqa: BLE001
            if not is_retryable(e) or attempt >= policy.max_attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.backoff_s(attempt, key))
            attempt += 1
