"""Error taxonomy for the supervised streaming runtime.

The stage graph distinguishes three failure classes (LlamaRL's
parent-supervised recovery / Laminar's trajectory-level fault tolerance):

* :class:`RetryableError` — transient stage failures (flaky I/O, a
  momentarily exhausted KV pool, an injected soft fault). Workers retry
  the same call in place with exponential backoff + deterministic jitter
  and bounded attempts; exhausting the budget escalates to a loud
  failure.
* :class:`ReplicaCrash` — the replica itself died (process-level crash
  in a real deployment; a worker-thread death here). Recoverable at the
  *fleet* level: the supervisor requeues the replica's leased rows and
  respawns a replacement. Never retried in place — the crashed worker's
  state is gone.
* everything else — fatal. The run fails loudly with the originating
  stage name and worker index attached (never as a silent daemon
  death).

External exception types (e.g. an engine's pool-exhaustion error) can be
declared transient with :func:`register_retryable` without importing
this layer into the engine's hot path.
"""
from __future__ import annotations

from typing import Tuple, Type

__all__ = ["ReplicaCrash", "RetryableError", "SupervisionExhausted",
           "TransientStageError", "WeightSyncTimeout", "is_retryable",
           "register_retryable"]


class RetryableError(Exception):
    """Transient failure: safe to retry the same call after a backoff."""


class TransientStageError(RetryableError):
    """A stage call failed transiently (also raised by fault injection)."""


class ReplicaCrash(Exception):
    """A replica died mid-flight. Fleet-level recovery: requeue its
    in-flight work and respawn — never retried in place."""

    def __init__(self, msg: str = "replica crash", *, replica: int = -1):
        super().__init__(msg)
        self.replica = replica


class SupervisionExhausted(RuntimeError):
    """The supervisor hit its restart budget — recovery gave up."""


class WeightSyncTimeout(RuntimeError):
    """A weight wait timed out. Carries the version the caller waited
    for and the newest version the channel had actually seen, so a
    timeout is never mistaken for a successful no-op."""

    def __init__(self, waited_for: int, latest_seen: int,
                 timeout_s: float = 0.0):
        self.waited_for = waited_for
        self.latest_seen = latest_seen
        self.timeout_s = timeout_s
        super().__init__(
            f"timed out after {timeout_s:.1f}s waiting for weight version "
            f">= {waited_for} (latest version seen: {latest_seen})")


_EXTRA_RETRYABLE: Tuple[Type[BaseException], ...] = ()


def register_retryable(exc_type: Type[BaseException]) -> None:
    """Declare an external exception type transient (idempotent)."""
    global _EXTRA_RETRYABLE
    if exc_type not in _EXTRA_RETRYABLE:
        _EXTRA_RETRYABLE = _EXTRA_RETRYABLE + (exc_type,)


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, (ReplicaCrash, WeightSyncTimeout)):
        return False
    return isinstance(exc, (RetryableError,) + _EXTRA_RETRYABLE)
