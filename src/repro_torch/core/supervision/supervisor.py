"""Replica supervision: service registry, heartbeats, crash recovery.

:class:`ReplicaSupervisor` owns the generate-side replica fleet behind a
small service registry (monarch-style ``__supervise__`` / LlamaRL's
parent-supervised failure recovery). Each replica worker registers a
:class:`ReplicaHandle`, heartbeats it every iteration, and either
retires it on clean exit or reports its own death on a crash. A monitor
pass (:meth:`ReplicaSupervisor.poll`) additionally detects replicas that
died without reporting — thread no longer alive, or heartbeat stale
beyond the timeout (hung replica) — and for every dead replica:

1. **fences** it (a zombie thread that wakes up later must not write
   rows or ack leases — prevents duplicated experience),
2. **requeues** its in-flight work through the caller's requeue hook
   (leased TransferQueue rows return to ready; partial rollouts re-enter
   the source column and re-prefill deterministically),
3. **respawns** a replacement through the caller's spawn hook, counting
   against a bounded restart budget; exhausting the budget invokes the
   ``on_exhausted`` hook so the run still fails loudly instead of
   flapping forever.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.obs import get_registry
from repro_torch.core.supervision.errors import SupervisionExhausted

__all__ = ["ReplicaHandle", "ReplicaSupervisor"]

LIVE, DEAD, RETIRED = "live", "dead", "retired"


@dataclass
class ReplicaHandle:
    """Registry entry for one replica worker."""
    rid: int
    thread: Optional[threading.Thread]
    stage: str = "generate"
    state: str = LIVE
    reason: str = ""
    recovered: bool = False           # collected by a monitor pass already
    last_beat: float = field(default_factory=time.monotonic)
    current_lease: Optional[int] = None
    fence: threading.Event = field(default_factory=threading.Event)

    def beat(self) -> None:
        self.last_beat = time.monotonic()

    @property
    def fenced(self) -> bool:
        return self.fence.is_set()


class ReplicaSupervisor:
    """Parameters
    ----------
    respawn: ``respawn(dead) -> bool`` — spawn (and register) a
        replacement replica; False means respawn was refused (e.g. the
        run is stopping) and is not counted against the budget.
    requeue: ``requeue(dead) -> int`` — return the dead replica's
        in-flight rows to the ready queue; returns the row count.
    heartbeat_timeout_s: a live replica whose last heartbeat is older
        than this is declared dead (hung) by :meth:`poll`; <= 0 disables
        the staleness check (thread-death detection still applies).
    max_restarts: total respawn budget for the fleet (0 = unlimited).
    on_exhausted: called once with a :class:`SupervisionExhausted` when
        the budget is spent and another replica dies.
    """

    def __init__(self, respawn: Callable[[ReplicaHandle], bool], *,
                 requeue: Optional[Callable[[ReplicaHandle], int]] = None,
                 heartbeat_timeout_s: float = 10.0,
                 max_restarts: int = 8,
                 on_exhausted: Optional[Callable] = None,
                 stage: str = "generate", metrics=None):
        self._respawn = respawn
        self._requeue = requeue
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_restarts = max_restarts
        self._on_exhausted = on_exhausted
        self.stage = stage
        self._lock = threading.Lock()
        self._registry: Dict[int, ReplicaHandle] = {}
        self.restarts = 0
        self.deaths = 0
        m = metrics if metrics is not None else get_registry()
        self._m_restarts = m.counter(
            "replica_restarts_total",
            "crashed replicas respawned by the supervisor")
        self._m_fleet = m.gauge(
            "replica_fleet_size", "live replicas in the service registry")

    # -- service registry -------------------------------------------------

    def register(self, rid: int, thread: Optional[threading.Thread],
                 stage: Optional[str] = None) -> ReplicaHandle:
        h = ReplicaHandle(rid=rid, thread=thread,
                          stage=stage or self.stage)
        with self._lock:
            self._registry[rid] = h
            self._update_fleet_gauge()
        return h

    def replicas(self, state: Optional[str] = LIVE) -> List[ReplicaHandle]:
        with self._lock:
            return [h for h in self._registry.values()
                    if state is None or h.state == state]

    def get(self, rid: int) -> Optional[ReplicaHandle]:
        with self._lock:
            return self._registry.get(rid)

    def _update_fleet_gauge(self) -> None:
        live = sum(1 for h in self._registry.values() if h.state == LIVE)
        self._m_fleet.set(live, stage=self.stage)

    # -- replica-side lifecycle -------------------------------------------

    def heartbeat(self, rid: int) -> None:
        h = self.get(rid)
        if h is not None:
            h.beat()

    def report_death(self, rid: int, reason: str = "") -> None:
        """A replica announces its own crash (its lease was already
        requeued by the crashing worker)."""
        with self._lock:
            h = self._registry.get(rid)
            if h is not None and h.state == LIVE:
                h.state = DEAD
                h.reason = reason
                h.fence.set()
                self.deaths += 1
                self._update_fleet_gauge()

    def retire(self, rid: int) -> None:
        """Clean exit (drained queue, elastic shrink) — not a crash."""
        with self._lock:
            h = self._registry.get(rid)
            if h is not None and h.state == LIVE:
                h.state = RETIRED
                self._update_fleet_gauge()

    # -- monitor -----------------------------------------------------------

    def _find_dead(self) -> List[ReplicaHandle]:
        now = time.monotonic()
        dead = []
        with self._lock:
            for h in self._registry.values():
                if h.recovered:
                    continue
                if h.state == DEAD:
                    h.recovered = True
                    dead.append(h)
                elif h.state == LIVE:
                    hung = self.heartbeat_timeout_s > 0 and \
                        now - h.last_beat > self.heartbeat_timeout_s
                    exited = h.thread is not None and h.thread.ident \
                        is not None and not h.thread.is_alive()
                    if hung or exited:
                        h.state = DEAD
                        h.reason = "heartbeat timeout" if hung \
                            else "thread exited unexpectedly"
                        h.fence.set()
                        h.recovered = True
                        self.deaths += 1
                        dead.append(h)
            if dead:
                self._update_fleet_gauge()
        return dead

    def poll(self) -> int:
        """One monitor pass: recover every dead replica. Returns the
        number of replicas respawned."""
        respawned = 0
        for h in self._find_dead():
            if self._requeue is not None:
                self._requeue(h)
            if self.max_restarts > 0 and self.restarts >= self.max_restarts:
                h.reason = f"not respawned (budget): {h.reason}"
                if self._on_exhausted is not None:
                    self._on_exhausted(SupervisionExhausted(
                        f"replica restart budget ({self.max_restarts}) "
                        f"exhausted; replica {h.rid} died: {h.reason}"))
                continue
            if self._respawn(h):
                with self._lock:
                    self.restarts += 1
                h.reason = f"respawned: {h.reason}"
                self._m_restarts.inc(stage=h.stage)
                respawned += 1
            else:
                h.reason = f"respawn refused: {h.reason}"
        return respawned

    def monitor(self, stop: threading.Event, interval_s: float = 0.05
                ) -> None:
        """Monitor loop body for a daemon thread; drains one final poll
        after stop so late deaths are still recorded."""
        while not stop.wait(interval_s):
            self.poll()
