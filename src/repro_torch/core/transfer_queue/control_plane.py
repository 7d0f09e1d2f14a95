"""TransferQueue control plane — per-task controllers (paper §3.3).

Each RL task (actor_rollout, ref_inference, actor_update, ...) gets a
dedicated controller holding ONLY metadata: a binary data-status matrix
(row x required-column) plus consumption records. Controllers operate
independently — RL tasks never interfere algorithmically.

``request()`` implements Fig. 6: scan for rows whose required columns are
all ready and that no DP group has consumed, pack a micro-batch under a
load-balancing policy, mark consumed atomically, and hand the *metadata*
(indices) back; the consumer then reads the real data from the data plane.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.obs import MetricsRegistry, get_registry


@dataclass
class BatchMeta:
    """Metadata handed to a DP group: which rows to fetch from where.
    ``lease_id`` is set when the rows were handed out under a lease —
    the consumer must :meth:`TransferQueueController.ack` it after
    processing, or the supervisor requeues the rows on its death."""
    indices: List[int]
    columns: List[str]
    consumer: str = ""
    issued_at: float = field(default_factory=time.monotonic)
    lease_id: Optional[int] = None


class TransferQueueController:
    """Metadata + scheduling for one RL task (paper Fig. 6).

    Parameters
    ----------
    task: consumer-stage name (e.g. "actor_rollout").
    columns: data components this task needs ready before it can consume.
    capacity: number of rows tracked (global batch x group size, or more
        for async multi-step buffering).
    policy: "fifo" | "token_balance" — token_balance equalizes total token
        counts handed to each DP group (paper §3.3 proactive load balance);
        it needs a ``token_len`` hint column.
    """

    def __init__(self, task: str, columns: Sequence[str], capacity: int,
                 policy: str = "fifo",
                 metrics: Optional[MetricsRegistry] = None):
        self.task = task
        self.columns = list(columns)
        self.capacity = capacity
        self.policy = policy
        self._col_pos = {c: i for i, c in enumerate(self.columns)}
        self._ready = [[False] * len(self.columns) for _ in range(capacity)]
        self._consumed = [False] * capacity
        # incremental bookkeeping: O(1) notify, O(avail) schedule — the
        # §3.5 high-concurrency design (no O(capacity) metadata scans)
        self._n_ready_cols = [0] * capacity
        self._avail: Dict[int, None] = {}   # insertion-ordered set
        self._token_len: Dict[int, int] = {}
        self._tokens_served: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        # lease table (fault tolerance): rows handed out under a lease
        # stay consumed until acked; a dead consumer's leases requeue
        self._lease_seq = itertools.count(1)
        self._leases: Dict[int, dict] = {}
        # instrumentation
        self.n_requests = 0
        self.total_wait_s = 0.0
        m = metrics if metrics is not None else get_registry()
        self.metrics = m
        # pre-bound series (labels sorted once) — cheap enough to update
        # inside the scheduling lock
        self._m_rows_consumed = m.counter(
            "tq_rows_consumed_total", "rows handed to consumers per task"
        ).labels(task=task)
        self._m_depth = m.gauge(
            "tq_ready_depth",
            "rows currently ready and unconsumed (queue depth)").labels(
            task=task)
        # labelled per decision with the policy *actually used* (a
        # token_balance controller packs fifo until token hints arrive)
        self._m_sched = m.counter(
            "tq_sched_decisions_total",
            "micro-batches packed per task/policy")
        self._m_wait = m.counter(
            "tq_blocked_wait_seconds_total",
            "seconds consumers spent blocked on this task")
        self._m_requeued = m.counter(
            "rows_requeued_total",
            "leased rows returned to ready after a consumer death"
        ).labels(task=task)

    # -- metadata notification (called by storage units) ---------------------

    def _mark(self, idx: int, pos: int) -> None:
        if not self._ready[idx][pos]:
            self._ready[idx][pos] = True
            self._n_ready_cols[idx] += 1
            if self._n_ready_cols[idx] == len(self.columns) \
                    and not self._consumed[idx]:
                self._avail[idx] = None
                self._m_depth.set(len(self._avail))

    def notify(self, idx: int, column: str) -> None:
        pos = self._col_pos.get(column)
        if pos is None or idx >= self.capacity:
            return
        with self._cv:
            self._mark(idx, pos)
            self._cv.notify_all()

    def notify_many(self, idxs: Sequence[int], column: str) -> None:
        pos = self._col_pos.get(column)
        if pos is None:
            return
        with self._cv:
            for i in idxs:
                if i < self.capacity:
                    self._mark(i, pos)
            self._cv.notify_all()

    def set_token_len(self, idx: int, n: int) -> None:
        with self._lock:
            self._token_len[idx] = n

    # -- scheduling (Fig. 6) --------------------------------------------------

    def _available(self) -> List[int]:
        return list(self._avail)

    def request(self, batch_size: int, consumer: str = "dp0",
                timeout: Optional[float] = None,
                allow_partial: bool = False,
                lease: bool = False) -> Optional[BatchMeta]:
        """Block until ``batch_size`` rows are ready, then consume them.

        Returns None if the queue is closed (or timed out) with nothing
        available; a partial batch if closed/``allow_partial`` with fewer.
        With ``lease=True`` the rows are tracked under a lease id until
        :meth:`ack` — if the consumer dies first, :meth:`requeue_lease`
        returns them to ready (at the front, preserving FIFO order).
        """
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        with self._cv:
            self.n_requests += 1
            while True:
                n_avail = len(self._avail)
                if n_avail >= batch_size or \
                        (n_avail and (self._closed or allow_partial)):
                    break
                if self._closed and not n_avail:
                    self._account_wait(time.monotonic() - t0, consumer)
                    return None
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if remaining == 0.0:
                    if n_avail and allow_partial:
                        break
                    self._account_wait(time.monotonic() - t0, consumer)
                    return None
                self._cv.wait(timeout=remaining if remaining is not None
                              else 0.1)
            # §3.5 instrumentation: only the blocked interval counts as
            # wait — scheduling/packing below is controller work time
            self._account_wait(time.monotonic() - t0, consumer)
            use_tb = self.policy == "token_balance" and bool(self._token_len)
            if use_tb:
                chosen = self._schedule(self._available(), batch_size,
                                        consumer)
            else:
                chosen = list(itertools.islice(self._avail, batch_size))
            for i in chosen:
                self._consumed[i] = True
                self._avail.pop(i, None)
            self._m_sched.inc(task=self.task,
                              policy="token_balance" if use_tb else "fifo")
            self._m_rows_consumed.inc(len(chosen))
            self._m_depth.set(len(self._avail))
            lease_id = None
            if lease:
                lease_id = next(self._lease_seq)
                self._leases[lease_id] = {"rows": list(chosen),
                                          "consumer": consumer}
            return BatchMeta(chosen, list(self.columns), consumer,
                             lease_id=lease_id)

    def _account_wait(self, blocked_s: float, consumer: str) -> None:
        self.total_wait_s += blocked_s
        if blocked_s > 0:
            self._m_wait.inc(blocked_s, task=self.task, consumer=consumer)

    def _schedule(self, avail: List[int], n: int, consumer: str) -> List[int]:
        n = min(n, len(avail))
        if self.policy == "token_balance" and self._token_len:
            # equalize processed tokens per DP group (paper §3.3): greedy
            # long/short alternation keeps each request's token total close
            # to n x (mean row length), so stragglers don't accumulate
            ranked = sorted(avail, key=lambda i: self._token_len.get(i, 0))
            mean_len = (sum(self._token_len.get(i, 0) for i in avail)
                        / max(1, len(avail)))
            lo, hi = 0, len(ranked) - 1
            chosen, total = [], 0.0
            for k in range(n):
                if total <= mean_len * k:      # under pace -> take longest
                    chosen.append(ranked[hi])
                    hi -= 1
                else:                           # over pace -> take shortest
                    chosen.append(ranked[lo])
                    lo += 1
                total += self._token_len.get(chosen[-1], 0)
            self._tokens_served[consumer] = \
                self._tokens_served.get(consumer, 0) + total
            return chosen
        return avail[:n]  # fifo

    # -- leases (fault tolerance) ---------------------------------------------

    def ack(self, lease_id: Optional[int]) -> None:
        """Finalize a lease: the rows were fully processed."""
        if lease_id is None:
            return
        with self._lock:
            self._leases.pop(lease_id, None)

    def requeue_lease(self, lease_id: Optional[int]) -> int:
        """Return a dead consumer's leased rows to ready. Idempotent —
        an already-acked or already-requeued lease is a no-op. Restored
        rows go to the FRONT of the ready set in their original order,
        so recovery preserves the FIFO schedule (uid/index assignment
        downstream stays deterministic under a fixed seed)."""
        if lease_id is None:
            return 0
        with self._cv:
            rec = self._leases.pop(lease_id, None)
            if rec is None:
                return 0
            rows = [i for i in rec["rows"] if self._consumed[i]]
            front: Dict[int, None] = {}
            for i in rows:
                self._consumed[i] = False
                if self._n_ready_cols[i] == len(self.columns):
                    front[i] = None
            for i in self._avail:
                front.setdefault(i, None)
            self._avail = front
            self._m_requeued.inc(len(rows))
            self._m_depth.set(len(self._avail))
            self._cv.notify_all()
            return len(rows)

    def requeue_consumer(self, consumer: str) -> int:
        """Requeue every outstanding lease held by ``consumer``.

        Leases are requeued newest-first: each ``requeue_lease`` places
        its rows at the very front, so finishing with the *oldest* lease
        leaves the ready set in original issue order — a consumer that
        held several leases (the checkpointing trainer acks only at
        snapshot boundaries) re-fetches its rows in exactly the order it
        first consumed them."""
        with self._lock:
            ids = sorted((lid for lid, rec in self._leases.items()
                          if rec["consumer"] == consumer), reverse=True)
        return sum(self.requeue_lease(lid) for lid in ids)

    def state_snapshot(self) -> dict:
        """Durable-cursor view for run snapshots: consumed/ready
        watermarks plus the in-flight leases (rows + holder)."""
        with self._lock:
            return {
                "consumed": int(sum(self._consumed)),
                "ready": len(self._avail),
                "closed": bool(self._closed),
                "leases": {int(lid): {"rows": list(rec["rows"]),
                                      "consumer": rec["consumer"]}
                           for lid, rec in self._leases.items()},
            }

    def outstanding_leases(self, consumer: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for rec in self._leases.values()
                       if consumer is None or rec["consumer"] == consumer)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reset(self, capacity: Optional[int] = None) -> None:
        with self._cv:
            if capacity is not None:
                self.capacity = capacity
            self._ready = [[False] * len(self.columns)
                           for _ in range(self.capacity)]
            self._consumed = [False] * self.capacity
            self._n_ready_cols = [0] * self.capacity
            self._avail.clear()
            self._token_len.clear()
            self._tokens_served.clear()
            self._leases.clear()
            self._closed = False
            self._cv.notify_all()

    # -- introspection ----------------------------------------------------------

    def num_ready(self) -> int:
        with self._lock:
            return len(self._available())

    def num_consumed(self) -> int:
        with self._lock:
            return sum(self._consumed)
