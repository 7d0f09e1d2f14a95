"""TransferQueue facade — the streaming data scheduler bridging the
training and inference clusters (paper §3.1, Fig. 3).

Wires the data plane (N storage units) to one controller per RL task and
exposes put/get plus the streaming-dataloader factory. All interaction is
thread-safe and fully streamed: consumers receive micro-batches as soon as
their required columns are ready, never waiting for the whole global batch
— this is what enables automatic pipeline overlap across RL tasks (§4.1).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core.transfer_queue.control_plane import (BatchMeta,
                                                           TransferQueueController)
from repro_torch.core.transfer_queue.data_plane import DataPlane


class TransferQueue:
    def __init__(self, capacity: int, tasks: Dict[str, Sequence[str]],
                 num_storage_units: int = 2,
                 policy: Union[str, Dict[str, str]] = "fifo",
                 metrics=None, uid_start: int = 0):
        """tasks: {task_name: required columns}. ``policy`` is one name
        for every controller, or {task: name} overriding per consumer
        stage (missing tasks use the ``"default"`` entry, else fifo) —
        token balancing applies to *any* stage, not just the trainer.
        ``metrics`` is an optional
        :class:`repro_torch.core.obs.MetricsRegistry` shared by every
        controller (defaults to the process-global registry).
        ``uid_start`` offsets the global row-uid counter — a cold-resumed
        run continues the uid space past its snapshot watermark so
        restored acked uids can never collide with fresh rows."""
        self.capacity = capacity
        self.data_plane = DataPlane(num_storage_units)
        self.controllers: Dict[str, TransferQueueController] = {}
        for task, cols in tasks.items():
            if isinstance(policy, dict):
                task_policy = policy.get(task, policy.get("default", "fifo"))
            else:
                task_policy = policy
            c = TransferQueueController(task, cols, capacity,
                                        policy=task_policy, metrics=metrics)
            self.controllers[task] = c
            self.data_plane.register_controller(c)
        self._next_uid = int(uid_start)
        self._idx_lock = threading.Lock()

    # -- producers -----------------------------------------------------------

    def next_indices(self, n: int) -> List[int]:
        """Reserve n fresh global row indices."""
        with self._idx_lock:
            start = self._next_uid
            self._next_uid = start + n
            return list(range(start, start + n))

    @property
    def next_uid(self) -> int:
        """The uid the next produced row will take (durable-cursor peek)."""
        with self._idx_lock:
            return self._next_uid

    def put(self, idx: int, column: str, value: Any,
            token_len: Optional[int] = None) -> None:
        if token_len is not None:
            for c in self.controllers.values():
                c.set_token_len(idx, token_len)
        self.data_plane.put(idx, column, value)

    def put_batch(self, idxs: Sequence[int], column: str,
                  values: Sequence[Any],
                  token_lens: Optional[Sequence[int]] = None) -> None:
        if token_lens is not None:
            for c in self.controllers.values():
                for i, n in zip(idxs, token_lens):
                    c.set_token_len(i, n)
        self.data_plane.put_batch(idxs, column, values)

    # -- consumers -----------------------------------------------------------

    def get(self, task: str, batch_size: int, consumer: str = "dp0",
            timeout: Optional[float] = None, allow_partial: bool = False,
            lease: bool = False) -> Optional[Dict[str, Any]]:
        """Blocking read of a micro-batch for ``task``.

        Returns {"indices": [...], <column>: [...]} or None when closed.
        With ``lease=True`` the batch carries a ``"lease"`` id the
        consumer must :meth:`ack` once processed; an unacked lease can be
        requeued if the consumer dies (fault tolerance)."""
        ctrl = self.controllers[task]
        meta = ctrl.request(batch_size, consumer, timeout=timeout,
                            allow_partial=allow_partial, lease=lease)
        if meta is None or not meta.indices:
            return None
        data = self.data_plane.get(meta.indices, meta.columns)
        data["indices"] = meta.indices
        if lease:
            data["lease"] = meta.lease_id
        return data

    def ack(self, task: str, lease_id: Optional[int]) -> None:
        self.controllers[task].ack(lease_id)

    def requeue(self, task: str, lease_id: Optional[int]) -> int:
        """Return one unacked lease's rows to ready (idempotent)."""
        return self.controllers[task].requeue_lease(lease_id)

    def requeue_consumer(self, task: str, consumer: str) -> int:
        """Return every unacked lease of a dead consumer to ready."""
        return self.controllers[task].requeue_consumer(consumer)

    def cursor(self) -> Dict[str, Any]:
        """Durable snapshot cursor: the global uid watermark plus every
        controller's consumed/ready counts and in-flight leases — what a
        :class:`repro_torch.core.recovery.RunCheckpointer` persists so a
        resumed run knows where the stream stood."""
        return {"next_uid": self.next_uid,
                "tasks": {t: c.state_snapshot()
                          for t, c in self.controllers.items()}}

    def dataloader(self, task: str, batch_size: int, consumer: str = "dp0",
                   allow_partial: bool = True) -> "StreamingDataLoader":
        return StreamingDataLoader(self, task, batch_size, consumer,
                                   allow_partial)

    # -- lifecycle -------------------------------------------------------------

    def close_task(self, task: str) -> None:
        self.controllers[task].close()

    def close(self) -> None:
        for c in self.controllers.values():
            c.close()

    def reset(self, capacity: Optional[int] = None) -> None:
        if capacity is not None:
            self.capacity = capacity
        self.data_plane.clear()
        for c in self.controllers.values():
            c.reset(capacity)
        with self._idx_lock:
            self._next_uid = 0


class StreamingDataLoader:
    """PyTorch-DataLoader-style iterator over a TransferQueue task
    (paper §3.4, Code 1). Iterates until the queue is closed and drained.

    In a multi-rank DP group only the leader rank talks to the queue and
    broadcasts to peers (§3.5); ``consumer`` identifies the DP group.
    """

    def __init__(self, tq: TransferQueue, task: str, batch_size: int,
                 consumer: str, allow_partial: bool = True):
        self.tq = tq
        self.task = task
        self.batch_size = batch_size
        self.consumer = consumer
        self.allow_partial = allow_partial

    def __iter__(self):
        while True:
            batch = self.tq.get(self.task, self.batch_size, self.consumer,
                                allow_partial=self.allow_partial)
            if batch is None:
                return
            idxs = batch.pop("indices")
            yield batch, idxs
