"""Parameter-update module — WeightSender / WeightReceiver (paper §4.2.3)
and the delayed parameter update mechanism (§4.2.2).

Two modes, mirroring the paper:

* ``sync``  — rollout blocks while weights transfer (models the
  high-bandwidth HCCL/ICI device-to-device path).
* ``async`` — the training engine offloads weights to host buffers and a
  background thread ships them over the "host network" (here: an
  in-process channel with optional simulated bandwidth); rollout keeps
  generating on the old weights and swaps at the generation-iteration
  boundary, paying only the H2D load (delayed parameter update).

Sub-step asynchrony (§4.2.2 / Fig. 8d, the paper's future work): with
``staggered=True``, receivers for different rollout instances are updated
sequentially so part of each global batch is produced by the newest
weights — implemented here as a beyond-paper feature.

The weight path over torch tensors: ``publish`` copies the trainer's
tensors to host memory (``.detach().to("cpu", copy=True)``) and a
receiver's swap copies the snapshot to its device, so receivers never
alias the trainer's tensors after their first swap. Before it, a receiver holds the
trainer's initial tensors, which the optimizer never writes into (it makes
new parameter tensors each step, ``training/optimizer.py``); for the same
reason an asynchronous publish may read the old tensors while the trainer
steps on.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.obs import get_registry
from repro_torch.core.supervision.errors import WeightSyncTimeout
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class VersionedWeights:
    version: int
    host_params: Any  # tree of CPU tensors (host memory staging buffer)


class WeightChannel:
    """In-process stand-in for the host network between clusters.

    ``bandwidth_gbps`` > 0 adds a transfer delay proportional to payload
    size — used by the simulator-calibrated benchmarks.
    """

    def __init__(self, bandwidth_gbps: float = 0.0, metrics=None):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._latest: Optional[VersionedWeights] = None
        self.bandwidth_gbps = bandwidth_gbps
        self.bytes_sent = 0
        m = metrics if metrics is not None else get_registry()
        self._m_bytes = m.counter(
            "weight_bytes_published_total",
            "host-buffer bytes offered to the weight channel")

    def offer(self, vw: VersionedWeights) -> None:
        nbytes = sum(a.numel() * a.element_size()
                     for a in tree_leaves(vw.host_params))
        self._m_bytes.inc(nbytes)
        if self.bandwidth_gbps > 0:
            time.sleep(nbytes / (self.bandwidth_gbps * 1e9 / 8))
            self.bytes_sent += nbytes
        with self._cv:
            if self._latest is None or vw.version > self._latest.version:
                self._latest = vw
            self._cv.notify_all()

    def peek(self) -> Optional[VersionedWeights]:
        with self._lock:
            return self._latest

    def latest_version(self) -> int:
        with self._lock:
            return self._latest.version if self._latest is not None else -1

    def wait_for(self, version: int, timeout: Optional[float] = None,
                 strict: bool = False) -> Optional[VersionedWeights]:
        """Block until a snapshot with ``>= version`` is staged. On
        timeout: returns None, or with ``strict=True`` raises
        :class:`WeightSyncTimeout` naming the version waited for and the
        newest version actually seen — a timeout is never mistaken for a
        successful no-op."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._latest is None or self._latest.version < version:
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    if strict:
                        latest = self._latest.version \
                            if self._latest is not None else -1
                        raise WeightSyncTimeout(version, latest,
                                                timeout_s=timeout or 0.0)
                    return None
                self._cv.wait(timeout=rem if rem is not None else 0.1)
            return self._latest


class BroadcastWeightChannel(WeightChannel):
    """One-to-many weight broadcast with per-replica swap acknowledgment.

    The trainer publishes ONE versioned host snapshot per step; every
    subscribed replica reads the *same* staging buffer (the pytree is
    shared by reference — zero extra host copies per replica, and
    ``weight_bytes_published_total`` counts the payload once regardless
    of fleet size). Each receiver acks the version it swapped in, so the
    supervisor and the staleness gate can see exactly which replicas lag
    during recovery: a freshly respawned replica subscribes at its
    hand-off version and catches up on its first swap.
    """

    def __init__(self, bandwidth_gbps: float = 0.0, metrics=None):
        super().__init__(bandwidth_gbps, metrics=metrics)
        self._acked: Dict[int, int] = {}       # replica id -> acked version
        m = metrics if metrics is not None else get_registry()
        self._h_broadcast = m.histogram(
            "weight_broadcast_seconds",
            "one-to-many publish latency (one snapshot for N receivers)")

    # -- subscription registry --------------------------------------------

    def subscribe(self, replica_id: int, version: int = 0) -> None:
        with self._lock:
            self._acked[replica_id] = version

    def unsubscribe(self, replica_id: int) -> None:
        with self._lock:
            self._acked.pop(replica_id, None)

    def ack(self, replica_id: int, version: int) -> None:
        with self._lock:
            if replica_id in self._acked:
                self._acked[replica_id] = max(self._acked[replica_id],
                                              version)

    def acked_versions(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._acked)

    def min_acked(self) -> int:
        """Oldest version any live replica is still generating with —
        the fleet-wide staleness floor during recovery."""
        with self._lock:
            return min(self._acked.values()) if self._acked else -1

    def num_subscribers(self) -> int:
        with self._lock:
            return len(self._acked)

    def offer(self, vw: VersionedWeights) -> None:
        t0 = time.monotonic()
        super().offer(vw)
        self._h_broadcast.observe(time.monotonic() - t0)


class WeightSender:
    """Training-cluster side. ``publish`` is non-blocking in async mode:
    device→host offload + channel send happen on a background thread,
    overlapping with the next training step (§4.2.3)."""

    def __init__(self, channel: WeightChannel, mode: str = "async",
                 metrics=None):
        assert mode in ("sync", "async")
        self.channel = channel
        self.mode = mode
        self._pending: Optional[threading.Thread] = None
        m = metrics if metrics is not None else get_registry()
        self._h_sync = m.histogram(
            "weight_sync_seconds",
            "weight publish (D2H + channel) / swap (H2D) durations")

    def publish(self, params, version: int) -> None:
        def _send():
            t0 = time.monotonic()
            host = tree_map(lambda a: a.detach().to("cpu", copy=True),
                            params)
            self.channel.offer(VersionedWeights(version, host))
            self._h_sync.observe(time.monotonic() - t0, role="publish")

        if self.mode == "sync":
            _send()
        else:
            if self._pending is not None:
                self._pending.join()
            self._pending = threading.Thread(target=_send, daemon=True)
            self._pending.start()

    def flush(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None


class WeightReceiver:
    """Inference-cluster side. Keeps the live device params plus the staged
    host buffer; ``maybe_swap()`` is called at generation-iteration
    boundaries and pays only H2D (delayed parameter update, §4.2.2).

    The default ``to_device`` copies a snapshot to the device the initial
    params live on (the rollout engine's)."""

    def __init__(self, channel: WeightChannel, init_params, version: int = 0,
                 to_device: Optional[Callable] = None, metrics=None,
                 replica_id: Optional[int] = None):
        self.channel = channel
        self.params = init_params
        self.version = version
        self.replica_id = replica_id
        device = tree_leaves(init_params)[0].device
        self._to_device = to_device or (lambda tree: tree_map(
            lambda t: t.to(device), tree))
        # broadcast channels track per-replica swap acknowledgment
        if replica_id is not None and hasattr(channel, "subscribe"):
            channel.subscribe(replica_id, version)
        m = metrics if metrics is not None else get_registry()
        self._h_sync = m.histogram(
            "weight_sync_seconds",
            "weight publish (D2H + channel) / swap (H2D) durations")
        self._m_skipped = m.counter(
            "weight_versions_skipped_total",
            "published versions never loaded by a receiver (delayed "
            "parameter update jumping straight to the newest)")

    def staged_version(self) -> int:
        vw = self.channel.peek()
        return vw.version if vw else self.version

    def _swap(self, vw: VersionedWeights) -> None:
        t0 = time.monotonic()
        self.params = self._to_device(vw.host_params)
        skipped = vw.version - self.version - 1
        if skipped > 0:
            self._m_skipped.inc(skipped)
        self.version = vw.version
        self._h_sync.observe(time.monotonic() - t0, role="swap")
        if self.replica_id is not None and hasattr(self.channel, "ack"):
            self.channel.ack(self.replica_id, vw.version)

    def maybe_swap(self) -> bool:
        """Swap in the newest staged weights if any. Returns True if swapped."""
        vw = self.channel.peek()
        if vw is not None and vw.version > self.version:
            self._swap(vw)
            return True
        return False

    def wait_and_swap(self, version: int, timeout: Optional[float] = None,
                      strict: bool = True) -> bool:
        """Block until ``>= version`` is staged, then swap. On timeout
        raises :class:`WeightSyncTimeout` (naming the version waited for
        and the newest one seen); ``strict=False`` restores the legacy
        return-False behavior for callers that poll."""
        vw = self.channel.wait_for(version, timeout, strict=strict)
        if vw is None:
            return False
        self._swap(vw)
        return True


class StaggeredUpdateGroup:
    """Sub-step asynchrony (Fig. 8d): rollout instances update one at a
    time so the fleet keeps serving while each instance reloads."""

    def __init__(self, receivers: List[WeightReceiver]):
        self.receivers = receivers
        self._lock = threading.Lock()
        self._updating: Optional[int] = None

    def try_begin_update(self, idx: int) -> bool:
        with self._lock:
            if self._updating is None:
                self._updating = idx
                return True
            return False

    def end_update(self, idx: int) -> None:
        with self._lock:
            if self._updating == idx:
                self._updating = None
