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
tensors to host memory and a receiver's swap copies the snapshot to its
device as new tensors, so receivers never alias the trainer's tensors
after their first swap. Before it, a receiver holds the trainer's initial
tensors, which the optimizer never writes into (it makes new parameter
tensors each step, ``training/optimizer.py``); for the same reason an
asynchronous publish may read the old tensors while the trainer steps on.

A tree whose leaves are all CUDA tensors on one device crosses the link
through a sender's staging arenas (``_StagingPool``: at most two flat
pinned host buffers, each a whole tree, made on the first publish) on
CUDA streams of the sender's and each receiver's own, so a copy runs at
the link's rate and the default stream's kernels run on beside it; a
receiver using the default ``to_device`` swaps from the arena the same
way. A publish never writes an arena that the channel's latest snapshot
points to or that a swap still reads: a receiver leases the snapshot's
arena under the channel's lock as it reads it, and releases it once its
copy has completed. Any other tree (a CPU tree, one split over devices),
and a receiver given its own ``to_device``, takes pageable copies
(``.detach().to("cpu", copy=True)``, then ``to_device``).

Each tree copy counts its bytes (``weight_copy_bytes_total``) and seconds
(``weight_copy_seconds``) by role, and a copy through an arena
``weight_copy_pinned_total``; ``weight_staging_wait_seconds_total`` counts
a publish's wait for a free arena and the gauge ``weight_staging_bytes``
the arenas' host bytes. While tracing is on (``core/obs/tracing.py``) a
publish is a ``weights.publish`` span (``wait`` on the arena path, ``copy``,
``offer``) on its thread under the caller's span, a swap a
``weights.swap`` span (``copy``).
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.obs import get_registry
from repro_torch.core.obs.tracing import current, span
from repro_torch.core.supervision.errors import WeightSyncTimeout
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class VersionedWeights:
    version: int
    host_params: Any  # tree of CPU tensors (host memory staging buffer)
    arena: Optional["_Arena"] = None   # the staging arena they view, if any


def _lease(vw: Optional[VersionedWeights]) -> None:
    """Lease ``vw``'s arena (caller holds the channel's lock)."""
    if vw is not None and vw.arena is not None:
        vw.arena.leases += 1


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
        nbytes = _tree_bytes(vw.host_params)
        self._m_bytes.inc(nbytes)
        if self.bandwidth_gbps > 0:
            time.sleep(nbytes / (self.bandwidth_gbps * 1e9 / 8))
            self.bytes_sent += nbytes
        with self._cv:
            if self._latest is None or vw.version > self._latest.version:
                self._latest = vw
            self._cv.notify_all()

    def peek(self, lease: bool = False) -> Optional[VersionedWeights]:
        """The latest snapshot; with ``lease=True`` its arena is leased in
        the same step, until :meth:`release`."""
        with self._lock:
            if lease:
                _lease(self._latest)
            return self._latest

    def release(self, vw: Optional[VersionedWeights]) -> None:
        """End a lease taken by ``peek`` or ``wait_for`` (no-op for a
        snapshot outside an arena, or None)."""
        if vw is None or vw.arena is None:
            return
        with self._cv:
            vw.arena.leases -= 1
            self._cv.notify_all()

    def latest_version(self) -> int:
        with self._lock:
            return self._latest.version if self._latest is not None else -1

    def wait_for(self, version: int, timeout: Optional[float] = None,
                 strict: bool = False,
                 lease: bool = False) -> Optional[VersionedWeights]:
        """Block until a snapshot with ``>= version`` is staged (with
        ``lease=True`` its arena leased as it is read, as ``peek``). On
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
            if lease:
                _lease(self._latest)
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


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors."""
    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


_ALIGN = 256       # bytes: every leaf's view in an arena starts on a multiple


def _card_of(leaves):
    """The CUDA device holding every one of ``leaves``; None where some
    leaf is not a CUDA tensor or the leaves span devices (such a tree
    takes pageable copies)."""
    devs = {getattr(t, "device", None) for t in leaves}
    dev = devs.pop() if len(devs) == 1 else None
    return dev if dev is not None and dev.type == "cuda" else None


def _after_copy(stream, after, copy: Callable[[], Any]):
    """``copy()`` issued on ``stream`` once the event ``after`` has
    passed; returns its result when the stream has done it, waiting on the
    host, so no other stream ever waits for the copy."""
    import torch
    with torch.cuda.stream(stream):
        stream.wait_event(after)
        out = copy()
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def _layout(leaves) -> tuple:
    """What an arena's views are laid out by: each leaf's shape and dtype."""
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


def _pinned(nbytes: int):
    import torch
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class _Arena:
    """One flat host buffer holding a whole tree, its leaves as views
    starting on ``_ALIGN``-byte offsets (one buffer a tree, so the caching
    host allocator rounds one size up, not each leaf's). ``leases``
    counts its users now: the publish filling it and each swap reading
    it; it changes under the channel's lock."""

    def __init__(self):
        self.key = None                  # the leaves' (shape, dtype)s
        self.views: list = []
        self.leases = 0
        self._held = None                # gives back the gauge's bytes

    def fit(self, key, alloc: Callable[[int], Any], gauge) -> None:
        offsets, size = [], 0
        for shape, dtype in key:
            offsets.append(size)
            size += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
        self.views = []                  # the old buffer goes first
        if self._held is not None:
            self._held()
        buf = alloc(size)
        self._held = weakref.finalize(self, gauge.dec, size)
        gauge.inc(size)
        self.views = [
            buf[o:o + math.prod(shape) * dtype.itemsize]
            .view(dtype).view(shape) for o, (shape, dtype) in
            zip(offsets, key)]
        self.key = key


class _StagingPool:
    """A sender's staging arenas, at most ``MAX_ARENAS``, each made on
    first need by ``alloc`` (pinned host memory; the tests pass plain CPU
    memory). The invariant: a publish never writes an arena that the
    channel's latest snapshot points to or that a swap still reads.
    Leases and the latest snapshot change under the channel's lock, so
    the pool waits on the channel's condition. Two arenas let a publish
    fill one while the latest snapshot sits in the other."""

    MAX_ARENAS = 2

    def __init__(self, channel: WeightChannel, metrics=None,
                 alloc: Callable[[int], Any] = _pinned):
        self._channel = channel
        self._alloc = alloc
        self.arenas: List[_Arena] = []
        m = metrics if metrics is not None else get_registry()
        self._waited = m.counter(
            "weight_staging_wait_seconds_total",
            "seconds publishes waited for a free staging arena")
        self._bytes = m.gauge(
            "weight_staging_bytes",
            "host bytes held by weight staging arenas")

    def _pick(self, key) -> Optional[_Arena]:
        """A free arena, laid out for ``key`` if one is; a new one while
        there are fewer than ``MAX_ARENAS``. Caller holds the lock."""
        latest = self._channel._latest
        held = latest.arena if latest is not None else None
        free = [a for a in self.arenas if not a.leases and a is not held]
        for a in free:
            if a.key == key:
                return a
        if len(self.arenas) < self.MAX_ARENAS:
            self.arenas.append(_Arena())
            return self.arenas[-1]
        return free[0] if free else None

    def acquire(self, leaves) -> _Arena:
        """A free arena laid out for ``leaves``, leased to the caller;
        waits while every arena is the latest snapshot's or leased. A new
        arena is allocated outside the lock: pinning takes seconds."""
        key = _layout(leaves)
        t0 = None
        with self._channel._cv:
            while (arena := self._pick(key)) is None:
                t0 = t0 or time.perf_counter()
                self._channel._cv.wait()
            arena.leases += 1
        if t0 is not None:
            self._waited.inc(time.perf_counter() - t0)
        if arena.key != key:
            try:
                arena.fit(key, self._alloc, self._bytes)
            except BaseException:
                self.release(arena)
                raise
        return arena

    def release(self, arena: Optional[_Arena]) -> None:
        if arena is not None:
            with self._channel._cv:
                arena.leases -= 1
                self._channel._cv.notify_all()

    def fill(self, leaves) -> None:
        """Make the arenas up to ``MAX_ARENAS`` now (after the first
        publish's offer, on its thread), so no later publish pays for
        pinning one."""
        key = _layout(leaves)
        while True:
            with self._channel._cv:
                if len(self.arenas) >= self.MAX_ARENAS:
                    return
                arena = _Arena()
                arena.leases = 1
                self.arenas.append(arena)
            try:
                arena.fit(key, self._alloc, self._bytes)
            finally:
                self.release(arena)


class _CopyMeter:
    """``weight_copy_bytes_total`` and ``weight_copy_seconds`` of one role
    (publish: device to host; swap: host to device), and
    ``weight_copy_pinned_total``, the copies through a staging arena. The
    seconds cover the copy alone and end when its data has moved: a
    pageable copy returns only then, and an arena's copy waits on the
    host for its stream's event."""

    def __init__(self, m, role: str):
        self._bytes = m.counter(
            "weight_copy_bytes_total",
            "bytes of weight trees copied between host and device").labels(
                role=role)
        self._seconds = m.histogram(
            "weight_copy_seconds",
            "one weight tree copy between host and device").labels(
                role=role)
        self._pinned = m.counter(
            "weight_copy_pinned_total",
            "weight tree copies through a pinned staging arena").labels(
                role=role)

    def run(self, copy: Callable[[], Any], pinned: bool = False):
        t0 = time.perf_counter()
        out = copy()
        self._seconds.observe(time.perf_counter() - t0)
        self._bytes.inc(_tree_bytes(out))
        if pinned:
            self._pinned.inc()
        return out


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
        self._copy = _CopyMeter(m, "publish")
        self.pool = _StagingPool(channel, m)
        self._stream = None

    def publish(self, params, version: int) -> None:
        caller = current()           # the publish span's parent
        leaves = tree_leaves(params)
        card = _card_of(leaves)
        ready = None
        if card is not None:         # the caller's work that made params
            import torch
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(card))

        def _send():
            t0 = time.monotonic()
            with span("weights.publish", parent=caller):
                if card is None:
                    with span("copy"):
                        host = self._copy.run(lambda: tree_map(
                            lambda a: a.detach().to("cpu", copy=True),
                            params))
                    vw = VersionedWeights(version, host)
                else:
                    vw = self._stage(params, leaves, card, ready, version)
                try:
                    with span("offer"):
                        self.channel.offer(vw)
                finally:
                    self.pool.release(vw.arena)
            self._h_sync.observe(time.monotonic() - t0, role="publish")
            if card is not None:
                self.pool.fill(leaves)

        if self.mode == "sync":
            _send()
        else:
            if self._pending is not None:
                self._pending.join()
            self._pending = threading.Thread(target=_send, daemon=True)
            self._pending.start()

    def _stage(self, params, leaves, card, ready,
               version: int) -> VersionedWeights:
        """``leaves`` copied into a free arena on the sender's copy
        stream once ``ready`` has passed; returns the snapshot, its arena
        still leased to this publish, once the copy is done. Until then
        ``leaves`` keeps the trainer's tensors alive."""
        with span("wait"):
            arena = self.pool.acquire(leaves)
        try:
            if self._stream is None:
                import torch
                self._stream = torch.cuda.Stream(device=card)

            def copy():
                for dst, src in zip(arena.views, leaves):
                    dst.copy_(src.detach(), non_blocking=True)
                return tree_unflatten(params, arena.views)

            with span("copy"):
                host = self._copy.run(
                    lambda: _after_copy(self._stream, ready, copy),
                    pinned=True)
        except BaseException:
            self.pool.release(arena)
            raise
        return VersionedWeights(version, host, arena)

    def flush(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None


class WeightReceiver:
    """Inference-cluster side. Keeps the live device params plus the staged
    host buffer; ``maybe_swap()`` is called at generation-iteration
    boundaries and pays only H2D (delayed parameter update, §4.2.2).

    The default ``to_device`` copies a snapshot to the device the initial
    params live on (the rollout engine's); from a staging arena to a CUDA
    device it does so on the receiver's own copy stream, into new tensors
    allocated on the stream current at the swap, which uses them, and
    ``params`` is None while that copy runs."""

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
        self._card = device if to_device is None \
            and device.type == "cuda" else None
        self._stream = None
        # broadcast channels track per-replica swap acknowledgment
        if replica_id is not None and hasattr(channel, "subscribe"):
            channel.subscribe(replica_id, version)
        m = metrics if metrics is not None else get_registry()
        self._h_sync = m.histogram(
            "weight_sync_seconds",
            "weight publish (D2H + channel) / swap (H2D) durations")
        self._copy = _CopyMeter(m, "swap")

    def staged_version(self) -> int:
        vw = self.channel.peek()
        return vw.version if vw else self.version

    def _load(self, vw: VersionedWeights):
        """``vw`` on this receiver's device, as new tensors."""
        import torch
        if vw.arena is None:
            return self._to_device(vw.host_params)
        if self._card is None:
            # later publishes rewrite the arena: ``to_device`` gets a
            # copy it may keep (a CPU ``.to`` returns its input)
            return self._to_device(tree_map(torch.clone, vw.host_params))
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self._card)
        # allocated on the stream that will use them, so their memory
        # comes from and goes back to that stream's pool; it is free once
        # the work queued there before is done
        host = tree_leaves(vw.host_params)
        out = [torch.empty_like(h, device=self._card) for h in host]
        free = torch.cuda.Event()
        free.record(torch.cuda.current_stream(self._card))
        _after_copy(self._stream, free, lambda: [
            o.copy_(h, non_blocking=True) for o, h in zip(out, host)])
        return tree_unflatten(vw.host_params, out)

    def _swap(self, vw: VersionedWeights) -> None:
        t0 = time.monotonic()
        pinned = vw.arena is not None and self._card is not None
        with span("weights.swap"):
            with span("copy"):
                if pinned:
                    # the old tree's memory goes to the new one (the copy
                    # waits for the work queued on it), so a swap adds no
                    # second tree to the card's peak
                    self.params = None
                self.params = self._copy.run(lambda: self._load(vw),
                                             pinned=pinned)
        self.version = vw.version
        self._h_sync.observe(time.monotonic() - t0, role="swap")
        if self.replica_id is not None and hasattr(self.channel, "ack"):
            self.channel.ack(self.replica_id, vw.version)

    def maybe_swap(self) -> bool:
        """Swap in the newest staged weights if any. Returns True if swapped.
        The snapshot's arena stays leased until the swap's copy is done."""
        vw = self.channel.peek(lease=True)
        try:
            if vw is not None and vw.version > self.version:
                self._swap(vw)
                return True
            return False
        finally:
            self.channel.release(vw)

    def wait_and_swap(self, version: int, timeout: Optional[float] = None,
                      strict: bool = True) -> bool:
        """Block until ``>= version`` is staged, then swap. On timeout
        raises :class:`WeightSyncTimeout` (naming the version waited for
        and the newest one seen); ``strict=False`` restores the legacy
        return-False behavior for callers that poll."""
        vw = self.channel.wait_for(version, timeout, strict=strict,
                                   lease=True)
        if vw is None:
            return False
        try:
            self._swap(vw)
        finally:
            self.channel.release(vw)
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
