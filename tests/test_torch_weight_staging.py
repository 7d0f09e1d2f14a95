"""The weight path's staging arenas (``core/workflow/weight_sync.py``) on
CPU buffers: the pool's allocation is its ``alloc`` argument, so the
leases, the invariant and the pool's bound run here; the copies on CUDA
streams run in ``tests/test_torch_cuda.py``."""
import gc
import sys
import threading
import time

import pytest
import torch

from repro_torch.core.obs import scoped
from repro_torch.core.workflow.weight_sync import (VersionedWeights,
                                                   WeightChannel,
                                                   WeightReceiver,
                                                   WeightSender,
                                                   _ALIGN, _card_of,
                                                   _StagingPool)
from repro_torch.tree import tree_leaves, tree_unflatten


def _host(nbytes):
    return torch.empty(nbytes, dtype=torch.uint8)


def _tree():
    return {"emb": torch.zeros(5, 3), "blocks": [
        {"w": torch.zeros(7, dtype=torch.bfloat16), "s": torch.zeros(())},
        {"w": torch.zeros(7, dtype=torch.bfloat16), "s": torch.zeros(())}],
        "head": torch.zeros(2, 9)}


def _publish(ch, pool, tree, version, fill=None):
    """The arena path of ``WeightSender.publish`` with the copy done on
    the host: a leased arena, written leaf by leaf, offered, released."""
    leaves = tree_leaves(tree)
    arena = pool.acquire(leaves)
    try:
        for view in arena.views:
            (fill or (lambda v, x: v.fill_(x)))(view, version)
        ch.offer(VersionedWeights(version, tree_unflatten(tree, arena.views),
                                  arena))
    finally:
        pool.release(arena)
    return arena


def _values(tree):
    return {float(v) for t in tree_leaves(tree) for v in t.flatten()}


def test_publish_never_writes_the_latest_or_a_leased_arena():
    """A swap holds version 1's arena open across two publishes: the
    second takes the other arena, the third waits until the swap ends and
    then takes the swap's arena, never the latest snapshot's."""
    tree = _tree()
    with scoped() as reg:
        ch = WeightChannel()
        pool = _StagingPool(ch, alloc=_host)
        a1 = _publish(ch, pool, tree, 1)
        held = ch.peek(lease=True)                 # a swap of version 1
        assert held.arena is a1 and a1.leases == 1
        a2 = _publish(ch, pool, tree, 2)
        assert a2 is not a1 and len(pool.arenas) == 2
        assert _values(held.host_params) == {1.0}
        third = threading.Thread(target=_publish, args=(ch, pool, tree, 3))
        third.start()
        third.join(0.3)
        assert third.is_alive()                    # a1 leased, a2 latest
        assert ch.latest_version() == 2
        assert _values(held.host_params) == {1.0}
        assert _values(ch.peek().host_params) == {2.0}
        ch.release(held)
        third.join(10)
        assert not third.is_alive()
        latest = ch.peek()
        assert latest.version == 3 and latest.arena is a1
        assert _values(latest.host_params) == {3.0}
        assert len(pool.arenas) == 2
        assert reg.counter("weight_staging_wait_seconds_total").value() \
            >= 0.25


@pytest.mark.parametrize("how", ["maybe_swap", "wait_and_swap"])
def test_a_lease_ends_only_after_the_swaps_copy(how):
    """The receiver leases the snapshot's arena as it reads the channel
    and releases it after its copy returns; its tensors are its own, so
    later publishes into the arena leave them alone."""
    tree = _tree()
    ch = WeightChannel()
    pool = _StagingPool(ch, alloc=_host)
    recv = WeightReceiver(ch, tree)
    seen = []
    copy = recv._to_device

    def to_device(host):
        seen.append(ch.peek().arena.leases)
        time.sleep(0.05)
        seen.append(ch.peek().arena.leases)
        return copy(host)

    recv._to_device = to_device
    arena = _publish(ch, pool, tree, 1)
    assert arena.leases == 0
    assert getattr(recv, how)() if how == "maybe_swap" \
        else recv.wait_and_swap(1, timeout=5.0)
    assert seen == [1, 1] and arena.leases == 0 and recv.version == 1
    mine = {t.data_ptr() for t in tree_leaves(recv.params)}
    assert not mine & {v.data_ptr() for v in arena.views}
    for v in (2, 3, 4):
        _publish(ch, pool, tree, v)
    assert _values(recv.params) == {1.0}
    assert not recv.maybe_swap() or recv.version == 4
    assert all(a.leases == 0 for a in pool.arenas)


def test_a_stale_or_absent_snapshot_leaves_no_lease():
    tree = _tree()
    ch = WeightChannel()
    pool = _StagingPool(ch, alloc=_host)
    recv = WeightReceiver(ch, tree, version=5)
    assert not recv.maybe_swap()                   # nothing staged
    ch.release(None)
    arena = _publish(ch, pool, tree, 3)
    assert not recv.maybe_swap() and arena.leases == 0
    assert ch.wait_for(3, timeout=1.0, lease=True).arena is arena
    assert arena.leases == 1
    ch.release(ch.peek())
    assert arena.leases == 0
    assert ch.wait_for(9, timeout=0.05, lease=True) is None
    assert arena.leases == 0


def test_arenas_are_aligned_flat_buffers_within_their_bound():
    tree = _tree()
    leaves = tree_leaves(tree)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    with scoped() as reg:
        ch = WeightChannel()
        pool = _StagingPool(ch, alloc=_host)
        arena = pool.acquire(leaves)
        base = arena.views[0].data_ptr()
        for view, t in zip(arena.views, leaves):
            assert (view.shape, view.dtype) == (t.shape, t.dtype)
            assert (view.data_ptr() - base) % _ALIGN == 0
            assert view.untyped_storage().data_ptr() \
                == arena.views[0].untyped_storage().data_ptr()
        gauge = reg.gauge("weight_staging_bytes")
        one = gauge.value()
        assert nbytes <= one <= nbytes + _ALIGN * len(leaves)
        pool.release(arena)
        pool.fill(leaves)
        pool.fill(leaves)
        assert len(pool.arenas) == 2 and gauge.value() == 2 * one
        other = [torch.zeros(3)]                   # another tree's layout
        pool.release(pool.acquire(other))
        assert len(pool.arenas) == 2 and gauge.value() == one + _ALIGN
        del pool, arena
        gc.collect()
        assert gauge.value() == 0


def test_a_cpu_tree_keeps_the_pageable_path_bit_for_bit():
    """No arena, no pinned copy: the snapshot is the tree's own copy and
    the receiver's swap ``to_device``'s output, as before arenas."""
    tree = {"a": torch.randn(3, 5),
            "b": {"c": torch.randn(7).to(torch.bfloat16)}}
    assert _card_of(tree_leaves(tree)) is None
    assert _card_of([]) is None
    with scoped() as reg:
        ch = WeightChannel()
        recv = WeightReceiver(ch, tree)
        sender = WeightSender(ch, mode="async")
        sender.publish(tree, 1)
        sender.flush()
        snap = ch.peek()
        assert snap.arena is None and not sender.pool.arenas
        for got, want in zip(tree_leaves(snap.host_params), tree_leaves(tree)):
            assert torch.equal(got, want) and got.dtype == want.dtype
            assert got.data_ptr() != want.data_ptr()
        assert recv.maybe_swap() and recv.version == 1
        for got, want in zip(tree_leaves(recv.params), tree_leaves(tree)):
            assert torch.equal(got, want)
        assert reg.counter("weight_copy_pinned_total").total() == 0
        assert reg.gauge("weight_staging_bytes").value() == 0
        assert reg.counter("weight_staging_wait_seconds_total").value() == 0


def test_swaps_see_whole_versions_in_order_under_contention():
    """More receiver threads than cores swap while versions are
    published leaf by leaf: every swap reads one whole version (a publish
    into a leased or latest arena would mix two), each receiver's
    versions rise, and the pool never holds more than two arenas."""
    tree = _tree()
    ch = WeightChannel()
    pool = _StagingPool(ch, alloc=_host)
    last, errors, versions = 60, [], {}

    def slow_fill(view, version):
        view.fill_(version)
        time.sleep(0)

    def run(i):
        recv = WeightReceiver(ch, tree)
        swap, copy, got = recv._swap, recv._to_device, {}

        def checked_swap(vw):
            got["v"] = vw.version
            return swap(vw)

        def to_device(host):
            vals = _values(host)
            if vals != {float(got["v"])}:
                errors.append((i, got["v"], vals))
            return copy(host)

        recv._swap, recv._to_device = checked_swap, to_device
        seen = versions[i] = []
        deadline = time.monotonic() + 30
        while recv.version < last and time.monotonic() < deadline:
            if recv.maybe_swap():
                seen.append(recv.version)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def publish():
            for v in range(1, last + 1):
                _publish(ch, pool, tree, v, fill=slow_fill)
                arenas.append(len(pool.arenas))

        arenas = []
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(16)]
        threads.append(threading.Thread(target=publish, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join(40)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert len(arenas) == last and max(arenas) == 2
    assert len(versions) == 16
    for seen in versions.values():
        assert seen == sorted(set(seen)) and seen[-1] == last
    assert all(a.leases == 0 for a in pool.arenas)
