"""The seven readers of the program's spans and counters on a made-up
trace, made-up spans and made-up counter deltas: each gives the value
worked out by hand, and None where there is no trace, no span or no
counter (as on a checkout whose program has no tracer)."""
import sys

import pytest

from perfbench.core.profiling import Trace
from perfbench.core.spec import load_module
from repro_torch.core.obs import tracing

MS = 1_000_000
ROUND_READERS = ("round_idle_host_ms.rollout", "round_idle_host_ms.train",
                 "round_idle_sync_ms.rollout", "round_idle_sync_ms.train")


def _trace():
    ops = [("void gemm(x)", 12 * MS, 8 * MS),          # [12, 20]
           ("void decode_kernel(x)", 22 * MS, 11 * MS),  # [22, 33]
           ("Memcpy HtoD ", 52 * MS, 6 * MS)]           # SMs stay idle
    return Trace(ops, 0, 100 * MS, [])


def _spans(log):
    """Two whole rounds, one cut by the stretch's end, and a prefill whose
    children are not a round's."""
    ids = iter(range(1, 1000))

    def add(kind, a, b, parent=0):
        sid = next(ids)
        log._add("rollout-0", kind, int(a * MS), int(b * MS), {},
                 (sid, parent, 1))
        return sid
    for bounds in ((10, 14, 26, 30, 36, 40), (50, 52, 55, 57, 59, 60),
                   (95, 96, 97, 98, 99, 105)):
        r = add("cb.round", bounds[0], bounds[-1])
        for kind, a, b in zip(("prepare", "forward", "sample", "sync",
                               "retire"), bounds, bounds[1:]):
            add(kind, a, b, r)
    p = add("cb.prefill", 70, 80)
    add("forward", 70, 78, p)
    add("sync", 78, 80, p)


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_round_idle_by_phase():
    with tracing.scoped() as log:
        _spans(log)
        ctx = {"trace": _trace()}
        # round 1: prepare [10,14] idle 2 (gemm from 12), forward [14,26]
        # idle 2 ([20,22]), sample 0, retire [36,40] idle 4; sync [30,36]
        # idle 3. Round 2 has no kernel (the copy leaves the SMs idle):
        # host 2 + 3 + 2 + 1, sync 2. The cut round and the prefill are
        # left out.
        for cell in ("rollout", "train"):
            assert _read(f"round_idle_host_ms.{cell}", ctx) == \
                pytest.approx((8 + 8) / 2)
            assert _read(f"round_idle_sync_ms.{cell}", ctx) == \
                pytest.approx((3 + 2) / 2)


def test_round_readers_read_none_without_what_they_read(monkeypatch):
    for name in ROUND_READERS:
        assert _read(name, {"trace": None}) is None
    with tracing.scoped():                      # a trace, no program span
        for name in ROUND_READERS:
            assert _read(name, {"trace": _trace()}) is None
    with tracing.scoped() as log:               # a checkout with no tracer
        _spans(log)
        monkeypatch.setitem(sys.modules, "repro_torch.core.obs.tracing",
                            None)
        for name in ROUND_READERS:
            assert _read(name, {"trace": _trace()}) is None


def _delta(**series):
    out = {}
    for key, v in series.items():
        name, _, label = key.partition("__")
        labels = tuple(sorted(tuple(kv.split("=")) for kv in label.split(",")
                              if kv))
        out[(name, labels)] = v
    return out


def test_counter_readers():
    d = _delta(**{
        "rollout_engine_wait_seconds_total__engine=cb": {"value": 3.0},
        "stage_batch_seconds__stage=generate": {"sum": 10.0, "count": 4},
        "stage_batch_seconds__stage=actor_update": {"sum": 99.0,
                                                    "count": 8},
        "weight_copy_bytes_total__role=publish": {"value": 7.2e9},
        "weight_copy_bytes_total__role=swap": {"value": 14.4e9},
        "weight_copy_seconds__role=publish": {"sum": 2.0, "count": 1},
        "weight_copy_seconds__role=swap": {"sum": 3.0, "count": 2},
        "model_cast_bytes_total__": {"value": 3 * 28.4e9},
        "rollout_tokens_total__engine=cb": {"value": 600.0}})
    ctx = {"delta": d, "trace": None}
    assert _read("engine_wait_share.train", ctx) == pytest.approx(30.0)
    assert _read("weight_copy_gbps.train", ctx) == pytest.approx(4.32)
    assert _read("cast_bytes_per_token.rollout", ctx) == pytest.approx(142.0)


def test_counter_readers_read_none_without_their_counters():
    old = {"delta": _delta(**{
        "stage_batch_seconds__stage=generate": {"sum": 10.0, "count": 4},
        "weight_sync_seconds__role=publish": {"sum": 2.0, "count": 1}})}
    for name in ("engine_wait_share.train", "weight_copy_gbps.train",
                 "cast_bytes_per_token.rollout"):
        assert _read(name, old) is None
