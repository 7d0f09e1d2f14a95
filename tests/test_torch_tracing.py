"""The port's tracer (``core/obs/tracing.py`` over ``EventLog``) and the
spans and counters the engines, weight sync and model record: off, a span
site is the shared no-op and allocates nothing; on (``enable()`` or a
``torch.profiler`` session), spans carry their thread, parent and trace
and lie on the profiler's clock; a decode round's phases nest in order;
the counters equal what the shapes give."""
import itertools
import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs import get_registry, scoped
from repro_torch.core.obs import tracing
from repro_torch.core.obs.registry import DefaultCounter
from repro_torch.core.obs.tracing import span
from repro_torch.core.transfer_queue import TransferQueue
from repro_torch.core.workflow import (EventLog, WeightChannel,
                                       WeightReceiver, WeightSender)
from repro_torch.engines.continuous_batching import ContinuousBatchingEngine
from repro_torch.models import init_params
from repro_torch.rl import sampling

CFG = ModelConfig(name="tiny", arch_type="dense", citation="", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=512, qkv_bias=True)
ROUND = ["prepare", "forward", "sample", "sync", "retire"]
PREFILL = ["forward", "sample", "sync", "write"]


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, device="cpu")


def _engine(**kw):
    return ContinuousBatchingEngine(CFG, num_slots=4, page_size=8,
                                    max_len=48, device="cpu", **kw)


def _generate(eng, params, lens=(3, 5, 9), max_new=3):
    seqs = [eng.make_sequence(list(range(1, n + 1)), max_new=max_new)
            for n in lens]
    return eng.generate(params, seqs)


def _value(name, **labels):
    snap = get_registry().snapshot().get(name)
    if snap is None:
        return None
    return sum(s.get("value", s.get("sum", 0.0)) for s in snap["values"]
               if labels.items() <= s["labels"].items())


# -- off -----------------------------------------------------------------------

def test_off_no_span_is_recorded(params):
    with tracing.scoped(on=False) as log:
        assert not tracing.enabled()
        assert span("x") is tracing.NOOP
        _generate(_engine(), params)
        with span("outer") as sp:
            sp.set("k", 1)
        assert log.events() == []


def _peak_growth(loop, n):
    """Bytes the traced heap grew to at most while ``loop`` ran ``n``
    times (warmed first)."""
    loop(itertools.repeat(None, 8))
    it = itertools.repeat(None, n)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(it)
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_off_a_span_site_allocates_nothing():
    def sites(it):
        for _ in it:
            with span("cb.round") as sp:
                sp.set("slots", 7)
                with span("forward"):
                    pass

    noop = tracing.NOOP

    def bare(it):                 # the same statements on a held context
        for _ in it:
            with noop as sp:
                sp.set("slots", 7)
                with noop:
                    pass

    with tracing.scoped(on=False):
        off = _peak_growth(sites, 20_000)
        assert off == _peak_growth(bare, 20_000)
        assert off == _peak_growth(sites, 20)     # nothing grows with n
    with tracing.scoped(on=True):                 # the same sites when on
        assert _peak_growth(sites, 200) > 10_000


# -- on --------------------------------------------------------------------------

def test_enable_records_thread_parent_and_trace():
    with tracing.scoped() as log:
        with span("root") as r:
            r.set("rows", 4)
            with span("child"):
                with span("leaf"):
                    pass
            ctx = tracing.current()
        with span("other"):
            pass
        got = {}

        def worker():
            with span("remote", parent=ctx):
                got["thread"] = threading.get_native_id()
        t = threading.Thread(target=worker, name="remote-thread")
        t.start()
        t.join()
    ev = {e.kind: e for e in log.events()}
    root, child, leaf = ev["root"], ev["child"], ev["leaf"]
    assert root.parent == 0 and root.trace_id == root.span_id
    assert child.parent == root.span_id and leaf.parent == child.span_id
    assert child.trace_id == leaf.trace_id == root.trace_id
    assert ev["other"].parent == 0
    assert ev["other"].trace_id == ev["other"].span_id != root.trace_id
    remote = ev["remote"]
    assert remote.parent == root.span_id and remote.trace_id == root.trace_id
    assert remote.thread == got["thread"] != root.thread
    assert remote.instance == "remote-thread"
    assert root.meta == {"rows": 4}
    assert root.start_ns <= child.start_ns <= leaf.start_ns
    assert leaf.end_ns <= child.end_ns <= root.end_ns
    assert tracing.current() is None


def test_a_cpu_profiler_session_turns_tracing_on():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with tracing.scoped(on=False) as log:
        with span("before"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert tracing.enabled()
            with span("mm"):
                torch.mm(a, a)
        assert not tracing.enabled()
        with span("after"):
            pass
    (mm_span,) = log.events()
    assert mm_span.kind == "mm"
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert mm_span.start_ns <= mm[0].start_ns()
    assert mm[0].start_ns() + mm[0].duration_ns() <= mm_span.end_ns


def test_chrome_export_absolute_and_into_a_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    with tracing.scoped(on=False) as log:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("mm"):
                torch.mm(a, a)
    (ev,) = log.events()
    doc = log.to_chrome_trace()
    (x,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert x["ts"] == pytest.approx(ev.start_ns / 1e3, abs=1.0)
    assert x["tid"] == ev.thread and x["args"]["span_id"] == ev.span_id
    path = tmp_path / "profiler.json"
    prof.export_chrome_trace(str(path))
    merged = log.to_chrome_trace(str(tmp_path / "merged.json"),
                                 into=str(path))
    assert merged == json.loads((tmp_path / "merged.json").read_text())
    evs = merged["traceEvents"]
    (ours,) = [e for e in evs if e.get("name") == "mm"]
    (theirs,) = [e for e in evs if e.get("name") == "aten::mm"]
    assert ours["pid"] == theirs["pid"] and ours["tid"] == theirs["tid"]
    assert ours["ts"] <= theirs["ts"]
    assert theirs["ts"] + theirs["dur"] <= ours["ts"] + ours["dur"] + 1e-3


def test_event_log_analysis_on_the_shared_clock():
    log = EventLog()
    t = log.t0_ns
    s = 1_000_000_000
    log.record("w", "generate", t, t + 3 * s, n=2)
    log.record("w", "wait", t + 3 * s, t + 4 * s)
    ev = log.events()
    assert [e.start for e in ev] == [0.0, 3.0]
    assert ev[0].duration == pytest.approx(3.0)
    assert log.bubble_fraction() == {"w": pytest.approx(0.25)}
    assert log.to_rows()[0] == {"instance": "w", "kind": "generate",
                                "start": 0.0, "end": 3.0, "n": 2}
    assert "GGG" in log.render_gantt(width=8)


# -- the engines' spans ----------------------------------------------------------

def _children(events, parent):
    return sorted((e for e in events if e.parent == parent.span_id),
                  key=lambda e: e.start_ns)


def test_decode_round_phases_nest_in_order(params):
    with tracing.scoped() as log:
        fin, _ = _generate(_engine(), params)
    ev = log.events()
    (gen,) = [e for e in ev if e.kind == "cb.generate"]
    assert all(e.trace_id == gen.trace_id for e in ev)
    assert [e.kind for e in _children(ev, gen)][:2] == ["cb.wait",
                                                        "cb.admit"]
    rounds = [e for e in ev if e.kind == "cb.round"]
    assert len(rounds) == 2 and all(r.parent == gen.span_id
                                    for r in rounds)
    for r in rounds:
        kids = _children(ev, r)
        assert [k.kind for k in kids] == ROUND
        assert r.meta["slots"] == 3
        assert r.start_ns <= kids[0].start_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        assert kids[-1].end_ns <= r.end_ns
        assert all(k.thread == r.thread for k in kids)
    (admit,) = [e for e in ev if e.kind == "cb.admit"]
    prefills = _children(ev, admit)
    assert [p.kind for p in prefills] == ["cb.prefill"] * 2  # pads 8, 16
    for p in prefills:
        assert [k.kind for k in _children(ev, p)] == PREFILL
    assert sorted(p.meta["pad_len"] for p in prefills) == [8, 16]


def test_fixed_backend_steps(params):
    prompts = [np.arange(1, 4), np.arange(1, 6)]
    with tracing.scoped() as log:
        sampling.generate(params, CFG, prompts, 3, max_new_tokens=2,
                          device="cpu")
    ev = log.events()
    steps = [e for e in ev if e.kind == "fixed.step"]
    assert len(steps) == 8 + 2 - 1          # prompts padded to 8
    for s in steps:
        assert [k.kind for k in _children(ev, s)] == ["forward", "sample"]


# -- counters ----------------------------------------------------------------------

def test_tokens_and_cast_bytes_from_shapes(params):
    with scoped():
        eng = _engine()
        fin, _ = _generate(eng, params, max_new=3)
        tokens = sum(q.gen_len for q in fin)
        assert tokens == 9
        assert _value("rollout_tokens_total", engine="cb") == tokens
        # every dense and the head cast their fp32 weights and biases to
        # bf16 (4 bytes read, 2 written an element); the activations are
        # bf16 already. Four forwards: prefill buckets of pads 8 (prompts
        # of 3 and 5) and 16 (9), then two decode rounds.
        d, q, kv, ff = 64, 4 * 16, 2 * 16, 128
        layer = (d * q + q) + 2 * (d * kv + kv) + q * d + 3 * d * ff
        weights = 2 * layer + 512 * d
        assert _value("model_cast_bytes_total") == 4 * 6 * weights


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_gather_bytes_by_route(params, dtype):
    """A pool in the compute dtype (bf16) is read through the page table:
    no K/V view gathered. An fp32 pool under bf16 products takes the
    gather route: two (layers, slots, max_len, KV heads, hd) views of fp32
    a round, over the two decode rounds of three new tokens."""
    with scoped():
        _generate(_engine(dtype=dtype), params, max_new=3)
        views = 2 * CFG.num_layers * 4 * 48 * CFG.num_kv_heads * CFG.head_dim
        want = 0 if dtype == torch.bfloat16 else 2 * views * 4
        assert _value("rollout_kv_gather_bytes_total", engine="cb") == want


def test_engine_wait_counts_the_lock_wait_of_a_second_caller(params):
    with scoped(), tracing.scoped() as log:
        eng = _engine()
        inner = eng._generate_locked
        entered, stamps = threading.Event(), {}

        def slow(*a, **kw):
            stamps.setdefault(threading.current_thread().name,
                              time.perf_counter())
            entered.set()
            time.sleep(0.3)
            return inner(*a, **kw)
        eng._generate_locked = slow

        def call(name):
            stamps[name + ".call"] = time.perf_counter()
            _generate(eng, params, lens=(3,), max_new=1)
        a = threading.Thread(target=call, args=("a",), name="a")
        a.start()
        entered.wait()
        b = threading.Thread(target=call, args=("b",), name="b")
        b.start()
        a.join()
        b.join()
        want = (stamps["a"] - stamps["a.call"]) + (stamps["b"]
                                                   - stamps["b.call"])
        got = _value("rollout_engine_wait_seconds_total", engine="cb")
    assert got > 0.15 and got == pytest.approx(want, abs=0.02)
    waits = {e.instance: (e.end_ns - e.start_ns) / 1e9
             for e in log.events() if e.kind == "cb.wait"}
    assert waits["b"] == pytest.approx(stamps["b"] - stamps["b.call"],
                                       abs=0.02)


def test_weight_copy_bytes_and_spans():
    tree = {"a": torch.ones(3, 5), "b": {"c": torch.zeros(7,
                                                          dtype=torch.bfloat16)}}
    nbytes = 3 * 5 * 4 + 7 * 2
    with scoped(), tracing.scoped() as log:
        ch = WeightChannel()
        recv = WeightReceiver(ch, tree)
        sender = WeightSender(ch, mode="async")
        with span("update"):
            caller = tracing.current()
            sender.publish(tree, 1)
        sender.flush()
        assert recv.maybe_swap()
        for role in ("publish", "swap"):
            assert _value("weight_copy_bytes_total", role=role) == nbytes
            h = get_registry().histogram("weight_copy_seconds").summary(
                role=role)
            assert h["count"] == 1 and h["sum"] > 0
    ev = log.events()
    (pub,) = [e for e in ev if e.kind == "weights.publish"]
    assert pub.parent == caller[0] and pub.trace_id == caller[1]
    assert [k.kind for k in _children(ev, pub)] == ["copy", "offer"]
    (swap,) = [e for e in ev if e.kind == "weights.swap"]
    assert [k.kind for k in _children(ev, swap)] == ["copy"]


def test_unread_counters_are_gone():
    with scoped() as reg:
        tq = TransferQueue(4, {"t": ["a"]})
        for i in tq.next_indices(2):
            tq.put(i, "a", i)
        assert tq.get("t", 2, timeout=1.0) is not None
        ch = WeightChannel()
        recv = WeightReceiver(ch, {"w": torch.ones(2)})
        WeightSender(ch, mode="sync").publish({"w": torch.ones(2)}, 3)
        recv.maybe_swap()
        names = set(reg.names())
    assert "tq_rows_consumed_total" in names
    assert not names & {"tq_requests_total", "tq_rows_ready_total",
                        "weight_versions_skipped_total"}


def test_default_counter_rebinds_after_clear_and_swap():
    c = DefaultCounter("x_total", engine="cb")
    with scoped() as reg:
        c.inc(2)
        assert reg.counter("x_total").value(engine="cb") == 2
        reg.clear()
        c.inc(3)
        assert reg.counter("x_total").value(engine="cb") == 3
        with scoped() as other:
            c.inc(5)
            assert other.counter("x_total").value(engine="cb") == 5
        assert reg.counter("x_total").value(engine="cb") == 3


def test_tracer_needs_no_torch():
    import subprocess
    import sys
    from pathlib import Path
    code = ("import sys; sys.modules['torch'] = None\n"
            "from repro_torch.core.obs import tracing\n"
            "assert not tracing.enabled()\n"
            "with tracing.scoped() as log:\n"
            "    with tracing.span('a'):\n"
            "        with tracing.span('b'):\n"
            "            pass\n"
            "assert [e.kind for e in log.events()] == ['a', 'b']\n"
            "print('ok')\n")
    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(src)},
                         timeout=120)
    assert res.stdout.strip() == "ok", res.stderr
