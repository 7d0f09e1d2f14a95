"""Profiler arithmetic: the device's busy time, time by operation, and the
idle gaps by what the host was doing.

The arithmetic is that of ``chip_smoke.py``'s ``_traced`` (device busy
share from ``torch.profiler``'s CUDA activity), copied here and made
exact: busy time is the union of the device operations' intervals inside
the traced stretch, so operations that overlap on two streams count once.
The SMs' busy time is the same union over kernels alone: the copy
engines' copies (``Memcpy``) and fills (``Memset``) leave the SMs idle.
Host spans are the benchmark's own, recorded around its calls into each
layer on the wall clock the profiler's events use.
"""
from __future__ import annotations

import functools
import re
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


class Spans:
    """Host spans (name, start ns, end ns) from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def wrap(self, name: str, fn):
        """``fn`` inside a span; its signature stays visible to callers
        that inspect it (the stage runner reads a verb's parameters)."""
        @functools.wraps(fn)
        def call(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)
        return call


def short_name(name: str) -> str:
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0][:80]


# Device operations that run on the copy engines, not on the SMs.
COPY_OPS = re.compile(r"^(Memcpy|Memset)")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device operations of a traced stretch [t0, t1] (ns, wall clock)."""

    def __init__(self, ops: List[Tuple[str, int, int]], t0: int, t1: int,
                 spans: List[Tuple[str, int, int]]):
        self.ops = [(n, max(s, t0), min(s + d, t1)) for n, s, d in ops
                    if s + d > t0 and s < t1]
        self.t0, self.t1 = t0, t1
        self.spans = [sp for sp in spans if sp[2] > t0 and sp[1] < t1]
        self.busy = _merge([(s, e) for _, s, e in self.ops if e > s])
        self.kernel_busy = _merge([(s, e) for n, s, e in self.ops
                                   if e > s and not COPY_OPS.match(n)])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which any operation, a copy too, ran."""
        return sum(e - s for s, e in self.busy) / 1e9

    @property
    def kernel_busy_s(self) -> float:
        """Seconds in which a kernel ran on the SMs."""
        return sum(e - s for s, e in self.kernel_busy) / 1e9

    def kernels(self, pattern: str, exclude: str = "") -> List[float]:
        """Durations (s) of the operations whose name matches."""
        rx = re.compile(pattern)
        return [(e - s) / 1e9 for n, s, e in self.ops
                if rx.search(n) and not (exclude and exclude in n)]

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(int)
        for n, s, e in self.ops:
            by[short_name(n)] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The SMs' idle time (no kernel running; a copy may be) by the
        set of host spans open during it."""
        gaps, prev = [], self.t0
        for s, e in self.kernel_busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # the host's time cut into segments, each with the set of spans
        # open in it (a sweep over the span edges)
        edges = sorted([(s, 1, n) for n, s, _ in self.spans]
                       + [(e, -1, n) for n, _, e in self.spans])
        open_, segs, prev = defaultdict(int), [], self.t0
        for t, step, n in edges:
            if t > prev:
                names = sorted(k for k, v in open_.items() if v > 0)
                segs.append((prev, t, "+".join(names) or "no span"))
                prev = t
            open_[n] += step
        segs.append((prev, self.t1, "no span"))
        by, j = defaultdict(int), 0
        for g0, g1 in gaps:
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < g1:
                a, b, label = segs[k]
                by[label] += min(b, g1) - max(a, g0)
                k += 1
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Profiled:
    """``torch.profiler`` over the CUDA activity alone, started and stopped
    from any thread (the device's operations are recorded whichever
    thread launched them)."""

    def __init__(self):
        self.prof = None
        self.t0: Optional[int] = None
        self.t1: Optional[int] = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def trace(self, spans: List[Tuple[str, int, int]]) -> Trace:
        from torch.autograd import DeviceType
        ops = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        return Trace(ops, self.t0, self.t1, spans)


def warm_profiler():
    """Start and stop the profiler once: its first start (CUPTI's set-up)
    takes seconds, which belong to set-up and not to the traced stretch."""
    p = Profiled()
    p.start()
    p.stop()


def summary(tr: Optional[Trace]) -> Dict[str, object]:
    if tr is None:
        return {}
    return {"busy_s": tr.busy_s, "window_s": tr.window_s,
            "breakdown": {"device_ops": tr.device_ops(),
                          "idle_gaps": tr.idle_gaps()}}
