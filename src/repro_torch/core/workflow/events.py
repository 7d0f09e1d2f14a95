"""Execution-timeline event log → Gantt chart / bubble-fraction analysis
(paper Fig. 11) and Perfetto-loadable Chrome trace export.

Stage-graph workers record spans under their stage name (``generate``,
``ref_inference``, ``reward``, ``advantage``, ``values``, ``update``,
``critic_update``, ...), so per-stage pipeline overlap is directly
visible. Any kind that is not bookkeeping (``wait`` / ``weight_sync``)
counts as busy time — custom stage names are busy by default.

Spans are stamped on the device trace's clock (``tracing.clock_ns``,
Unix-epoch nanoseconds, what ``torch.profiler``'s events carry) and
record their thread, their parent span and a trace id
(``core/obs/tracing.py``); the analysis below works on times relative to
the log's start. The same class is the port's one tracer: the engines,
weight sync and model record fine-grained spans into the process default
(``tracing.get_event_log()``) while tracing is on.

``to_chrome_trace()`` emits the same spans as ``traceEvents`` JSON
(complete ``"X"`` events on their thread's track at absolute times, meta
and span ids as ``args``) loadable in Perfetto / ``chrome://tracing``;
with ``into=`` it adds them to a ``torch.profiler`` export, where they
line up with its host and device events. ``benchmarks/gantt.py --trace``
writes it next to the ``BENCH_*.json`` trajectory.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.obs.tracing import clock_ns, pop, push

IDLE_KINDS = ("wait", "weight_sync")

# stable symbols for the built-in stage kinds; custom stages draw from
# _CUSTOM_PALETTE in registration order (see register_kinds)
BUILTIN_SYMBOLS = {"generate": "G", "update": "U", "forward": "F",
                   "weight_sync": "w", "wait": ".", "reward": "r",
                   "ref_inference": "R", "advantage": "A", "values": "V",
                   "critic_update": "C"}
_CUSTOM_PALETTE = "abcdefghijklmnopqstuvxyz0123456789"


def _merged_total(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of intervals — overlapping spans from
    multiple workers under one instance must not double-count."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "item"):            # numpy scalar
        try:
            return v.item()
        except Exception:              # noqa: BLE001
            pass
    return str(v)


@dataclass
class Event:
    instance: str   # e.g. "rollout-0", "train-0"
    kind: str       # "generate" | "update" | "wait" | "weight_sync" | ...
    start: float    # seconds since the log's start
    end: float
    meta: dict = field(default_factory=dict)
    start_ns: int = 0   # on the shared clock (tracing.clock_ns)
    end_ns: int = 0
    thread: int = 0     # native id of the thread that ran it
    span_id: int = 0
    parent: int = 0     # the parent span's id; 0 for a root
    trace_id: int = 0

    @property
    def duration(self) -> float:
        return self.end - self.start


class EventLog:
    def __init__(self):
        self._events: List[Event] = []
        self._lock = threading.Lock()
        self._kind_order: Dict[str, None] = {}   # insertion-ordered set
        self.t0_ns = clock_ns()

    def record(self, instance: str, kind: str, start_ns: int, end_ns: int,
               **meta) -> None:
        """A closed span stamped by the caller on the shared clock
        (``tracing.clock_ns``); the innermost span open on this thread
        is its parent."""
        ids = push()
        pop()
        self._add(instance, kind, start_ns, end_ns, meta, ids)

    def _add(self, instance, kind, start_ns, end_ns, meta, ids) -> None:
        sid, parent, trace = ids
        ev = Event(instance, kind, (start_ns - self.t0_ns) / 1e9,
                   (end_ns - self.t0_ns) / 1e9, meta, start_ns, end_ns,
                   threading.get_native_id(), sid, parent, trace)
        with self._lock:
            self._events.append(ev)

    def register_kinds(self, kinds: Sequence[str]) -> None:
        """Declare stage kinds up front (StageRunner registers the graph's
        stages in topological order) so gantt symbols are deterministic
        regardless of which worker thread records first."""
        with self._lock:
            for k in kinds:
                self._kind_order.setdefault(k, None)

    class _Span:
        __slots__ = ("log", "instance", "kind", "meta", "parent", "ids",
                     "start")

        def __init__(self, log, instance, kind, meta, parent=None):
            self.log, self.instance, self.kind, self.meta = log, instance, kind, meta
            self.parent = parent

        def __enter__(self):
            self.ids = push(self.parent)
            self.start = clock_ns()
            return self

        def set(self, key, value) -> None:
            self.meta[key] = value

        def __exit__(self, *exc):
            end = clock_ns()
            pop()
            self.log._add(self.instance, self.kind, self.start, end,
                          self.meta, self.ids)

    def span(self, instance: str, kind: str, *, parent=None,
             **meta) -> "_Span":
        """A span on the calling thread; ``parent`` is a
        ``tracing.current()`` taken on another thread."""
        return self._Span(self, instance, kind, meta, parent)

    # -- analysis ---------------------------------------------------------

    def events(self, instance: Optional[str] = None) -> List[Event]:
        with self._lock:
            ev = list(self._events)
        if instance:
            ev = [e for e in ev if e.instance == instance]
        return sorted(ev, key=lambda e: (e.start, e.end, e.kind))

    def instances(self) -> List[str]:
        with self._lock:
            return sorted({e.instance for e in self._events})

    def _fraction(self, instance: str, selector) -> float:
        ev = self.events(instance)
        if not ev:
            return 0.0
        span = max(e.end for e in ev) - min(e.start for e in ev)
        sel = _merged_total([(e.start, e.end) for e in ev if selector(e)])
        return sel / max(span, 1e-9)

    def busy_fraction(self, instance: str, busy_kinds=None) -> float:
        """busy_kinds=None counts every kind except IDLE_KINDS as busy.

        Overlapping spans (multiple workers recorded under one instance)
        are merged before summing, so the fraction never exceeds 1."""
        if busy_kinds is None:
            return self._fraction(instance,
                                  lambda e: e.kind not in IDLE_KINDS)
        return self._fraction(instance, lambda e: e.kind in busy_kinds)

    def wait_fraction(self, instance: str) -> float:
        """Fraction of the instance's span spent in bookkeeping waits
        (blocked fetches + weight sync), overlap-merged."""
        return self._fraction(instance, lambda e: e.kind in IDLE_KINDS)

    def bubble_fraction(self, busy_kinds=None) -> Dict[str, float]:
        return {i: 1.0 - self.busy_fraction(i, busy_kinds)
                for i in self.instances()}

    def to_rows(self) -> List[dict]:
        return [dict(instance=e.instance, kind=e.kind, start=e.start,
                     end=e.end, **e.meta) for e in self.events()]

    # -- export -----------------------------------------------------------

    def to_chrome_trace(self, path: Optional[str] = None, *,
                        into: Optional[str] = None) -> dict:
        """Perfetto / chrome://tracing ``traceEvents`` JSON: one complete
        ("X") event per span on its thread's track (pid, native tid) at
        its absolute time in µs, meta and span ids as args. With ``into``
        (a ``torch.profiler`` ``export_chrome_trace`` file) the spans are
        added to that trace, at times relative to its
        ``baseTimeNanoseconds`` as its own events are, so both line up in
        one file. Returns the trace dict; also writes it to ``path`` when
        given."""
        doc = {"traceEvents": [], "displayTimeUnit": "ms"}
        if into is not None:
            with open(into) as fh:
                doc = json.load(fh)
        base = int(doc.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        events = self.events()
        named = {(e.get("pid"), e.get("tid")) for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        trace: List[dict] = doc["traceEvents"]
        if into is None:
            trace.append({"ph": "M", "name": "process_name", "pid": pid,
                          "args": {"name": "asyncflow"}})
        threads: Dict[int, str] = {}
        for e in events:
            threads.setdefault(e.thread, e.instance)
        for tid, inst in threads.items():
            if (pid, tid) not in named:
                trace.append({"ph": "M", "name": "thread_name", "pid": pid,
                              "tid": tid, "args": {"name": inst}})
        for e in events:
            args = {k: _json_safe(v) for k, v in e.meta.items()}
            args.update(instance=e.instance, span_id=e.span_id,
                        parent=e.parent, trace_id=e.trace_id)
            trace.append({
                "name": e.kind,
                "cat": "idle" if e.kind in IDLE_KINDS else "stage",
                "ph": "X",
                "ts": round((e.start_ns - base) / 1e3, 3),
                "dur": round(max(e.end_ns - e.start_ns, 0) / 1e3, 3),
                "pid": pid,
                "tid": e.thread,
                "args": args,
            })
        if path:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc

    # -- rendering --------------------------------------------------------

    def _symbols(self, events: List[Event]) -> Dict[str, str]:
        """Stable symbol per kind: builtins keep theirs; custom kinds get
        distinct palette symbols — registered kinds first (deterministic
        by registration order), then first appearance in the timeline."""
        sym = dict(BUILTIN_SYMBOLS)
        with self._lock:
            order = list(self._kind_order)
        for e in events:
            if e.kind not in order:
                order.append(e.kind)
        used = set(sym.values())
        palette = iter(c for c in _CUSTOM_PALETTE if c not in used)
        for kind in order:
            if kind not in sym:
                sym[kind] = next(palette, "#")
        return sym

    def render_gantt(self, width: int = 80, busy_kinds=None) -> str:
        """ASCII Gantt chart (Fig. 11 analogue)."""
        ev = self.events()
        if not ev:
            return "(no events)"
        t_min = min(e.start for e in ev)
        t_max = max(e.end for e in ev)
        scale = width / max(t_max - t_min, 1e-9)
        sym = self._symbols(ev)
        lines = []
        for inst in self.instances():
            row = [" "] * width
            for e in self.events(inst):
                a = int((e.start - t_min) * scale)
                b = max(a + 1, int((e.end - t_min) * scale))
                ch = sym.get(e.kind, "#")
                for x in range(a, min(b, width)):
                    row[x] = ch
            lines.append(f"{inst:>12s} |{''.join(row)}|")
        return "\n".join(lines)
