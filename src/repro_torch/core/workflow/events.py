"""Execution-timeline event log → Gantt chart / bubble-fraction analysis
(paper Fig. 11) and Perfetto-loadable Chrome trace export.

Stage-graph workers record spans under their stage name (``generate``,
``ref_inference``, ``reward``, ``advantage``, ``values``, ``update``,
``critic_update``, ...), so per-stage pipeline overlap is directly
visible. Any kind that is not bookkeeping (``wait`` / ``weight_sync``)
counts as busy time — custom stage names are busy by default.

``to_chrome_trace()`` emits the same spans as ``traceEvents`` JSON
(complete ``"X"`` events keyed by instance, meta as ``args``) loadable
in Perfetto / ``chrome://tracing``; ``benchmarks/gantt.py --trace``
writes it next to the ``BENCH_*.json`` trajectory.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

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
    start: float
    end: float
    meta: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class EventLog:
    def __init__(self):
        self._events: List[Event] = []
        self._lock = threading.Lock()
        self._kind_order: Dict[str, None] = {}   # insertion-ordered set
        self.t0 = time.monotonic()

    def record(self, instance: str, kind: str, start: float, end: float,
               **meta) -> None:
        with self._lock:
            self._events.append(Event(instance, kind, start - self.t0,
                                      end - self.t0, meta))

    def register_kinds(self, kinds: Sequence[str]) -> None:
        """Declare stage kinds up front (StageRunner registers the graph's
        stages in topological order) so gantt symbols are deterministic
        regardless of which worker thread records first."""
        with self._lock:
            for k in kinds:
                self._kind_order.setdefault(k, None)

    class _Span:
        def __init__(self, log, instance, kind, meta):
            self.log, self.instance, self.kind, self.meta = log, instance, kind, meta

        def __enter__(self):
            self.start = time.monotonic()
            return self

        def __exit__(self, *exc):
            self.log.record(self.instance, self.kind, self.start,
                            time.monotonic(), **self.meta)

    def span(self, instance: str, kind: str, **meta) -> "_Span":
        return self._Span(self, instance, kind, meta)

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

    def to_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Perfetto / chrome://tracing ``traceEvents`` JSON: one complete
        ("X") event per span, one track (tid) per instance, meta as args.
        Returns the trace dict; also writes it to ``path`` when given."""
        insts = self.instances()
        tid = {inst: i for i, inst in enumerate(insts)}
        trace: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": "asyncflow"}}]
        for inst, i in tid.items():
            trace.append({"ph": "M", "name": "thread_name", "pid": 0,
                          "tid": i, "args": {"name": inst}})
        for e in self.events():
            trace.append({
                "name": e.kind,
                "cat": "idle" if e.kind in IDLE_KINDS else "stage",
                "ph": "X",
                "ts": round(e.start * 1e6, 3),
                "dur": round(max(e.duration, 0.0) * 1e6, 3),
                "pid": 0,
                "tid": tid[e.instance],
                "args": {k: _json_safe(v) for k, v in e.meta.items()},
            })
        doc = {"traceEvents": trace, "displayTimeUnit": "ms"}
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
