"""The program's own spans (``repro_torch.core.obs.tracing``, recorded
while the profiler runs) inside a traced stretch, and the SMs' idle time
under them.

The program stamps its spans on the clock the profiler's events carry,
so a span's interval can be laid against the kernels' union in
``Trace.kernel_busy``. A checkout whose program records no spans yields
None, and a reader returns None for it.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

HOST_PHASES = ("prepare", "forward", "sample", "retire")
SYNC_PHASES = ("sync",)


def events(tr) -> Optional[list]:
    """The program's spans that overlap the traced stretch, or None where
    the program has no tracer."""
    try:
        from repro_torch.core.obs.tracing import get_event_log
    except ImportError:
        return None
    return [e for e in get_event_log().events()
            if e.end_ns > tr.t0 and e.start_ns < tr.t1]


def idle_ns(tr, intervals: Sequence[tuple]) -> int:
    """Nanoseconds of the given (start, end) intervals, clipped to the
    stretch, in which no kernel ran (the complement of the kernels'
    union); overlapping intervals count each."""
    busy = tr.kernel_busy
    starts = [s for s, _ in busy]
    total = 0
    for a, b in intervals:
        a, b = max(a, tr.t0), min(b, tr.t1)
        if b <= a:
            continue
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(busy[i][1], b) - max(busy[i][0], a))
            i += 1
        total += (b - a) - covered
    return total


def rounds(tr, evs: List) -> list:
    """The decode rounds (``cb.round``) wholly inside the stretch."""
    return [e for e in evs if e.kind == "cb.round"
            and tr.t0 <= e.start_ns and e.end_ns <= tr.t1]


def round_idle_ms(ctx, phases: Sequence[str]) -> Optional[float]:
    """SM-idle ms a decode round while the round's thread is in one of
    ``phases`` (its child spans of those names), over the rounds wholly
    inside the traced stretch; None without a trace, the program's spans
    or a round."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    evs = events(tr)
    if evs is None:
        return None
    rs = rounds(tr, evs)
    if not rs:
        return None
    ids = {r.span_id for r in rs}
    kids = [(e.start_ns, e.end_ns) for e in evs
            if e.parent in ids and e.kind in phases]
    return idle_ns(tr, kids) / len(rs) / 1e6
