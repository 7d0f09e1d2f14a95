"""Fine-grained spans on the device trace's clock: the port's one tracer,
recording into a process-wide :class:`~repro_torch.core.workflow.events.
EventLog` (``get_event_log()``, beside ``get_registry()``).

Every span is stamped with ``time.time_ns()``, Unix-epoch nanoseconds:
the clock that ``torch.profiler``'s host and device events carry, so a
span can be laid against the kernels that ran inside it. A span records
the thread that ran it, its parent (the innermost span open on that
thread, or one handed over from another thread with ``parent=current()``)
and a trace id, which a root span starts and its descendants share: the
spans of one engine call or one training step carry one id.

The engines, the weight sync and the model open spans with ``span(name)``.
They record only while tracing is on:

* while a ``torch.profiler`` session runs in the process (any thread), or
* after ``enable()``.

Otherwise a span site costs one flag check and gets the shared no-op
context back: no clock read, no lock, no allocation. Stdlib only: torch
is looked up among the loaded modules, never imported.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

clock_ns = time.time_ns          # the shared clock (ns since the epoch)

_explicit = False
_profiler_mod = None             # torch.autograd.profiler, once loaded


def enable(on: bool = True) -> bool:
    """Turn tracing on (or off) for the process; returns the previous
    explicit setting. A running ``torch.profiler`` session turns it on
    whatever this says."""
    global _explicit
    prev, _explicit = _explicit, bool(on)
    return prev


def enabled() -> bool:
    """True while ``enable()`` holds or a ``torch.profiler`` session runs
    (torch keeps a process-wide flag for it)."""
    global _profiler_mod
    if _explicit:
        return True
    mod = _profiler_mod
    if mod is None:
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _profiler_mod = mod
    return getattr(mod, "_is_profiler_enabled", False)


# -- the open spans of each thread -------------------------------------------

_local = threading.local()
_ids = itertools.count(1)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current() -> Optional[Tuple[int, int]]:
    """(span id, trace id) of the innermost span open on this thread, or
    None. Hand it to ``span(..., parent=)`` on another thread to make that
    thread's span a child of this one."""
    st = _stack()
    return st[-1] if st else None


def push(parent: Optional[Tuple[int, int]] = None) -> Tuple[int, int, int]:
    """Open a span on this thread: (its id, its parent's id or 0, its
    trace id). The parent is ``parent`` if given, else the innermost open
    span; a span with neither starts a trace of its own id."""
    sid = next(_ids)
    st = _stack()
    ctx = parent if parent is not None else (st[-1] if st else None)
    pid, trace = ctx if ctx is not None else (0, sid)
    st.append((sid, trace))
    return sid, pid, trace


def pop() -> None:
    _stack().pop()


# -- span sites ----------------------------------------------------------------

class _Noop:
    """The context every span site gets while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, key, value) -> None:
        return None


NOOP = _Noop()


def span(name: str, *, parent: Optional[Tuple[int, int]] = None):
    """A span of ``name`` on the calling thread, recorded into
    ``get_event_log()`` on exit while tracing is on; the shared no-op
    context otherwise. ``with span("x") as sp: sp.set("rows", n)`` adds
    meta (a no-op when off)."""
    if not enabled():
        return NOOP
    return get_event_log().span(threading.current_thread().name, name,
                                parent=parent)


# -- the process default log ---------------------------------------------------

_default_log = None
_log_lock = threading.Lock()


def get_event_log():
    """The process-wide event log that the engines, weight sync and model
    record into."""
    global _default_log
    log = _default_log
    if log is None:
        from repro_torch.core.workflow.events import EventLog
        with _log_lock:
            if _default_log is None:
                _default_log = EventLog()
            log = _default_log
    return log


def set_event_log(log):
    """Replace the process default; returns the previous one."""
    global _default_log
    with _log_lock:
        prev, _default_log = _default_log, log
    return prev


@contextmanager
def scoped(log=None, *, on: bool = True) -> Iterator[object]:
    """A fresh (or given) log as the process default, with tracing
    enabled (``on``), for the block — the test-isolation helper."""
    if log is None:
        from repro_torch.core.workflow.events import EventLog
        log = EventLog()
    prev_log = set_event_log(log)
    prev_on = enable(on)
    try:
        yield log
    finally:
        enable(prev_on)
        set_event_log(prev_log)
