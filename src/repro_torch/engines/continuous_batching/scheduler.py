"""Slot-based decode scheduler — the control plane of continuous batching.

A fixed pool of decode slots is the unit of batching: every decode step
advances all occupied slots by one token, and the moment a sequence
finishes (EOS / token budget) its slot frees and the next waiting prompt
is admitted — no per-batch lockstep on the slowest sequence.

The scheduler is deliberately pure Python / numpy-free: slot state,
strict-FIFO admission fairness and per-sequence bookkeeping live here so
they can be tested without touching torch; the engine owns all device
compute.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional


@dataclass
class Sequence:
    """One in-flight request: prompt + everything generated so far.

    ``tokens``/``logprobs`` are plain lists while in flight (appended one
    token per decode step); the engine materializes arrays on emit.
    ``kv pages`` are owned by ``uid`` in the PagedKVPool, not stored here.
    """
    uid: int
    prompt_len: int
    tokens: List[int]
    logprobs: List[float]
    max_new: int                      # total new-token budget
    meta: dict = field(default_factory=dict)   # gid/member/prompt row, ...
    gen_len: int = 0                  # new tokens generated so far
    chunk_left: int = 0               # remaining budget this chunk (0 = off)
    versions: List[int] = field(default_factory=list)
    eos: bool = False
    admitted_at: int = -1             # admission sequence number (fairness)

    @property
    def length(self) -> int:
        return len(self.tokens)

    @property
    def done(self) -> bool:
        return self.eos or self.gen_len >= self.max_new

    @property
    def paused(self) -> bool:
        """Chunk budget exhausted but the sequence itself is unfinished."""
        return (not self.done) and self.chunk_left == 0 and \
            bool(self.versions)


class SlotScheduler:
    """Fixed decode-slot pool with a strict-FIFO waiting queue.

    ``admit`` enqueues; ``take_admissions`` hands out (slot, sequence)
    pairs for every free slot in admission order — the fairness contract
    is that no later arrival ever overtakes an earlier one into a slot.
    """

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        self.num_slots = int(num_slots)
        self.slots: List[Optional[Sequence]] = [None] * self.num_slots
        self.waiting: Deque[Sequence] = deque()
        self._uid_slot: Dict[int, int] = {}
        self._admit_counter = itertools.count()
        self._lock = threading.Lock()
        self.admissions_total = 0

    # -- queue side --------------------------------------------------------

    def admit(self, seq: Sequence) -> None:
        with self._lock:
            seq.admitted_at = next(self._admit_counter)
            self.waiting.append(seq)

    def take_admissions(self) -> List[tuple]:
        """Pop waiting sequences into free slots (FIFO) and return the new
        ``(slot, sequence)`` assignments. Deferred admissions (e.g. KV
        pool exhausted) are pushed back with :meth:`defer`."""
        out = []
        with self._lock:
            for s in range(self.num_slots):
                if self.slots[s] is None and self.waiting:
                    seq = self.waiting.popleft()
                    self.slots[s] = seq
                    self._uid_slot[seq.uid] = s
                    self.admissions_total += 1
                    out.append((s, seq))
        return out

    def defer(self, slot: int, seq: Sequence) -> None:
        """Undo an assignment from :meth:`take_admissions` (put the
        sequence back at the *front* of the queue — FIFO is preserved)."""
        with self._lock:
            self.slots[slot] = None
            self._uid_slot.pop(seq.uid, None)
            self.admissions_total -= 1
            self.waiting.appendleft(seq)

    def requeue_front(self, seq: Sequence) -> None:
        """Push an evicted sequence back to the head of the queue (it was
        admitted earliest among waiters, so FIFO order is preserved)."""
        with self._lock:
            self.waiting.appendleft(seq)

    # -- slot side ---------------------------------------------------------

    def release(self, slot: int) -> Optional[Sequence]:
        """Free a slot (finished or paused sequence); returns it."""
        with self._lock:
            seq = self.slots[slot]
            self.slots[slot] = None
            if seq is not None:
                self._uid_slot.pop(seq.uid, None)
            return seq

    def active(self) -> List[tuple]:
        """[(slot, sequence)] for every occupied slot."""
        with self._lock:
            return [(s, q) for s, q in enumerate(self.slots)
                    if q is not None]

    def slot_of(self, uid: int) -> Optional[int]:
        with self._lock:
            return self._uid_slot.get(uid)

    @property
    def num_active(self) -> int:
        with self._lock:
            return sum(q is not None for q in self.slots)

    @property
    def num_waiting(self) -> int:
        with self._lock:
            return len(self.waiting)

    @property
    def occupancy(self) -> float:
        return self.num_active / self.num_slots

    @property
    def idle(self) -> bool:
        with self._lock:
            return not self.waiting and all(q is None for q in self.slots)
