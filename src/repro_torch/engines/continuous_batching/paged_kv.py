"""Paged KV cache — block-allocated KV pages for continuous batching.

The physical cache is one page pool per K/V tensor, shaped
``(L, num_pages, page_size, KVH, hd)`` and kept on the engine's device.
A sequence owns an ordered list of pages (allocated on demand as it
grows, freed as one unit when it finishes), so a prefix is prefilled
exactly once and then decoded incrementally — no per-chunk re-prefill —
and a finished sequence's memory is immediately reusable by a waiting
prompt. Writes update the pool tensors in place (the reference rebuilt
its arrays).

Ownership is keyed by *sequence id*, not decode slot: a partial-rollout
continuation can release its decode slot between chunks while its pages
stay parked, and resume later from the cached prefix.

Physical page 0 is reserved as a scratch/garbage page: the batched decode
step always writes one KV row per slot, and idle slots (plus page-table
padding) point at page 0 so those writes land harmlessly outside any
live sequence.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch


class KVPoolExhausted(RuntimeError):
    """No free pages left — admission must wait for a release."""


class PagedKVPool:
    """Block allocator + physical storage for per-sequence KV pages.

    Parameters
    ----------
    cfg: model config (num_layers / num_kv_heads / head_dim).
    num_pages: physical pages in the pool (page 0 is reserved).
    page_size: tokens per page.
    pages_per_seq: page-table width — the max pages one sequence may own
        (``page_size * pages_per_seq`` is the max sequence length).
    device: where the pool tensors live.
    """

    def __init__(self, cfg, *, num_pages: int, page_size: int,
                 pages_per_seq: int, dtype=None, device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.cfg = cfg
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.num_pages = int(num_pages)
        dtype = torch.bfloat16 if dtype is None else dtype
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self._lock = threading.Lock()
        # page 0 reserved: idle decode slots scatter their dummy KV row
        # there, so it must never belong to a live sequence
        self._free: List[int] = list(range(1, num_pages))
        self._owned: Dict[int, List[int]] = {}     # seq uid -> page ids
        self.kv_len: Dict[int, int] = {}           # seq uid -> tokens cached

    # -- allocation --------------------------------------------------------

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._owned.values())

    def owns(self, uid: int) -> bool:
        with self._lock:
            return uid in self._owned

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.page_size)

    def ensure(self, uid: int, n_tokens: int) -> None:
        """Grow ``uid``'s page list to cover ``n_tokens`` positions.

        Raises :class:`KVPoolExhausted` (allocating nothing) if the pool
        cannot satisfy the request — callers either defer admission or
        surface a configuration error.
        """
        need = self.pages_for(n_tokens)
        if need > self.pages_per_seq:
            raise ValueError(
                f"sequence needs {need} pages > pages_per_seq="
                f"{self.pages_per_seq} (page_size={self.page_size})")
        with self._lock:
            owned = self._owned.setdefault(uid, [])
            self.kv_len.setdefault(uid, 0)
            grow = need - len(owned)
            if grow <= 0:
                return
            if grow > len(self._free):
                if not owned:
                    del self._owned[uid]
                    del self.kv_len[uid]
                raise KVPoolExhausted(
                    f"need {grow} pages, {len(self._free)} free "
                    f"(pool={self.num_pages}, page_size={self.page_size})")
            for _ in range(grow):
                owned.append(self._free.pop())

    def release(self, uid: int) -> None:
        """Return every page owned by ``uid`` to the free list."""
        with self._lock:
            pages = self._owned.pop(uid, [])
            self.kv_len.pop(uid, None)
            self._free.extend(pages)

    def page_row(self, uid: int) -> np.ndarray:
        """``uid``'s page table row, padded with the reserved page 0."""
        row = np.zeros(self.pages_per_seq, np.int64)
        with self._lock:
            for i, p in enumerate(self._owned.get(uid, [])):
                row[i] = p
        return row

    # -- prefill write -----------------------------------------------------

    def write_prefill(self, uid: int, k_seq, v_seq, n_tokens: int) -> None:
        """Store a prefilled prefix in place: ``k_seq``/``v_seq`` are
        ``(L, S, KVH, hd)`` with the first ``n_tokens`` rows valid.
        Allocates pages on demand; one scatter for the whole prefix."""
        self.ensure(uid, n_tokens)
        with self._lock:
            pages = list(self._owned[uid])
        t = torch.arange(n_tokens)
        phys = torch.tensor(pages, dtype=torch.long)[t // self.page_size]
        phys, off = phys.to(self.k.device), (t % self.page_size).to(
            self.k.device)
        self.k[:, phys, off] = k_seq[:, :n_tokens].to(self.k.dtype)
        self.v[:, phys, off] = v_seq[:, :n_tokens].to(self.v.dtype)
        with self._lock:
            self.kv_len[uid] = max(self.kv_len.get(uid, 0), n_tokens)
