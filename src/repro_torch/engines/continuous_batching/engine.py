"""Continuous-batching rollout engine: slot scheduler + paged KV cache +
disaggregated prefill/decode dispatch on one device.

Two dispatch paths share the model:

* **prefill** — waiting prompts are admitted into free decode slots in
  padded length-buckets and run through the full-sequence forward once
  (``return_cache=True``, attention through ``kernels/flash_attention``);
  the prompt KV lands in block-allocated pages and the first response
  token is sampled from the prefill logits.
* **decode** — one step advances *every* occupied slot by one token
  against its paged KV: ``decode_step`` over the page pool and the round's
  page table, each layer writing its new K/V row into its page and
  ``kernels/decode_attention``'s paged mode reading the keys through the
  table. A mesh engine, or a pool whose dtype is not the compute dtype,
  gathers each slot's pages into a dense view instead, decodes on the
  views and scatters the one written row back. An MLA model (MiniCPM3,
  DeepSeek-V2) keeps one latent pool (``paged_kv.py``): the prefill
  writes each prompt's latents into its pages, and each layer of a
  round writes its new latent row into its page, then gathers that
  layer's rows through the table and attends over them (absorbed, plain
  PyTorch; ``models/mla.py``), one layer at a time.

A moe model is served dropless (``cfg.moe_dropless``): no pick drops, so
a request's output does not depend on its batch mates.

The moment a sequence finishes it is emitted (per-sample handoff — no
batch barrier), its pages and slot free, and the next waiting prompt is
admitted.  Partial rollout parks a paused sequence's pages between
chunks, so a continuation resumes from its cached prefix instead of
re-prefilling it (falling back to one prefill if its pages were
preempted under pool pressure).

While tracing is on (``core/obs/tracing.py``) the engine records its
phases as spans: ``cb.generate`` around a call, ``cb.wait`` for the
engine's lock, ``cb.admit`` with one ``cb.prefill`` a bucket (children
``forward``, ``sample``, ``sync``, ``write``), and ``cb.round`` a decode
round (children ``prepare``, ``forward``, ``sample``, ``sync``,
``retire``); inside a forward the model adds ``mla.attend`` and
``moe.ffn`` spans, one a layer. ``rollout_engine_wait_seconds_total``,
``rollout_tokens_total`` and ``rollout_kv_gather_bytes_total`` count the
lock's wait, the tokens appended and the bytes of K/V views the decode
rounds gathered (0 on the paged route; MLA's latent rows under
``kind="latent"``) always, and by ``phase`` (prefill, decode)
``rollout_model_tokens_total`` the live tokens through the trunk (no
padding, no idle slot), ``rollout_attended_pairs_total`` their
query-key pairs, and for a moe model ``moe_held_picks_total`` the picks
routed to held experts and ``moe_expert_rows_total`` the rows the expert
products computed, all layers: those two are counted on the device and
read at the bucket's or the round's ``sync``.

Sampling is counter-keyed per sequence — token ``i`` of sequence ``uid``
is drawn with the key ``fold_seed(seed, uid, i)`` (see
``rl/sampling.py``) — so trajectories do not depend on slot assignment
or batch composition.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional
from typing import Sequence as SeqList

import numpy as np
import torch

from repro_torch.core.obs import get_registry
from repro_torch.core.obs.tracing import span
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.engines.continuous_batching.paged_kv import (
    KVPoolExhausted, PagedKVPool)
from repro_torch.engines.continuous_batching.scheduler import (Sequence,
                                                               SlotScheduler)
from repro_torch.models import decode_step, forward
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import paged_cache
from repro_torch.models.layers import dtype_of
from repro_torch.models.mla import paged_latent_cache
from repro_torch.rl.sampling import _next_pow2, categorical, fold_seed

SUPPORTED_ARCHS = ("dense", "moe")


def _sample(logits, seed, uids, positions, temperature):
    """(next token (B,), its logprob (B,)) with counter keys per row."""
    lt = logits.float() / max(temperature, 1e-6)
    logp = torch.log_softmax(lt, dim=-1)
    nxt = categorical(lt, [fold_seed(seed, u, p)
                           for u, p in zip(uids, positions)])
    return nxt, logp.gather(1, nxt[:, None])[:, 0]


def _layers(ts):
    """Per-stack cache rows stacked over all layers in order."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


@torch.no_grad()
def _prefill_forward(params, cfg, toks, lens):
    """Bucketed prefill: one full forward over right-padded prompts
    yields KV for every prompt position and the logits at each row's last
    prompt position. ``lens`` is a host list. Returns (the pool rows:
    {"k", "v"} (L,B,S,KVH,hd) each, or MLA's {"latent"} (L,B,S,r+dr);
    the last logits (B, V))."""
    logits, _, cache = forward(params, cfg, {"tokens": toks},
                               return_cache=True)
    rows = torch.arange(len(lens), device=toks.device)
    last = logits[rows, torch.as_tensor(lens, device=toks.device) - 1]
    # moe: first_dense_layers prepended
    stacks = [cache[k] for k in ("dense_kv", "kv") if k in cache]
    if cfg.attention == "mla":
        return {"latent": _layers([torch.cat([c["c_kv"], c["k_rope"]], -1)
                                   for c in stacks])}, last
    return {"k": _layers([c["k"] for c in stacks]),
            "v": _layers([c["v"] for c in stacks])}, last


def _reads_pages(k_pool, cfg, mesh) -> bool:
    """Whether a decode round reads the pool through the page table: not
    on a mesh (the sharded combine splits a dense view's keys), nor where
    the pool's dtype is not the compute dtype (the kernel reads one)."""
    return mesh is None and k_pool.dtype == dtype_of(cfg.compute_dtype)


@torch.no_grad()
def _decode_round_forward(params, cfg, pool, page_table, pos_t, tok, *,
                          n_keys: int, mesh=None):
    """One continuous-batching decode step over every slot, to its logits.

    Paged route: ``decode_step`` over the pools and the round's page table;
    each layer writes its new KV row at ``pos`` into the slot's page and
    its attention reads every key through the table. Idle slots carry
    page-table rows of zeros and ``pos`` 0, so their dummy rows all land on
    row 0 of the reserved scratch page 0: several writes to one place,
    harmless, since no live sequence reads it.

    Gather route, where the paged one cannot go (``_reads_pages``):
    gathers each slot's pages into a dense per-slot view, runs the
    one-token ``decode_step`` (which writes the new KV row at ``pos`` into
    the view) and scatters that single row back into the page pool in
    place, idle slots' onto page 0 as above.

    Latent route (MLA): ``decode_step`` over the latent pool and the
    round's page table cut to the pages of its longest slot's ``n_keys``
    keys (a host count); each layer writes its new latent row into its
    page, then gathers that layer's rows through the table for its
    attention.

    ``page_table``, ``pos_t`` and ``tok`` are on the device; returns
    (logits (B, V), bytes of the K/V views or latent rows gathered)."""
    if pool.latent is not None:
        L, _, ps, width = pool.latent.shape
        w = -(-n_keys // ps)
        logits, _ = decode_step(
            params, cfg, paged_latent_cache(pool.latent, page_table[:, :w],
                                            pos_t), tok, pos_t)
        return logits, L * page_table.shape[0] * w * ps * width \
            * pool.latent.element_size()
    k_pool, v_pool, page_size = pool.k, pool.v, pool.page_size
    if _reads_pages(k_pool, cfg, mesh):
        logits, _ = decode_step(
            params, cfg, paged_cache(k_pool, v_pool, page_table, pos_t), tok,
            pos_t)
        return logits, 0
    L, _, ps, KVH, hd = k_pool.shape
    B, PPS = page_table.shape
    S = PPS * ps
    dev = k_pool.device
    k_view = k_pool[:, page_table].reshape(L, B, S, KVH, hd)
    v_view = v_pool[:, page_table].reshape(L, B, S, KVH, hd)
    logits, new_cache = decode_step(params, cfg, {"k": k_view, "v": v_view},
                                    tok, pos_t, mesh=mesh)
    bidx = torch.arange(B, device=dev)
    # pos < S always, so no clamp is needed here (torch would raise)
    phys = page_table[bidx, pos_t // page_size]                 # (B,)
    off = pos_t % page_size
    k_pool[:, phys, off] = new_cache["k"][:, bidx, pos_t]
    v_pool[:, phys, off] = new_cache["v"][:, bidx, pos_t]
    return logits, 2 * k_view.numel() * k_view.element_size()


class ContinuousBatchingEngine:
    """Slot-based streaming generation over a paged KV cache.

    Parameters
    ----------
    cfg: model config (dense and moe archs, GQA or MLA); a moe model is
        served dropless.
    num_slots: decode-slot pool size (the decode batch dimension).
    page_size: tokens per KV page.
    max_len: max total sequence length (prompt + generation); rounded up
        to a page multiple — fixes the decode attention window.
    num_pages: physical page-pool size; the default gives every slot its
        full page budget plus 50% headroom for parked continuations.
    max_new_tokens / temperature / eos_id: sampling policy defaults.
    seed: base of the counter-based sampling keys.
    uid_start: first sequence id — lets a caller rebuild the engine
        (e.g. to grow max_len) without colliding with earlier uids,
        keeping every sequence's sampling stream stable.
    device: where the KV pool lives and the steps run (``cuda`` unless
        the caller passes another); ``params`` must live there too.
    record_picks: a moe model's engine keeps every forward's picks of
        held experts on the device, for ``picks_of`` (a benchmark's
        comparison routes its reference as the engine routed).
    mesh: optional ``DeviceMesh``: decode attention goes through
        ``distributed/flash_decode``'s sharded partial-softmax combine
        over its "model" axis in place of ``kernels/decode_attention``
        (``max_len`` must split evenly over that axis). Every rank of the
        mesh runs the engine on the same requests and samples the same
        tokens.
    """

    def __init__(self, cfg, *, num_slots: int = 4, page_size: int = 8,
                 max_len: int = 64, num_pages: Optional[int] = None,
                 max_new_tokens: int = 8, temperature: float = 1.0,
                 eos_id: int = ByteTokenizer.eos_id, seed: int = 0,
                 uid_start: int = 0, dtype=None, device=None, mesh=None,
                 metrics=None, record_picks: bool = False):
        if cfg.arch_type not in SUPPORTED_ARCHS:
            # the reference's message (it serves GQA alone)
            raise ValueError(
                f"continuous batching supports GQA {SUPPORTED_ARCHS} archs "
                f"(got arch_type={cfg.arch_type!r}, "
                f"attention={cfg.attention!r})")
        if cfg.arch_type == "moe":
            cfg = dataclasses.replace(cfg, moe_dropless=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.page_size = int(page_size)
        self.max_len = -(-int(max_len) // self.page_size) * self.page_size
        pages_per_seq = self.max_len // self.page_size
        if num_pages is None:
            budget = num_slots * pages_per_seq
            num_pages = 1 + budget + budget // 2
        self.pool = PagedKVPool(cfg, num_pages=num_pages,
                                page_size=self.page_size,
                                pages_per_seq=pages_per_seq, dtype=dtype,
                                device=self.device)
        self.scheduler = SlotScheduler(num_slots)
        self.num_slots = int(num_slots)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = int(eos_id)
        self.seed = int(seed)
        self._next_uid = int(uid_start)
        self._parked: Dict[int, Sequence] = {}
        self._lock = threading.Lock()

        m = metrics if metrics is not None else get_registry()
        self._registry = m
        self._g_occupancy = m.gauge(
            "rollout_slot_occupancy",
            "fraction of decode slots occupied").labels(engine="cb")
        self._g_pages = m.gauge(
            "rollout_kv_pages_in_use",
            "KV pages currently allocated").labels(engine="cb")
        self._h_prefill = m.histogram(
            "rollout_prefill_seconds",
            "prefill dispatch latency per bucket").labels(engine="cb")
        self._h_decode = m.histogram(
            "rollout_decode_step_seconds",
            "one continuous-batching decode step").labels(engine="cb")
        self._c_admit = m.counter(
            "rollout_admissions_total",
            "prompts admitted into decode slots").labels(engine="cb")
        self._c_preempt = m.counter(
            "rollout_preemptions_total",
            "sequences evicted under KV-pool pressure").labels(engine="cb")
        self._c_wait = m.counter(
            "rollout_engine_wait_seconds_total",
            "seconds generate calls waited for the engine's lock").labels(
                engine="cb")
        self._c_tokens = m.counter(
            "rollout_tokens_total",
            "tokens appended to sequences (prefill and decode)").labels(
                engine="cb")
        gather = m.counter(
            "rollout_kv_gather_bytes_total",
            "bytes of per-slot K/V views decode rounds gathered")
        self._c_gather = (gather.labels(engine="cb", kind="latent")
                          if cfg.attention == "mla"
                          else gather.labels(engine="cb"))
        by_phase = (
            ("rollout_model_tokens_total",
             "live tokens through the trunk (no padding, no idle slot)"),
            ("rollout_attended_pairs_total",
             "query-key pairs of the live tokens"),
            ("moe_held_picks_total",
             "picks routed to held experts, all layers"),
            ("moe_expert_rows_total",
             "rows the expert products computed, all layers"))
        self._c_phase = {
            (name, ph): m.counter(name, help).labels(engine="cb", phase=ph)
            for name, help in by_phase for ph in ("prefill", "decode")}
        # the expert layers' device-side counts, read at each host sync
        self._tally = (moe_mod.PickTally(self.device)
                       if cfg.arch_type == "moe" else None)
        self._tally_read = [0, 0]
        # uid -> [(first position, a forward's (MoE layers, rows, tokens a
        # row, top_k) picks, its row, its tokens)]
        self._picks: Optional[Dict[int, list]] = None
        if record_picks and self._tally is not None:
            self._picks, self._tally.log = {}, []

    # ------------------------------------------------------------------ #
    # request construction                                                #
    # ------------------------------------------------------------------ #

    def make_sequence(self, tokens, *, max_new: Optional[int] = None,
                      chunk: int = 0, meta: Optional[dict] = None
                      ) -> Sequence:
        toks = [int(t) for t in np.asarray(tokens).tolist()]
        max_new = self.max_new_tokens if max_new is None else int(max_new)
        if len(toks) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(toks)}) + max_new ({max_new}) exceeds "
                f"engine max_len={self.max_len}")
        uid, self._next_uid = self._next_uid, self._next_uid + 1
        return Sequence(uid=uid, prompt_len=len(toks),
                        tokens=toks, logprobs=[0.0] * len(toks),
                        max_new=max_new, meta=dict(meta or {}),
                        chunk_left=int(chunk) or max_new)

    def resume(self, seq: Sequence, *, chunk: int = 0) -> Sequence:
        """Re-arm a paused continuation for its next chunk."""
        seq.chunk_left = int(chunk) or (seq.max_new - seq.gen_len)
        return seq

    # ------------------------------------------------------------------ #
    # the scheduling loop                                                 #
    # ------------------------------------------------------------------ #

    def generate(self, params, items: SeqList[Sequence], *,
                 version: int = 0,
                 emit: Optional[Callable[[Sequence], None]] = None):
        """Run every item to completion or chunk-pause.

        Returns ``(finished, paused)`` lists of :class:`Sequence`; with
        ``emit`` each finished sequence is handed off the moment it
        completes (per-sample streaming), before the call returns."""
        with span("cb.generate"):
            t0 = time.perf_counter()
            with span("cb.wait"):
                self._lock.acquire()
            try:
                self._c_wait.inc(time.perf_counter() - t0)
                return self._generate_locked(params, list(items), version,
                                             emit)
            finally:
                self._lock.release()

    def _generate_locked(self, params, items, version, emit):
        sched = self.scheduler
        for seq in items:
            seq.versions.append(version)
            self._parked.pop(seq.uid, None)
            sched.admit(seq)
        finished: List[Sequence] = []
        paused: List[Sequence] = []
        while not sched.idle:
            admitted = self._admit_and_prefill(params)
            if sched.num_active == 0:
                if admitted == 0 and sched.num_waiting:
                    raise RuntimeError(
                        "KV pool exhausted and nothing to preempt: "
                        f"{self.pool.free_pages} pages free — raise "
                        f"num_pages or lower num_slots/max_len")
                continue
            self._decode_one_round(params, finished, paused, emit)
        self._g_occupancy.set(0.0)
        self._g_pages.set(self.pool.pages_in_use)
        return finished, paused

    # -- admission / prefill dispatch --------------------------------------

    def _admit_and_prefill(self, params) -> int:
        """Move waiting sequences into free slots (strict FIFO); prefill
        fresh prefixes in padded length-buckets. Returns #admitted."""
        assigns = self.scheduler.take_admissions()
        if not assigns:
            return 0
        with span("cb.admit") as sp:
            sp.set("slots", len(assigns))
            return self._admit(params, assigns)

    def _admit(self, params, assigns) -> int:
        ok: List[tuple] = []
        deferred = False
        for slot, seq in assigns:
            if deferred:        # keep FIFO: nothing overtakes a deferral
                self.scheduler.defer(slot, seq)
                continue
            if not self._reserve_pages(seq):
                self.scheduler.defer(slot, seq)
                deferred = True
                continue
            ok.append((slot, seq))
        if not ok:
            return 0
        self._c_admit.inc(len(ok))
        need_prefill = [
            (s, q) for s, q in ok
            if self.pool.kv_len.get(q.uid, 0) < q.length - 1
            or q.gen_len == 0]
        buckets: Dict[int, List[tuple]] = {}
        for s, q in need_prefill:
            buckets.setdefault(((q.length + 7) // 8) * 8, []).append((s, q))
        for pad_len, group in sorted(buckets.items()):
            self._prefill_bucket(params, group, pad_len)
        self._g_occupancy.set(self.scheduler.occupancy)
        self._g_pages.set(self.pool.pages_in_use)
        return len(ok)

    def _reserve_pages(self, seq: Sequence) -> bool:
        """Ensure ``seq`` owns pages for its current prefix, preempting
        parked continuations under pool pressure."""
        while True:
            try:
                if not self.pool.owns(seq.uid):
                    self.pool.ensure(seq.uid, seq.length)
                return True
            except KVPoolExhausted:
                if not self._evict_parked():
                    return False

    def _evict_parked(self) -> bool:
        """Free the youngest parked continuation's pages (it re-prefills
        on resume — its sampled trajectory is unchanged)."""
        if not self._parked:
            return False
        uid = max(self._parked)        # youngest admission
        self.pool.release(uid)
        del self._parked[uid]
        self._c_preempt.inc()
        return True

    def _prefill_bucket(self, params, group: List[tuple], pad_len: int):
        """One prefill dispatch: right-padded prompts of similar length,
        batch padded to a power of two as the reference does for
        compile-shape reuse (padding rows have length 1 and uid 0; their
        samples are discarded)."""
        t0 = time.monotonic()
        B = _next_pow2(len(group))
        with span("cb.prefill") as sp:
            sp.set("rows", B)
            sp.set("pad_len", pad_len)
            with span("forward"):
                toks = np.zeros((B, pad_len), np.int64)
                lens = [1] * B
                uids = [0] * B
                for i, (_, q) in enumerate(group):
                    toks[i, :q.length] = q.tokens
                    lens[i] = q.length
                    uids[i] = q.uid
                with self._counting(enumerate(lens[:len(group)]),
                                    (B, pad_len)):
                    rows, last = _prefill_forward(
                        params, self.cfg,
                        torch.from_numpy(toks).to(self.device), lens)
            with span("sample"):
                nxt, lp = _sample(last, self.seed, uids, lens,
                                  self.temperature)
            with span("sync"):
                nxt, lp = nxt.tolist(), lp.tolist()
                real = lens[:len(group)]
                self._count("prefill", sum(real),
                            sum(n * (n + 1) // 2 for n in real),
                            ((i, q.uid, 0, q.length)
                             for i, (_, q) in enumerate(group)), pad_len)
            with span("write"):
                for i, (_, q) in enumerate(group):
                    if "latent" in rows:
                        self.pool.write_prefill_latent(
                            q.uid, rows["latent"][:, i], q.length)
                    else:
                        self.pool.write_prefill(q.uid, rows["k"][:, i],
                                                rows["v"][:, i], q.length)
                    self._append_token(q, int(nxt[i]), float(lp[i]))
                self._c_tokens.inc(len(group))
        self._h_prefill.observe(time.monotonic() - t0)

    def _counting(self, live, shape):
        """The expert layers' tally installed for a forward over ``shape``
        (rows, tokens a row) tokens, ``live`` yielding (row, its first n
        tokens live): padding and idle slots are not. Nothing is installed
        (nor ``live`` read) for a model without experts."""
        if self._tally is None:
            return contextlib.nullcontext()
        n = np.zeros(shape[0], np.int64)
        for row, k in live:
            n[row] = k
        mask = np.arange(shape[1])[None, :] < n[:, None]
        self._tally.live = torch.from_numpy(mask).to(self.device)
        return moe_mod.counting(self._tally)

    def _count(self, phase: str, tokens: int, pairs: int, placed,
               width: int) -> None:
        """A forward's counts by phase; the tally's device counts are read
        here, after the forward's own host sync. ``placed`` yields (row,
        uid, first position, tokens) of the live rows of a forward of
        ``width`` tokens a row, whose picks ``record_picks`` keeps."""
        c = self._c_phase
        c["rollout_model_tokens_total", phase].inc(tokens)
        c["rollout_attended_pairs_total", phase].inc(pairs)
        if self._tally is None:
            return
        now = self._tally.counts.tolist()
        c["moe_held_picks_total", phase].inc(now[0] - self._tally_read[0])
        c["moe_expert_rows_total", phase].inc(now[1] - self._tally_read[1])
        self._tally_read = now
        if self._picks is not None:
            log = torch.stack(self._tally.log)            # (L, rows * w, k)
            log = log.view(log.shape[0], -1, width, log.shape[-1])
            self._tally.log = []
            for row, uid, pos, n in placed:
                self._picks.setdefault(uid, []).append((pos, log, row, n))

    def picks_of(self, uid: int) -> np.ndarray:
        """The held experts each of ``uid``'s positions picked at each MoE
        layer, as its forwards (prefill, then decode rounds) picked them:
        uint8 (positions, MoE layers, top_k), an expert's index among those
        held, or the count held for one held elsewhere. Needs
        ``record_picks``."""
        parts = self._picks.get(uid, [])
        if not parts:
            return np.zeros((0, 0, 0), np.uint8)
        flat = torch.cat([log[:, row, :n].transpose(0, 1)
                          for _, log, row, n in parts]).cpu().numpy()
        out = np.zeros((max(p + n for p, _, _, n in parts),)
                       + flat.shape[1:], np.uint8)
        i = 0
        for pos, _, _, n in parts:           # a later forward overwrites
            out[pos:pos + n] = flat[i:i + n]
            i += n
        return out

    # -- decode dispatch ---------------------------------------------------

    def _append_token(self, seq: Sequence, tok: int, lp: float) -> None:
        seq.tokens.append(tok)
        seq.logprobs.append(lp)
        seq.gen_len += 1
        seq.chunk_left -= 1
        if tok == self.eos_id:
            seq.eos = True

    def _decode_one_round(self, params, finished, paused, emit) -> None:
        """Advance every occupied slot one token; retire/park finishers."""
        with span("cb.round") as rnd:
            with span("prepare"):
                stepping = self._grow_pages()
                if stepping:
                    t0 = time.monotonic()
                    page_table, pos_t, tok, pos, uids = \
                        self._round_inputs(stepping)
            rnd.set("slots", len(stepping))
            if not stepping:
                with span("retire"):
                    self._retire(finished, paused, emit)
                return
            with span("forward"), self._counting(
                    ((s, 1) for s, _ in stepping), (self.num_slots, 1)):
                logits, gathered = _decode_round_forward(
                    params, self.cfg, self.pool, page_table, pos_t, tok,
                    n_keys=max(pos) + 1, mesh=self.mesh)
            with span("sample"):
                nxt, lp = _sample(logits, self.seed, uids,
                                  [p + 1 for p in pos], self.temperature)
            with span("sync"):
                nxt, lp = nxt.tolist(), lp.tolist()
                # idle slots sit at position 0
                self._count("decode", len(stepping),
                            sum(pos) + len(stepping),
                            ((s, q.uid, pos[s], 1) for s, q in stepping), 1)
            with span("retire"):
                for s, q in stepping:
                    self.pool.kv_len[q.uid] = q.length
                    self._append_token(q, int(nxt[s]), float(lp[s]))
                self._c_tokens.inc(len(stepping))
                self._c_gather.inc(gathered)
                self._h_decode.observe(time.monotonic() - t0)
                self._retire(finished, paused, emit)

    def _grow_pages(self) -> List[tuple]:
        """The (slot, sequence) pairs that step this round, each owning
        the pages its next KV row needs (page-boundary growth; under pool
        pressure a parked continuation is evicted, or the sequence itself
        drops its pages and waits at the front of the queue)."""
        active = [(s, q) for s, q in self.scheduler.active()
                  if not (q.done or q.paused)]
        stepping = []
        for s, q in active:
            try:
                self.pool.ensure(q.uid, q.length)  # page-boundary growth
            except KVPoolExhausted:
                if self._evict_parked():
                    self.pool.ensure(q.uid, q.length)
                else:
                    # self-evict: drop this prefix's pages and requeue it
                    # at the front — it re-prefills once space frees
                    self.scheduler.release(s)
                    self.pool.release(q.uid)
                    self.scheduler.requeue_front(q)
                    self._c_preempt.inc()
                    continue
            stepping.append((s, q))
        return stepping

    def _round_inputs(self, stepping):
        """The round's page table, positions and tokens on the device
        (idle slots: zeros), and each slot's position and uid on the
        host."""
        B = self.num_slots
        page_table = np.zeros((B, self.pool.pages_per_seq), np.int64)
        pos = [0] * B
        tok = [0] * B
        uids = [0] * B
        for s, q in stepping:
            page_table[s] = self.pool.page_row(q.uid)
            pos[s] = q.length - 1                  # KV row being written
            tok[s] = q.tokens[-1]
            uids[s] = q.uid
        dev = self.device
        return (torch.from_numpy(page_table).to(dev),
                torch.as_tensor(pos, dtype=torch.long, device=dev),
                torch.tensor(tok, dtype=torch.long, device=dev), pos, uids)

    def _retire(self, finished, paused, emit) -> None:
        """Free slots of finished/paused sequences (per-sample handoff:
        a finished sequence is emitted immediately, and its slot is
        available to the next waiting prompt on the same loop pass)."""
        for s, q in self.scheduler.active():
            if q.done:
                self.scheduler.release(s)
                self.pool.release(q.uid)
                finished.append(q)
                if emit is not None:
                    emit(q)
            elif q.paused:
                self.scheduler.release(s)          # pages stay parked
                self._parked[q.uid] = q
                paused.append(q)
        self._g_occupancy.set(self.scheduler.occupancy)
        self._g_pages.set(self.pool.pages_in_use)

    # ------------------------------------------------------------------ #
    # maintenance                                                         #
    # ------------------------------------------------------------------ #

    def drop_parked(self, uid: int) -> None:
        """Discard a parked continuation's pages (abandoned rollout)."""
        self._parked.pop(uid, None)
        self.pool.release(uid)
