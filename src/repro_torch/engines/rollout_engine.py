"""Rollout engine — the inference-cluster backend.

Implements the inference-side ``RLAdapter`` verbs as separately-streamed
stage-graph tasks (paper §3.3 / §5.2):

* ``generate_sequences`` — sample G responses per prompt with the
  KV-cache decode loop and emit one experience row per sample (columns:
  response / logprob / response_mask / response_ids / group / answer).
  With ``chunk_tokens`` set it runs partial rollout (k1.5-style, §4.2.1):
  each call advances every sequence by at most ``chunk_tokens`` tokens and
  unfinished sequences are handed back as *continuations* that re-enter
  TransferQueue and resume on a later call — possibly under newer weights
  (sub-step asynchrony). Behavior logprobs of already-generated tokens
  are preserved verbatim (the behavior policy is the chunk-wise mixture,
  exactly what old_logprob must record).
* ``compute_log_prob`` — the reference-inference task: per-token frozen
  reference logprobs for the KL penalty.
* ``compute_rewards`` — the reward/advantage task: rule-based rewards per
  row plus (for GRPO) group-relative advantages, emitted as deferred
  writes once every member of a group has streamed through.

The fused ``generate``/``generate_chunked`` entry points (generation +
reference + reward + advantage in one call) remain as the legacy
two-task protocol used by ``AsyncRLRunner`` and the fused-vs-staged
benchmarks; they are thin compositions of the staged verbs above.

Every verb runs under ``torch.no_grad()``: grad mode is per thread and on
by default in the stage runner's worker threads, and the rollout's
kernels (flash prefill, decode attention, ``mamba_scan``,
``grpo_logprob``) have no backward, so they raise rather than record a
graph.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engines.adapter import EngineRegistry, RLAdapter
from repro_torch.rl.advantage import grpo_advantages
from repro_torch.rl.reward import math_reward
from repro_torch.rl.sampling import generate as sample_generate
from repro_torch.rl.sampling import require_token_model


@EngineRegistry.register("torch_rollout")
class RolloutEngine(RLAdapter):
    def __init__(self, cfg, *, group_size: int = 4, max_new_tokens: int = 8,
                 temperature: float = 1.0, reward_fn=math_reward,
                 ref_params=None, chunk_tokens: int = 0,
                 backend: str = "fixed", cb_slots: int = 4,
                 cb_page_size: int = 8, cb_max_len: int = 0,
                 cb_seed: int = 0, ref_rows: int, ref_len: int,
                 device=None, mesh=None):
        """ref_params: frozen reference policy — enables the
        ``compute_log_prob`` reference-inference task (per-token ref
        logprobs for the KL penalty).

        chunk_tokens > 0 enables partial rollout (see module docstring).

        backend="continuous" routes sampling through the
        ``engines/continuous_batching`` subsystem (slot scheduler + paged
        KV cache): finished sequences stream out per-sample, and chunked
        continuations resume from their cached KV pages instead of
        re-prefilling the whole prefix. Sampling there is keyed per
        (cb_seed, sequence, position), so trajectories are independent of
        batch composition — fused and staged runs match by construction.

        ref_rows, ref_len: the one shape of a reference-inference call
        (``ref_rows`` sequences padded to ``ref_len`` tokens; a longer
        sequence goes alone at its own length), so that a sequence's
        reference logprobs do not depend on which others the stage's
        timing batched it with. No default: the caller states the shape
        its stage runs (the Trainer: its micro-batch and ``seq_len``).

        device: where sampling and reference inference run (``cuda``
        unless the caller passes another); params and ``ref_params`` live
        there.

        mesh: optional ``DeviceMesh`` handed to the continuous backend
        (its decode attention goes through the sharded combine), as in
        the reference; the fixed backend does not take it.

        Refuses the audio family (``rl.sampling.require_token_model``)."""
        require_token_model(cfg, "RolloutEngine")
        if backend not in ("fixed", "continuous"):
            raise ValueError(f"unknown rollout backend {backend!r}")
        self.cfg = cfg
        self.group_size = group_size
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.reward_fn = reward_fn
        self.ref_params = ref_params
        self.chunk_tokens = chunk_tokens
        self.backend = backend
        self.cb_slots = cb_slots
        self.cb_page_size = cb_page_size
        self.cb_max_len = cb_max_len
        self.cb_seed = cb_seed
        self.ref_rows = max(1, int(ref_rows))
        self.ref_len = int(ref_len)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._cb = None                  # lazy ContinuousBatchingEngine
        self._groups: dict = {}          # fused path: gid -> finished members
        self._reward_groups: dict = {}   # staged path: gid -> (member, idx, r)
        self._glock = threading.Lock()
        self._gid = 0
        # cold resume: a run snapshot's rollout cursor sets these bases so
        # a resumed run continues the (cb_seed, uid, pos)-keyed sampling
        # stream exactly where the uninterrupted run would be
        self.cb_uid_start = 0

    def _new_gid(self) -> int:
        with self._glock:
            self._gid += 1
            return self._gid

    # ------------------------------------------------------------------ #
    # staged verbs (stage-graph tasks)                                    #
    # ------------------------------------------------------------------ #

    def _sample_rows(self, params, prompts: List[dict], rng, *,
                     version: int = 0, emit=None) -> List[dict]:
        """Sample prompts x G; one staged experience row per sample (no
        reward/advantage — those stream through their own stages)."""
        if self.backend == "continuous":
            return self._sample_rows_cb(params, prompts, version=version,
                                        emit=emit)
        G = self.group_size
        flat = [p["tokens"] for p in prompts for _ in range(G)]
        seed = int(rng.integers(0, 2**31 - 1))
        outs = sample_generate(params, self.cfg, flat, seed,
                               max_new_tokens=self.max_new_tokens,
                               temperature=self.temperature,
                               device=self.device)
        rows = []
        for pi, p in enumerate(prompts):
            gid = self._new_gid()
            for m in range(G):
                o = outs[pi * G + m]
                rows.append(dict(
                    prompt=p, response=o["tokens"], logprob=o["logprobs"],
                    response_mask=o["response_mask"],
                    response_ids=o["response_ids"],
                    group=(gid, m, G), answer=p["answer"],
                    token_len=int(o["response_mask"].sum())))
        if emit is not None:
            for r in rows:
                emit(r)
            return []
        return rows

    # ------------------------------------------------------------------ #
    # continuous-batching backend                                         #
    # ------------------------------------------------------------------ #

    def _cb_engine(self, need_len: int):
        """Lazy continuous-batching engine, rebuilt (uid space preserved)
        if a longer prompt+budget arrives than the current max_len; parked
        continuations survive a rebuild by re-prefilling on resume."""
        from repro_torch.engines.continuous_batching import \
            ContinuousBatchingEngine
        with self._glock:
            eng = self._cb
            if eng is None or need_len > eng.max_len:
                self._cb = ContinuousBatchingEngine(
                    self.cfg, num_slots=self.cb_slots,
                    page_size=self.cb_page_size,
                    max_len=max(need_len, self.cb_max_len,
                                eng.max_len if eng else 0),
                    max_new_tokens=self.max_new_tokens,
                    temperature=self.temperature, seed=self.cb_seed,
                    uid_start=self.cb_uid_start if eng is None
                    else eng._next_uid, device=self.device, mesh=self.mesh)
            return self._cb

    def _member_from_seq(self, q) -> dict:
        """Finished/paused CB Sequence -> chunked member dict (the same
        shape ``_member_row`` / ``_emit_finished_groups`` consume)."""
        return {"_cont": True, "gid": q.meta["gid"],
                "member": q.meta["member"], "prompt": q.meta["prompt"],
                "tokens": np.asarray(q.tokens),
                "logprobs": np.asarray(q.logprobs, np.float32),
                "gen_len": q.gen_len, "versions": list(q.versions),
                "_cb_seq": q}

    def _sample_rows_cb(self, params, prompts: List[dict], *,
                        version: int = 0, emit=None) -> List[dict]:
        """One-shot sampling through the continuous batcher: slots admit
        prompt×G members FIFO, finished rows stream out per-sample."""
        G = self.group_size
        need = max(len(p["tokens"]) for p in prompts) + self.max_new_tokens
        eng = self._cb_engine(need)
        seqs = []
        for p in prompts:
            gid = self._new_gid()
            for m in range(G):
                seqs.append(eng.make_sequence(
                    p["tokens"], meta=dict(prompt=p, gid=gid, member=m)))
        to_row = lambda q: self._member_row(self._member_from_seq(q),
                                            chunked=False)
        if emit is not None:
            eng.generate(params, seqs, version=version,
                         emit=lambda q: emit(to_row(q)))
            return []
        fin, _ = eng.generate(params, seqs, version=version)
        fin.sort(key=lambda q: q.uid)    # restore prompt×G block order
        return [to_row(q) for q in fin]

    def _advance_chunks_cb(self, params, items: List[dict], *,
                           version: int = 0, emit=None):
        """Partial rollout on the paged KV cache: a continuation carries
        its live ``Sequence`` (``_cb_seq``) whose KV pages stay parked in
        the pool between chunks — resuming costs no re-prefill unless the
        pages were preempted under pool pressure."""
        C = self.chunk_tokens or self.max_new_tokens
        G = self.group_size
        need = self.max_new_tokens
        for it in items:
            if it.get("_cont"):
                q = it["_cb_seq"]
                need = max(need, q.prompt_len + q.max_new)
            else:
                need = max(need, len(it["tokens"]) + self.max_new_tokens)
        eng = self._cb_engine(need)
        seqs = []
        for it in items:
            if it.get("_cont"):
                seqs.append(eng.resume(it["_cb_seq"], chunk=C))
            else:
                gid = self._new_gid()
                for m in range(G):
                    seqs.append(eng.make_sequence(
                        it["tokens"], chunk=C,
                        meta=dict(prompt=it, gid=gid, member=m)))
        emit_cb = None if emit is None else \
            (lambda q: emit(self._member_from_seq(q)))
        fin, paused = eng.generate(params, seqs, version=version,
                                   emit=emit_cb)
        fin.sort(key=lambda q: q.uid)
        finished = [] if emit is not None else \
            [self._member_from_seq(q) for q in fin]
        return finished, [self._member_from_seq(q) for q in paused]

    @torch.no_grad()
    def generate_sequences(self, batch, *, params, rng, version: int = 0,
                           emit=None, heartbeat=None, **kw):
        """Stage verb: batch["prompt"] -> {"rows": [...], "requeue": [...]}.

        Chunked engines emit each finished group member immediately — the
        downstream reward stage owns group completion, so members stream
        out without waiting for their group.  With the continuous backend
        an ``emit`` callback receives each finished row the moment its
        sequence completes (per-sample handoff into the TransferQueue);
        emitted rows are excluded from the returned batch.

        ``heartbeat`` (supervised fleets) is pinged per emitted sample so
        a long rollout is never mistaken for a hung replica."""
        prompts = batch["prompt"]
        if heartbeat is not None:
            heartbeat()
            if emit is not None:
                inner = emit
                emit = lambda row: (heartbeat(), inner(row))[1]
        if self.chunk_tokens:
            row_emit = None if emit is None else \
                (lambda s: emit(self._member_row(s)))
            finished, conts = self._advance_chunks(params, prompts, rng,
                                                   version=version,
                                                   emit=row_emit)
            return {"rows": [self._member_row(s) for s in finished],
                    "requeue": conts}
        return {"rows": self._sample_rows(params, prompts, rng,
                                          version=version, emit=emit)}

    @torch.no_grad()
    def _ref_logprobs(self, responses, params=None) -> List[np.ndarray]:
        """Per-token logprobs of the frozen reference over full sequences
        (position 0 gets 0.0 — no prediction for the first token): one
        forward through the flash or ``mamba_scan`` kernel, then
        ``token_logprobs`` through the ``grpo_logprob`` kernel (their plain
        versions on the CPU).

        Every call has one shape: ``ref_rows`` sequences padded to
        ``ref_len`` tokens, and a longer sequence goes alone at its own
        length. On the card a row's result depends on the shape of the
        call it is in (the products' and the vocab pass's tiling follow
        the rows and the padded length) but not on the other rows, and the
        batches the reference stage receives follow the run's timing; with
        the shape fixed, two runs of one seed give each sequence the same
        logprobs."""
        from repro_torch.models import forward
        from repro_torch.rl.loss import token_logprobs
        params = self.ref_params if params is None else params
        arrs = [np.asarray(t, np.int64) for t in responses]
        out = [np.zeros(len(a), np.float32) for a in arrs]
        fits = [i for i, a in enumerate(arrs) if len(a) <= self.ref_len]
        calls = [(fits[k:k + self.ref_rows], self.ref_rows, self.ref_len)
                 for k in range(0, len(fits), self.ref_rows)]
        calls += [([i], 1, len(a)) for i, a in enumerate(arrs)
                  if len(a) > self.ref_len]
        for idx, rows, S in calls:
            if S < 2:
                continue
            toks = np.zeros((rows, S), np.int64)
            for r, i in enumerate(idx):
                toks[r, :len(arrs[i])] = arrs[i]
            toks = torch.from_numpy(toks).to(self.device)
            logits, _ = forward(params, self.cfg, {"tokens": toks})
            lp, _ = token_logprobs(logits[:, :-1], toks[:, 1:])
            lp = lp.cpu().numpy()
            for r, i in enumerate(idx):
                out[i][1:] = lp[r, :len(arrs[i]) - 1]
        return out

    def compute_log_prob(self, batch, *, params=None, **kw):
        """Stage verb (reference inference): writes ``ref_logprob``."""
        return {"updates": {"ref_logprob":
                            self._ref_logprobs(batch["response"],
                                               params=params)}}

    def compute_rewards(self, batch, *, indices=None,
                        group_advantage: bool = True, **kw):
        """Stage verb: rule-based reward per row; with ``group_advantage``
        (GRPO) also buffers rewards per group and emits group-relative
        advantages as deferred writes once all G members streamed in."""
        rewards = [float(self.reward_fn(a, rid))
                   for a, rid in zip(batch["answer"], batch["response_ids"])]
        out = {"updates": {"reward": rewards}}
        if not group_advantage:
            return out
        writes = []
        with self._glock:
            for idx, g, r in zip(indices, batch["group"], rewards):
                gid, member, G = g
                buf = self._reward_groups.setdefault(gid, [])
                buf.append((member, idx, r))
                if len(buf) == G:
                    buf.sort()
                    advs = np.asarray(grpo_advantages(
                        np.asarray([b[2] for b in buf], np.float32)))
                    writes += [(i, "advantage", float(a))
                               for (_, i, _), a in zip(buf, advs)]
                    del self._reward_groups[gid]
        out["writes"] = writes
        return out

    # ------------------------------------------------------------------ #
    # fused legacy protocol (AsyncRLRunner / fused-vs-staged benchmark)   #
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def generate(self, params, prompts: List[dict], rng) -> List[dict]:
        """Fused: generation + reference + reward + advantage in one call.
        prompts: [{"tokens": np.ndarray, "answer": int, ...}] ->
        one row per (prompt x G) sample."""
        rows = self._sample_rows(params, prompts, rng)
        ref_lps = self._ref_logprobs([r["response"] for r in rows]) \
            if self.ref_params is not None else None
        G = self.group_size
        for gi in range(0, len(rows), G):
            group = rows[gi:gi + G]
            rewards = np.asarray([self.reward_fn(r["answer"],
                                                 r["response_ids"])
                                  for r in group], np.float32)
            advs = np.asarray(grpo_advantages(rewards))
            for j, (r, rew, a) in enumerate(zip(group, rewards, advs)):
                r["reward"] = float(rew)
                r["advantage"] = float(a)
                if ref_lps is not None:
                    r["ref_logprob"] = ref_lps[gi + j]
        return rows

    # -- partial rollout (paper §4.2.1 / k1.5) ------------------------------

    def _advance_chunks(self, params, items: List[dict], rng, *,
                        version: int = 0, emit=None):
        """items: fresh prompt dicts or continuation dicts (``_cont``).
        Advances every sequence by at most ``chunk_tokens`` tokens.
        Returns (finished_members, continuations); with ``emit`` every
        finished member is delivered through the callback instead and the
        returned finished list is empty."""
        if self.backend == "continuous":
            return self._advance_chunks_cb(params, items, version=version,
                                           emit=emit)
        C = self.chunk_tokens or self.max_new_tokens
        seqs = []
        for it in items:
            if it.get("_cont"):
                seqs.append(it)
            else:  # fresh prompt -> spawn G group members
                gid = self._new_gid()
                for m in range(self.group_size):
                    seqs.append({"_cont": True, "gid": gid, "member": m,
                                 "prompt": it,
                                 "tokens": np.asarray(it["tokens"]),
                                 "logprobs": np.zeros(len(it["tokens"]),
                                                      np.float32),
                                 "gen_len": 0, "versions": []})
        if not seqs:
            return [], []

        seed = int(rng.integers(0, 2**31 - 1))
        outs = sample_generate(params, self.cfg,
                               [s["tokens"] for s in seqs], seed,
                               max_new_tokens=C,
                               temperature=self.temperature,
                               device=self.device)
        finished_members, continuations = [], []
        from repro_torch.data.tokenizer import ByteTokenizer
        eos = ByteTokenizer.eos_id
        for s, o in zip(seqs, outs):
            start = len(s["tokens"])
            new_toks = np.asarray(o["tokens"][start:start + C])
            new_lps = np.asarray(o["logprobs"][start:start + C])
            # truncate at EOS within the chunk
            hits = np.where(new_toks == eos)[0]
            n_new = int(hits[0]) + 1 if len(hits) else len(new_toks)
            s = dict(s)
            s["tokens"] = np.concatenate([s["tokens"], new_toks[:n_new]])
            s["logprobs"] = np.concatenate([s["logprobs"], new_lps[:n_new]])
            s["gen_len"] += n_new
            s["versions"] = s["versions"] + [version]
            done = len(hits) > 0 or s["gen_len"] >= self.max_new_tokens
            if done:
                finished_members.append(s)
            else:
                continuations.append(s)
        if emit is not None:
            for s in finished_members:
                emit(s)
            finished_members = []
        return finished_members, continuations

    def _member_row(self, s: dict, *, chunked: bool = True) -> dict:
        """Finished chunked member -> staged experience row."""
        p = s["prompt"]
        plen = len(np.asarray(p["tokens"]))
        toks = np.asarray(s["tokens"])
        mask = np.zeros(len(toks), np.float32)
        mask[plen:] = 1.0
        row = dict(prompt=p, response=toks, logprob=s["logprobs"],
                   response_mask=mask, response_ids=toks[plen:],
                   group=(s["gid"], s["member"], self.group_size),
                   answer=p["answer"], token_len=int(s["gen_len"]))
        if chunked:
            row["chunk_versions"] = s["versions"]
        return row

    @torch.no_grad()
    def generate_chunked(self, params, items: List[dict], rng, *,
                         version: int = 0):
        """Fused chunked path: group advantages are emitted only once every
        member of a group has finished. Returns (rows, continuations)."""
        finished, conts = self._advance_chunks(params, items, rng,
                                               version=version)
        return self._emit_finished_groups(finished), conts

    def _emit_finished_groups(self, members: List[dict]) -> List[dict]:
        """Buffer finished members per group; once all G are in, compute
        group advantages and emit experience rows."""
        complete = []
        with self._glock:
            for s in members:
                buf = self._groups.setdefault(s["gid"], [])
                buf.append(s)
                if len(buf) == self.group_size:
                    complete.append(self._groups.pop(s["gid"]))
        rows = []
        for group in complete:
            p = group[0]["prompt"]
            plen = len(np.asarray(p["tokens"]))
            rewards = np.asarray(
                [self.reward_fn(p["answer"], s["tokens"][plen:])
                 for s in group], np.float32)
            advs = np.asarray(grpo_advantages(rewards))
            for s, r, a in zip(group, rewards, advs):
                mask = np.zeros(len(s["tokens"]), np.float32)
                mask[plen:] = 1.0
                rows.append(dict(
                    prompt=p, response=s["tokens"], logprob=s["logprobs"],
                    response_mask=mask, reward=float(r), advantage=float(a),
                    token_len=int(s["gen_len"]),
                    chunk_versions=s["versions"]))
        return rows
