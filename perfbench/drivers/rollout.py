"""Entry the window drives: the port's ``ContinuousBatchingEngine.generate``
(what the continuous rollout backend and ``launch/serve.py`` call),
under a closed loop over its slot pool.

Set-up makes the weights, builds the engine, runs a few short requests
through it (the kernels build there), then ramps the pool up: every
``ramp_rounds_per_request`` decode rounds one more request is let in,
and a request that finishes is replaced at once, until every slot is
taken. The requests in the pool are then spread over their lifetimes, as
in a rollout worker whose responses end at many lengths. From then on the
loop keeps at least one pool's worth of requests waiting, a group at a
time (dispatched ahead, as a rollout worker does), for ``--seconds``
(with ``--trace 1``, then for the traced stretch); then the run leaves
the engine: the requests still running are not waited for. Each request
asks for the response length the mix drew for it. The benchmark's
subclass of the engine only records: each token's time, each request's
admission and, while the profiler runs, each decode round's valid keys.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from perfbench.core import compare, flops, profiling, registry
from perfbench.core import traffic as traffic_mod
from perfbench.core.weights import make
from perfbench.reference import lm
from perfbench.reference.precision import Precision


def _engine_class(spans):
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine

    class Recorded(ContinuousBatchingEngine):
        def __init__(self, *a, feeder=None, **kw):
            super().__init__(*a, **kw)
            self.feeder = feeder
            self.stamps: Dict[int, List[float]] = {}
            self.admitted: Dict[int, float] = {}
            self.rounds: List[list] = []      # valid keys of each slot
            self.record_rounds = False
            self._t_admit = 0.0

        def _admit_and_prefill(self, params):
            self._t_admit = time.monotonic()
            return super()._admit_and_prefill(params)

        def _prefill_bucket(self, params, group, pad_len):
            for _, q in group:
                self.admitted.setdefault(q.uid, self._t_admit)
            with spans.span("prefill"):
                return super()._prefill_bucket(params, group, pad_len)

        def _append_token(self, seq, tok, lp):
            super()._append_token(seq, tok, lp)
            self.stamps.setdefault(seq.uid, []).append(time.monotonic())

        def _decode_one_round(self, params, finished, paused, emit):
            if self.record_rounds:
                keys = [1] * self.num_slots          # idle slots: 1 key
                for s, q in self.scheduler.active():
                    if not (q.done or q.paused):
                        keys[s] = q.length
                self.rounds.append(keys)
            with spans.span("decode_round"):
                super()._decode_one_round(params, finished, paused, emit)
            with spans.span("feed"):
                self.feeder(self)

    return Recorded


class WindowClosed(Exception):
    """Raised by the loop between decode rounds once the window (and the
    traced stretch) has closed, to leave ``generate``."""


class Loop:
    """The closed loop: ramps the pool up, keeps it fed, opens and closes
    the window and the traced stretch between decode rounds."""

    def __init__(self, c, mix, prompts, seconds, trace, reg):
        self.c, self.mix, self.prompts, self.seconds = c, mix, prompts, \
            seconds
        self.reg = reg
        self.G = int(mix["group_size"])
        self.next_group = 0
        self.requests: Dict[int, dict] = {}
        self.rounds = 0
        self.ramping = True
        self.t0 = self.t1 = None
        self.reg0 = self.reg1 = None
        self.prof = profiling.Profiled() if trace else None
        self.stop_at = None
        self._block: List[dict] = []
        self._pending: list = []      # the ramp's group, not yet admitted

    def _prompt(self, k):
        b, i = divmod(k, self.prompts.block)
        if i == 0 or not self._block:
            self._block = self.prompts.make_block(b)
        return self._block[i]

    def make_group(self, eng):
        """The next prompt's group of requests, recorded, not admitted."""
        p = self._prompt(self.next_group)
        self.next_group += 1
        lens = p.get("new_tokens") or [traffic_mod.max_new(self.mix)] * self.G
        seqs = [eng.make_sequence(p["tokens"], max_new=int(n))
                for n in lens]
        for q in seqs:
            self.requests[q.uid] = {"prompt": p, "seq": q}
        return seqs

    @staticmethod
    def admit(eng, q):
        """Into the engine's queue, as ``generate`` admits its requests."""
        q.versions.append(0)
        eng.scheduler.admit(q)

    def first(self, eng):
        """The request ``generate`` is called with; its group's others
        wait in the ramp."""
        self._pending = self.make_group(eng)
        return [self._pending.pop(0)]

    def _admit_next(self, eng):
        if not self._pending:
            self._pending = self.make_group(eng)
        self.admit(eng, self._pending.pop(0))

    def __call__(self, eng):
        self.rounds += 1
        now = time.monotonic()
        if self.ramping:
            target = self.rounds // int(self.mix["ramp_rounds_per_request"])
            if target < eng.num_slots:
                while eng.scheduler.num_active + eng.scheduler.num_waiting \
                        < target:
                    self._admit_next(eng)
                return
            self.ramping = False
            self.reg0 = registry.read(self.reg)
            self.t0 = time.monotonic()
            self.stop_at = self.t0 + self.seconds
        if self.t1 is None and now >= self.stop_at:
            self.t1 = now
            self.reg1 = registry.read(self.reg)
            if self.prof is None:
                raise WindowClosed
            self.prof.start()
            self.stop_at = time.monotonic() + float(self.mix["trace_seconds"])
            eng.record_rounds = True
        elif self.t1 is not None and now >= self.stop_at:
            self.prof.stop()
            eng.record_rounds = False
            raise WindowClosed
        for q in self._pending:
            self.admit(eng, q)
        self._pending = []
        while eng.scheduler.num_waiting < eng.num_slots:
            for q in self.make_group(eng):
                self.admit(eng, q)


def _warm(eng, params, prompts):
    """A few short requests (the kernels build on the first), then the
    engine's queue is empty again."""
    block = prompts.make_block(0)
    seqs = [eng.make_sequence(p["tokens"], max_new=4) for p in block[:8]]
    eng.generate(params, seqs)


def window_tokens(loop, eng):
    """(tokens stamped in the window, gaps ending in it (s), FLOPs)."""
    t0, t1 = loop.t0, loop.t1
    n, gaps, fl = 0, [], 0.0
    c = loop.c
    for uid, r in loop.requests.items():
        st = eng.stamps.get(uid, [])
        if not st:
            continue
        P = r["seq"].prompt_len
        prev = eng.admitted[uid]
        for j, t in enumerate(st):
            if t0 <= t <= t1:
                n += 1
                gaps.append(t - prev)
                fl += (flops.forward_flops(c, P, flops.causal_keys(P), 1)
                       if j == 0 else flops.forward_flops(c, 1, P + j, 1))
            prev = t
    return n, gaps, fl


def p95(xs) -> float:
    xs = sorted(xs)
    return xs[max(0, int(np.ceil(0.95 * len(xs))) - 1)] if xs else np.nan


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_process: float) -> dict:
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.obs import get_registry

    c = cell.config["port"]
    mix = cell.traffic
    e = mix["engine"]
    reg = get_registry()
    reg.clear()
    params = make(lm.layout(c), seed, device)
    prompts = traffic_mod.Prompts(mix, seed, c["vocab_size"],
                                  int(mix["block"]))
    spans = profiling.Spans()
    loop = Loop(c, mix, prompts, seconds, trace, reg)
    eng = _engine_class(spans)(
        ModelConfig(**c), num_slots=e["num_slots"], page_size=e["page_size"],
        max_len=e["max_len"], max_new_tokens=traffic_mod.max_new(mix),
        temperature=mix["temperature"], seed=seed,
        device=device, feeder=lambda _: None)
    _warm(eng, params, prompts)
    if loop.prof is not None:
        profiling.warm_profiler()
    eng.feeder = loop
    finished: Dict[int, float] = {}
    try:
        eng.generate(params, loop.first(eng), emit=lambda q:
                     finished.setdefault(q.uid, time.monotonic()))
    except WindowClosed:
        pass
    if loop.t1 is None:
        raise RuntimeError("the engine ran out of requests before the "
                           "window closed")
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = loop.t1 - loop.t0
    n_tok, gaps, model_flops = window_tokens(loop, eng)
    trace_obj = loop.prof.trace(spans.items) if loop.prof else None
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    ctx = {"cell": cell, "window_s": window_s,
           "delta": registry.delta(loop.reg0, loop.reg1),
           "model_flops": model_flops, "trace": trace_obj,
           "decode_rounds": eng.rounds,
           "decode_shape": (e["num_slots"], eng.max_len, H, KV, hd, 2,
                            c["num_layers"])}
    e2e = {"gen_tokens_per_s": n_tok / window_s,
           "token_gap_p95_ms": p95(gaps) * 1e3,
           "setup_s": loop.t0 - t_process}

    # a sample of the requests finished in the window, the longest in it
    done = [u for u, t in finished.items()
            if loop.t0 <= t <= loop.t1 and u in loop.requests]
    attempted = len(done)
    rng = np.random.default_rng(traffic_mod.stream_seed(seed, "check"))
    done.sort(key=lambda u: (-len(loop.requests[u]["seq"].tokens), u))
    k = int(mix["check_requests"])
    pick = done[:1] + [done[i] for i in sorted(
        rng.choice(np.arange(1, len(done)), size=min(k - 1, len(done) - 1),
                   replace=False))] if done else []
    sample = [(loop.requests[u]["seq"].tokens,
               loop.requests[u]["seq"].prompt_len,
               loop.requests[u]["seq"].logprobs) for u in pick]
    del eng, loop, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = rollout_checks(cell, c, seed, sample, device,
                                    Precision("bf16"),
                                    float(mix["temperature"]))
    if not done:
        checks["requests_checked"] = {"value": 0.0, "limit": -1.0}
    return {"e2e": e2e, "ctx": ctx, "peak": peak, "trace": trace_obj,
            "checks": checks, "attempted": attempted, "failed": failed,
            "followed": {"sample": sample}}


def rollout_checks(cell, c, seed, sample, device, prec, temperature):
    """The widest gap between the program's logprob of a served token and
    the reference's, over the sampled requests; and how many of them
    read over the limit."""
    params = make(lm.layout(c), seed, device)
    limit = cell.limits["logprob_gap"]
    worst, failed = 0.0, 0
    for tokens, P, lps in sample:
        ref = lm.token_logprobs(params, c, prec, tokens, P, temperature)
        g = compare.max_abs_gap([(np.asarray(lps[P:], np.float32),
                                  ref.numpy())])
        worst = max(worst, g)
        failed += int(not g <= limit)
    del params
    return {"logprob_gap": {"value": worst, "limit": limit}}, failed


def readings(cell, res, seed, device) -> dict:
    """The readings the limits are set from (``perfbench/limits.py``):
    the program's; the control's (the reference at fp8 in the program's
    place, read against the reference at the stated precision); a token
    altered where it is produced."""
    c, mix = cell.config["port"], cell.traffic
    temperature = float(mix["temperature"])
    sample = res["followed"]["sample"]
    out = {"program": {k: v["value"] for k, v in res["checks"].items()}}
    params = make(lm.layout(c), seed, device)
    ctl = []
    for tokens, P, _ in sample:
        lp = lm.token_logprobs(params, c, Precision("fp8"), tokens, P,
                               temperature).numpy()
        ctl.append((tokens, P, [0.0] * P + lp.tolist()))
    del params
    out["control"] = {k: v["value"] for k, v in rollout_checks(
        cell, c, seed, ctl, device, Precision("bf16"), temperature)[0].items()}
    out["token_altered"] = {"logprob_gap": lm.altered_gap(
        c, seed, [(t, P, np.asarray(lps, np.float32))
                  for t, P, lps in sample], device, Precision("bf16"))}
    return out
