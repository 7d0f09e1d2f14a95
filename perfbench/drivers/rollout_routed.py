"""Entry the window drives for a model with routed experts: the port's
``ContinuousBatchingEngine.generate`` under ``rollout.py``'s closed loop
(the same set-up, ramp, window, traced stretch and recorded engine), the
engine keeping the picks of held experts its forwards made
(``record_picks``).

What differs is the comparison that decides ``correct``. In bf16 a
rounding between the served path and any reference flips a pick of a
held expert at a near tie in a few percent of (token, layer) pairs, and
a flipped pick moves the token's logprob by up to a few nats: the widest
gap over every compared token then reads as high as the fp8 control's.
So the sampled requests are compared twice, each against the reference
(``perfbench/reference/moe.py``) routed as the engine routed them:

- ``logprob_gap``: the widest gap between a served token's logprob and
  the reference's, routed as the engine routed: the arithmetic apart
  from the routing;
- ``pick_gap``: the share of the routed (position, MoE layer) pairs of
  the sampled requests whose held experts the reference's own gate,
  given the same history, would pick otherwise: the routing itself.
"""
from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np

from perfbench.core import compare, profiling, registry
from perfbench.core import traffic as traffic_mod
from perfbench.core.spec import load_module
from perfbench.core.weights import make
from perfbench.reference import lm
from perfbench.reference import moe as ref
from perfbench.reference.precision import Precision

rollout = load_module("drivers", "rollout")


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
    loop = rollout.Loop(c, mix, prompts, seconds, trace, reg)
    eng = rollout._engine_class(spans)(
        ModelConfig(**c), num_slots=e["num_slots"], page_size=e["page_size"],
        max_len=e["max_len"], max_new_tokens=traffic_mod.max_new(mix),
        temperature=mix["temperature"], seed=seed, device=device,
        feeder=lambda _: None, record_picks=True)
    rollout._warm(eng, params, prompts)
    if loop.prof is not None:
        profiling.warm_profiler()
    eng.feeder = loop
    finished: Dict[int, float] = {}
    try:
        eng.generate(params, loop.first(eng), emit=lambda q:
                     finished.setdefault(q.uid, time.monotonic()))
    except rollout.WindowClosed:
        pass
    if loop.t1 is None:
        raise RuntimeError("the engine ran out of requests before the "
                           "window closed")
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = loop.t1 - loop.t0
    n_tok, gaps, model_flops = rollout.window_tokens(loop, eng)
    trace_obj = loop.prof.trace(spans.items) if loop.prof else None
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    ctx = {"cell": cell, "window_s": window_s,
           "delta": registry.delta(loop.reg0, loop.reg1),
           "model_flops": model_flops, "trace": trace_obj,
           "decode_rounds": eng.rounds,
           "decode_shape": (e["num_slots"], eng.max_len, H, KV, hd, 2,
                            c["num_layers"])}
    e2e = {"gen_tokens_per_s": n_tok / window_s,
           "token_gap_p95_ms": rollout.p95(gaps) * 1e3,
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
               loop.requests[u]["seq"].logprobs, eng.picks_of(u))
              for u in pick]
    del eng, loop, params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = routed_checks(cell, c, seed, sample, device,
                                   Precision("bf16"),
                                   float(mix["temperature"]))
    if not done:
        checks["requests_checked"] = {"value": 0.0, "limit": -1.0}
    return {"e2e": e2e, "ctx": ctx, "peak": peak, "trace": trace_obj,
            "checks": checks, "attempted": attempted, "failed": failed,
            "followed": {"sample": sample}}


def routed(params, c, prec, tokens, start: int, temperature, picks):
    """(the reference's logprobs (float32, host) of ``tokens[start:]``
    routed as ``picks`` (positions, MoE layers, k) say; how many of those
    (position, layer) pairs its own gate would send to other held
    experts)."""
    import torch
    dev = params["embed"]["table"].device
    t = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
    given = torch.as_tensor(picks, device=dev).long()
    own = []
    with torch.no_grad():
        logits = ref.forward(params, t, c, prec, picks=given, own=own)
    lp = torch.log_softmax(logits[0, start - 1:-1] / temperature, dim=-1)
    lp = lp.gather(1, t[0, start:, None])[:, 0].cpu().numpy()
    mine = torch.stack(own, 1)[:given.shape[0]]
    differ = (torch.sort(mine, -1).values
              != torch.sort(given, -1).values).any(-1)
    return lp, int(differ.sum())


def routed_checks(cell, c, seed, sample, device, prec, temperature):
    """The widest logprob gap over the sampled requests and the share of
    their (position, MoE layer) pairs whose picks the reference's gate
    changes, each request routed as the engine routed it; and how many
    requests fail: those over the logprob limit, or all of them where the
    share is over its own."""
    params = make(lm.layout(c), seed, device)
    lim = cell.limits
    worst, changed, pairs, over = 0.0, 0, 0, 0
    for tokens, P, lps, picks in sample:
        lp, n = routed(params, c, prec, tokens, P, temperature, picks)
        g = compare.max_abs_gap([(np.asarray(lps[P:], np.float32), lp)])
        worst = max(worst, g)
        over += int(not g <= lim["logprob_gap"])
        changed, pairs = changed + n, pairs + picks.shape[0] * picks.shape[1]
    del params
    share = changed / max(pairs, 1)
    failed = len(sample) if not share <= lim["pick_gap"] else over
    return {"logprob_gap": {"value": worst, "limit": lim["logprob_gap"]},
            "pick_gap": {"value": share, "limit": lim["pick_gap"]}}, failed


def readings(cell, res, seed, device) -> dict:
    """The readings the limits are set from (``perfbench/limits.py``): the
    program's; the control's (the reference at fp8 in the program's
    place: its logprobs and its own picks, read by the same comparison);
    a token altered where it is produced (its logprob routed as the
    engine routed the positions before it)."""
    import torch
    c, mix = cell.config["port"], cell.traffic
    temperature = float(mix["temperature"])
    sample = res["followed"]["sample"]
    out = {"program": {k: v["value"] for k, v in res["checks"].items()}}
    params = make(lm.layout(c), seed, device)
    ctl = []
    for tokens, P, _, _ in sample:
        t = torch.as_tensor(tokens, dtype=torch.long,
                            device=params["embed"]["table"].device)[None]
        own = []
        with torch.no_grad():
            logits = ref.forward(params, t, c, Precision("fp8"), own=own)
        lp = torch.log_softmax(logits[0, P - 1:-1] / temperature, dim=-1)
        lp = lp.gather(1, t[0, P:, None])[:, 0].cpu().tolist()
        ctl.append((tokens, P, [0.0] * P + lp,
                    torch.stack(own, 1)[:len(tokens) - 1].cpu().numpy()))
    worst = 0.0
    for tokens, P, lps, picks in sample:
        tokens = np.asarray(tokens, np.int64).copy()
        pos = P + (len(tokens) - P) // 2
        tokens[pos] = (tokens[pos] + 1) % c["vocab_size"]
        alt, _ = routed(params, c, Precision("bf16"), tokens[:pos + 1], pos,
                        temperature, picks[:pos])
        worst = max(worst, abs(float(alt[0]) - float(lps[pos])))
    del params
    out["control"] = {k: v["value"] for k, v in routed_checks(
        cell, c, seed, ctl, device, Precision("bf16"), temperature)[0].items()}
    out["token_altered"] = {"logprob_gap": worst}
    return out
