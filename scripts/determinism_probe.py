#!/usr/bin/env python3
"""Where a GRPO run on the card stops being bit-identical.

    python3 scripts/determinism_probe.py [--device cpu] [--resume] [--before]
    python3 scripts/determinism_probe.py [--device cpu] --cost
    python3 scripts/determinism_probe.py [--device cpu] --gather-cost

Runs the shape of chip_smoke.py phase 10d (Qwen2.5-7B at full width cut
to one layer, GRPO with KL 0.05, baseline mode, 4 steps x 16 samples of
32 new tokens; ``--device cpu`` takes the reduced config instead, for a
rehearsal) and prints one JSON line per check:

- ``grads_twice``: the gradients of one micro-batch (16 rows of 48 tokens)
  computed twice from the same params and batch, compared leaf by leaf,
  byte for byte (three pairs), once with the embedding's plain gather
  (autograd's ``index_put_`` backward) and once with the shipped one
  (``models/layers.py``, ``_Gather``: sort and segment sum);
- ``grads_row_order``: the same micro-batch with its rows in another
  order: the gradients are sums over rows, so this shows whether the
  order the trainer receives its rows in reaches the bits;
- ``embedding_backward``: the embedding gather's backward alone over the
  micro-batch's tokens, ten calls of each gather, and the shipped one's
  largest difference from the plain one's;
- ``ref_batching``: the reference logprobs of the same 16 rows computed
  in one batch, in batches of 4 and a row at a time (what the reference
  stage's timing-dependent batches give it), compared row by row, once
  as the stage computed them before (each batch in one forward, padded to
  its longest row) and once as shipped (calls of one fixed shape);
- ``runs``: ``Trainer.fit`` twice uninterrupted, then a third time with
  the reference and reward stages slowed by a seeded 0-30 ms a call (and
  with ``--resume`` a 2-step run with snapshots and a resume to step 4),
  each with a record of every reference-stage batch (its size and each
  row's output digest) and every actor call (its rows' order and content
  digests, the gradients' checksums, the metrics); then the first record
  where each run parts from the first. ``--before`` repeats the three
  runs with the reference stage's batched forward and the trainer's
  ready-order rows put back, as the code was before it was made
  deterministic.

``--cost`` instead times chip_smoke.py's three trainers (phases 9, 16 and
23) with the reference stage's calls as they were and as shipped, in
turns. ``--gather-cost`` instead times the GRPO actor update at
chip_smoke.py's training depth (two layers), the embedding's backward
alone and a no-grad ``embed`` call's host time, with the plain gather and
the shipped one in turns, and repeats the embedding-backward check at the
update's tokens.

Needs one CUDA card (unless ``--device cpu``) and ``nvcc``; snapshots go
to ``build/probe_snapshots/`` and are removed after.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def _digest(a) -> str:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(np.asarray(a)).tobytes()
                        ).hexdigest()[:12]


def _checksum(t: torch.Tensor):
    """Two integer sums over a leaf's bit patterns, in chunks on its own
    device: equal leaves give equal sums."""
    bits = t.detach().reshape(-1).view(torch.int32)
    s1 = s2 = 0
    for c in bits.split(1 << 26):
        s1 += int(torch.sum(c, dtype=torch.int64))
        s2 += int(torch.sum(torch.remainder(c, 65521), dtype=torch.int64))
    return [s1, s2]


def _leaf_diffs(ga, gb):
    """{leaf: (differing elements, max abs diff)} of two gradient trees."""
    from chip_smoke import _flat
    fa, fb = _flat("", ga), _flat("", gb)
    out = {}
    for k in fa:
        a, b = fa[k], fb[k]
        if not torch.equal(a, b):
            d = (a.float() - b.float()).abs()
            out[k] = [int((d > 0).sum()), float(d.max())]
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _plain_embed(p, tokens, compute_dtype=torch.bfloat16):
    """The gather as it was before ``layers._Gather``: autograd's own
    backward (``index_put_`` with accumulate)."""
    return p["table"][tokens].to(compute_dtype)


def check_grads(cfg, dev):
    from repro_torch.engines import pack_rows
    from repro_torch.models import init_params, transformer
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    params = init_params(chip_smoke.SEED, cfg, device=dev)
    seq = 16 + chip_smoke.DURABLE_NEW
    rows = chip_smoke._train_rows(cfg, 16, chip_smoke.SEED, seq_len=seq)
    batch = pack_rows(rows, seq, dev)
    rl = GRPOConfig(kl_coef=0.05)
    shipped = transformer.embed
    for gather, fn in (("plain", _plain_embed), ("sorted", shipped)):
        transformer.embed = fn
        try:
            pairs = []
            for _ in range(3):
                g1, _ = grpo_grad_step(params, cfg, rl, batch)
                g2, _ = grpo_grad_step(params, cfg, rl, batch)
                _sync(dev)
                pairs.append(_leaf_diffs(g1, g2))
                del g2
        finally:
            transformer.embed = shipped
        print(json.dumps({"check": "grads_twice", "gather": gather,
                          "pairs": pairs,
                          "identical": all(not p for p in pairs)}))
    perm = np.random.default_rng(1).permutation(16)
    prow = {k: [v[i] for i in perm] for k, v in rows.items()}
    g3, _ = grpo_grad_step(params, cfg, rl, pack_rows(prow, seq, dev))
    _sync(dev)
    diff = _leaf_diffs(g1, g3)
    print(json.dumps({"check": "grads_row_order", "leaves_differing": diff,
                      "identical": not diff}))
    del g1, g3

    check_embedding_backward(dev, params["embed"]["table"],
                             batch["tokens"])
    return params, rows


def check_embedding_backward(dev, table, tokens, calls=10):
    """The embedding gather's backward alone over ``tokens``: ``calls``
    calls of the plain gather and of the shipped one, whether each is
    bit-identical across its calls, and the shipped one's largest
    difference from the plain one's."""
    from repro_torch.models import layers
    up = torch.randn(*tokens.shape, table.shape[1], device=dev,
                     generator=torch.Generator(dev).manual_seed(2))
    report = {"check": "embedding_backward", "calls": calls,
              "table": list(table.shape), "tokens": list(tokens.shape),
              "distinct_ids": int(torch.unique(tokens).numel()),
              "threads": torch.get_num_threads()}
    for gather, fn in (("plain", lambda t: t[tokens]),
                       ("sorted", lambda t: layers._Gather.apply(t, tokens))):
        first, same, differing = None, True, []
        for _ in range(calls):
            t = table.detach().requires_grad_()
            (g,) = torch.autograd.grad(fn(t), t, up)
            if first is None:
                first = g
            else:
                n = int((g != first).sum())
                same &= n == 0
                differing.append(n)
            del g
        _sync(dev)
        report[gather] = {"identical": same,
                          "elements_differing_from_first": differing}
        if gather == "plain":
            plain = first
        else:
            report["sorted_vs_plain_max_rel"] = float(
                (first - plain).abs().max() / plain.abs().max())
        del first
    print(json.dumps(report))


def _median(xs):
    return float(np.median(np.asarray(xs)))


def check_gather_cost(cfg, dev, iters=10):
    """What the embedding's sorted backward costs: the GRPO actor update
    of chip_smoke.py's phase 10 (a micro-batch of 4 x 80 tokens through
    forward, loss, backward and AdamW on ``cfg``) with the plain gather
    and the shipped one in turns (plain, sorted, sorted, plain), ``iters``
    updates a turn, each update's time from CUDA events on the card (the
    host's clock on the CPU), and the median of each turn; then the
    gather's backward alone at the update's tokens (median of 20 calls a
    turn, the same turns); then the host time of one ``embed`` call
    without grad, as a decode step makes it (4 tokens, 2000 calls a turn,
    the device synchronised at the end of each turn); and the
    embedding-backward check at the update's tokens."""
    from repro_torch.engines import TrainEngine, pack_rows
    from repro_torch.models import init_params, layers, transformer
    from repro_torch.rl.grpo import GRPOConfig
    from repro_torch.training.optimizer import OptimizerConfig
    params = init_params(chip_smoke.SEED, cfg, device=dev)
    eng = TrainEngine(cfg, params, rl=GRPOConfig(kl_coef=0.05),
                      opt=OptimizerConfig(lr=1e-6, warmup_steps=2),
                      global_batch=4, seq_len=80)
    del params
    rows = chip_smoke._train_rows(cfg, 4, chip_smoke.SEED + 1)
    shipped = transformer.embed
    ways = {"plain": _plain_embed, "sorted": shipped}
    turns = ("plain", "sorted", "sorted", "plain")

    def timed(fn, n):
        out = []
        for _ in range(n):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                out.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    report = {"check": "gather_cost", "model": cfg.name,
              "layers": cfg.num_layers, "iters": iters, "update_ms": [],
              "backward_ms": [], "embed_host_us": []}
    for way in turns:
        transformer.embed = ways[way]
        try:
            eng.update_actor(rows)                           # warm
            ms = timed(lambda: eng.update_actor(rows), iters)
        finally:
            transformer.embed = shipped
        report["update_ms"].append({"gather": way, "median": _median(ms),
                                    "all": ms})
    tokens = pack_rows(rows, 80, dev)["tokens"]
    table = eng.state.params["embed"]["table"]
    up = torch.randn(*tokens.shape, table.shape[1], device=dev,
                     generator=torch.Generator(dev).manual_seed(3))
    fwd = {"plain": lambda t: t[tokens],
           "sorted": lambda t: layers._Gather.apply(t, tokens)}

    def backward(way):
        t = table.detach().requires_grad_()
        torch.autograd.grad(fwd[way](t), t, up)
    for way in turns:
        backward(way)                                        # warm
        ms = timed(lambda: backward(way), 20)
        report["backward_ms"].append({"gather": way, "median": _median(ms)})
    p = {"table": table}
    tok = tokens[:, :1].contiguous()
    with torch.no_grad():
        for way in turns:
            fn = ways[way]
            fn(p, tok)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(2000):
                fn(p, tok)
            _sync(dev)
            report["embed_host_us"].append(
                {"gather": way,
                 "per_call": (time.perf_counter() - t0) / 2000 * 1e6})
    print(json.dumps(report))
    check_embedding_backward(dev, table, tokens)


def check_ref_batching(cfg, dev, params, rows):
    from repro_torch.engines import RolloutEngine
    seq = 16 + chip_smoke.DURABLE_NEW
    eng = RolloutEngine(cfg, group_size=4, max_new_tokens=32,
                        ref_params=params, backend="continuous",
                        ref_rows=16, ref_len=seq, device=dev)
    resp = rows["response"]
    ways = {"one_batch": [resp],
            "batches_of_4": [resp[i:i + 4] for i in range(0, 16, 4)],
            "row_at_a_time": [[r] for r in resp]}
    report = {"check": "ref_batching"}
    for variant, fn in (("before", lambda b: _batched_ref_logprobs(eng, b)),
                        ("shipped", eng._ref_logprobs)):
        got = {name: [lp for b in batches for lp in fn(b)]
               for name, batches in ways.items()}
        base = got.pop("one_batch")
        for name, lps in got.items():
            diff = [i for i in range(16) if not np.array_equal(base[i],
                                                               lps[i])]
            report[f"{variant}_{name}"] = {
                "rows_differing": diff,
                "max_abs_diff": float(max(
                    (np.abs(base[i] - lps[i]).max() for i in diff),
                    default=0.0))}
    print(json.dumps(report))


class Recorder:
    """Class-level wrappers of the reference stage's and the actor's verbs
    that log what each call saw and produced."""

    def __init__(self):
        from repro_torch.engines import RolloutEngine, TrainEngine
        self.log = []
        self._orig = (RolloutEngine.compute_log_prob, TrainEngine._consume,
                      TrainEngine._grad)
        rec = self

        def compute_log_prob(eng, batch, **kw):
            out = rec._orig[0](eng, batch, **kw)
            rec.log.append({"kind": "ref", "n": len(batch["response"]),
                            "rows": [[_digest(r), _digest(lp)] for r, lp in
                                     zip(batch["response"],
                                         out["updates"]["ref_logprob"])]})
            return out

        def consume(eng, batch):
            rec.log.append({"kind": "actor_in", "rows": [
                [_digest(batch["response"][i]),
                 _digest(batch["logprob"][i]),
                 _digest(batch.get("ref_logprob", [0] * (i + 1))[i]),
                 repr(float(batch["advantage"][i]))]
                for i in range(len(batch["response"]))]})
            out = rec._orig[1](eng, batch)
            rec.log.append({"kind": "actor_out", "metrics": out})
            return out

        def grad(eng, jb):
            g, m = rec._orig[2](eng, jb)
            from chip_smoke import _flat
            rec.log.append({"kind": "grads", "sums": {
                k: _checksum(v) for k, v in _flat("", g).items()},
                "metrics": {k: repr(float(v)) for k, v in m.items()}})
            return g, m

        RolloutEngine.compute_log_prob = compute_log_prob
        TrainEngine._consume = consume
        TrainEngine._grad = grad

    def undo(self):
        from repro_torch.engines import RolloutEngine, TrainEngine
        (RolloutEngine.compute_log_prob, TrainEngine._consume,
         TrainEngine._grad) = self._orig


def _parting(a, b):
    """The first record where two logs differ, and what differs."""
    ref_a = {row[0]: row[1] for r in a if r["kind"] == "ref"
             for row in r["rows"]}
    ref_b = {row[0]: row[1] for r in b if r["kind"] == "ref"
             for row in r["rows"]}
    out = {"ref_batch_sizes": [[r["n"] for r in a if r["kind"] == "ref"],
                               [r["n"] for r in b if r["kind"] == "ref"]],
           "ref_rows_differing": sum(1 for k in ref_a
                                     if k in ref_b and ref_a[k] != ref_b[k])}
    actor = lambda log: [r for r in log if r["kind"] != "ref"]
    for i, (x, y) in enumerate(zip(actor(a), actor(b))):
        if x != y:
            what = {"record": i, "kind": x["kind"]}
            if x["kind"] == "actor_in":
                what["same_rows_other_order"] = (
                    sorted(map(tuple, x["rows"]))
                    == sorted(map(tuple, y["rows"])))
                what["same_row_set"] = (sorted(r[0] for r in x["rows"])
                                        == sorted(r[0] for r in y["rows"]))
            elif x["kind"] == "grads":
                what["leaves_differing"] = [k for k in x["sums"]
                                            if x["sums"][k] != y["sums"][k]]
            out["first_parting"] = what
            break
    else:
        out["first_parting"] = None
    return out


@torch.no_grad()
def _batched_ref_logprobs(eng, responses, params=None):
    """``RolloutEngine._ref_logprobs`` as it was: the stage's whole batch,
    padded to its longest row, in one forward."""
    from repro_torch.models import forward
    from repro_torch.rl.loss import token_logprobs
    params = eng.ref_params if params is None else params
    arrs = [np.asarray(t) for t in responses]
    S = max(len(a) for a in arrs)
    toks = np.zeros((len(arrs), S), np.int64)
    for i, a in enumerate(arrs):
        toks[i, :len(a)] = a
    toks = torch.from_numpy(toks).to(eng.device)
    logits, _ = forward(params, eng.cfg, {"tokens": toks})
    lp, _ = token_logprobs(logits[:, :-1], toks[:, 1:])
    lp = lp.cpu().numpy()
    return [np.concatenate([[0.0], lp[i, :len(a) - 1]]).astype(np.float32)
            for i, a in enumerate(arrs)]


def _patch(cls, name, value):
    old = cls.__dict__[name]
    setattr(cls, name, value)
    return lambda: setattr(cls, name, old)


def check_runs(cfg, dev, variant, resume):
    """Two runs and a third whose reference and reward stages sleep 0-30
    ms a call (a seeded draw), which moves the reference stage's batches
    and the order the trainer's rows become ready; ``variant`` "before"
    puts back the batched reference inference and the ready-order rows."""
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.core.obs import get_registry
    from repro_torch.core.workflow import StageRunner
    from repro_torch.engines import RolloutEngine
    kw = dict(mode="baseline", prompts_per_step=4, group_size=4,
              rollout_workers=1, rollout_batch=4, train_micro_batch=16,
              max_new_tokens=chip_smoke.DURABLE_NEW,
              seq_len=16 + chip_smoke.DURABLE_NEW, kl_coef=0.05, lr=1e-6,
              rollout_backend="continuous", seed=chip_smoke.SEED,
              checkpoint_keep_last=1, device=dev.type)
    keys = ("loss", "policy_loss", "grad_norm", "mean_reward", "entropy")
    undo = []
    if variant == "before":
        undo.append(_patch(RolloutEngine, "_ref_logprobs",
                           _batched_ref_logprobs))
        undo.append(_patch(StageRunner, "_in_row_order",
                           staticmethod(lambda idxs, batch: (idxs, batch))))

    def fit(steps, resume=None, jitter=False, **more):
        get_registry().clear()
        rec = Recorder()
        undo_j = []
        if jitter:
            rng = np.random.default_rng(7)
            for name in ("compute_log_prob", "compute_rewards"):
                inner = RolloutEngine.__dict__[name]

                def slow(eng, *a, _inner=inner, **k):
                    time.sleep(float(rng.uniform(0.0, 0.03)))
                    return _inner(eng, *a, **k)
                undo_j.append(_patch(RolloutEngine, name, slow))
        try:
            tr = Trainer(TrainerConfig(num_steps=steps, **kw, **more),
                         model_cfg=cfg)
            t0 = time.monotonic()
            res = tr.fit(resume=resume)
            wall = time.monotonic() - t0
        finally:
            for u in undo_j:
                u()
            rec.undo()
        del tr
        if dev.type == "cuda":
            chip_smoke._release(torch)
        return res, rec.log, wall

    def same(a, b):
        return all(x[k] == y[k] for x, y in zip(a.metrics, b.metrics)
                   for k in keys)

    try:
        runs = [fit(chip_smoke.DURABLE_STEPS),
                fit(chip_smoke.DURABLE_STEPS),
                fit(chip_smoke.DURABLE_STEPS, jitter=True)]
        first, log0, _ = runs[0]
        report = {"check": "runs", "variant": variant,
                  "walls_s": [w for _, _, w in runs]}
        for i, (res, log, _) in enumerate(runs[1:], 1):
            report["run1_vs_run0" if i == 1 else "jittered_vs_run0"] = {
                "metrics_identical": same(first, res),
                "max_rel_diff": max(
                    abs(x[k] - y[k]) / max(abs(x[k]), 1e-30)
                    for x, y in zip(first.metrics, res.metrics)
                    for k in keys),
                **_parting(log0, log)}
        if resume:
            directory = ROOT / "build" / "probe_snapshots"
            shutil.rmtree(directory, ignore_errors=True)
            try:
                fit(chip_smoke.DURABLE_STEPS // 2,
                    checkpoint_dir=str(directory),
                    checkpoint_interval_steps=0)
                res, log, _ = fit(chip_smoke.DURABLE_STEPS, resume="auto",
                                  checkpoint_dir=str(directory),
                                  checkpoint_interval_steps=0)
            finally:
                shutil.rmtree(directory, ignore_errors=True)
            # the resumed run's log covers the second half only: compare
            # its actor records with the first run's second half
            half = chip_smoke.DURABLE_STEPS // 2
            tail0 = [r for r in log0 if r["kind"] != "ref"]
            per_step = len(tail0) // chip_smoke.DURABLE_STEPS
            log_tail = [r for r in log0 if r["kind"] == "ref"] + \
                tail0[half * per_step:]
            report["resumed_vs_run0"] = {"metrics_identical": same(first,
                                                                    res),
                                         **_parting(log_tail, log)}
    finally:
        for u in undo:
            u()
    report["metrics"] = [{k: m[k] for k in keys} for m in first.metrics]
    print(json.dumps(report))


def check_cost(dev):
    """What the reference stage's fixed call shape costs a trainer:
    chip_smoke.py's trainers (phases 9, 16 and 23: async, KL 0.05, 3
    steps x 16 samples of 64 new tokens) with the stage's batch in one
    forward padded to its longest row as before, and in calls of one
    shape as shipped, in turns (before, shipped, shipped, before); each
    run's samples/s and the reference stage's busy seconds."""
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.configs import get_config
    from repro_torch.core.obs import get_registry
    from repro_torch.engines import RolloutEngine
    for arch, layers, backend in (
            ("qwen2_5_7b", chip_smoke.TRAIN_LAYERS, "continuous"),
            ("falcon_mamba_7b", chip_smoke.SSM_TRAIN_LAYERS, "fixed"),
            ("recurrentgemma_9b", chip_smoke.HYB_TRAIN_LAYERS, "fixed")):
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg if dev.type == "cuda" else
                                  cfg.reduced(), num_layers=layers)
        runs = []
        for variant in ("before", "shipped", "shipped", "before"):
            undo = _patch(RolloutEngine, "_ref_logprobs",
                          _batched_ref_logprobs) \
                if variant == "before" else (lambda: None)
            try:
                get_registry().clear()
                tr = Trainer(TrainerConfig(
                    mode="async", num_steps=3, prompts_per_step=4,
                    group_size=4, rollout_workers=2, rollout_batch=2,
                    train_micro_batch=4, max_new_tokens=64, seq_len=80,
                    kl_coef=0.05, lr=1e-6, rollout_backend=backend,
                    staleness=1, seed=chip_smoke.SEED, device=dev.type),
                    model_cfg=cfg)
                _sync(dev)
                t0 = time.monotonic()
                res = tr.fit()
                _sync(dev)
                wall = time.monotonic() - t0
            finally:
                undo()
            busy = {r["stage"]: r["busy_s"] for r in res.telemetry["stages"]}
            runs.append({"variant": variant, "wall_s": wall,
                         "samples_per_s": res.samples_trained / wall,
                         "ref_inference_busy_s": busy.get("ref_inference")})
            del tr, res
            if dev.type == "cuda":
                chip_smoke._release(torch)
        print(json.dumps({"check": "cost", "model": arch, "layers": layers,
                          "runs": runs}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--before", action="store_true",
                    help="also run the runs with the code as it was")
    ap.add_argument("--cost", action="store_true",
                    help="only time the three trainers with the reference "
                         "stage as it was and as shipped")
    ap.add_argument("--gather-cost", action="store_true",
                    help="only time the actor update and the embedding's "
                         "backward with the plain and the sorted gather")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    base = get_config("qwen2_5_7b")
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build
        _build.build_all()
        cfg = dataclasses.replace(base, num_layers=chip_smoke.DURABLE_LAYERS)
    else:
        cfg = dataclasses.replace(base.reduced(), num_layers=1)
    if args.cost:
        check_cost(dev)
        return 0
    if args.gather_cost:
        check_gather_cost(dataclasses.replace(
            cfg, num_layers=chip_smoke.TRAIN_LAYERS), dev)
        return 0
    params, rows = check_grads(cfg, dev)
    check_ref_batching(cfg, dev, params, rows)
    del params
    for variant in ("shipped", "before") if args.before else ("shipped",):
        check_runs(cfg, dev, variant, args.resume and variant == "shipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
