"""Entry the window drives: the port's ``Trainer`` and the ``StageRunner``
its ``fit`` builds (streamed GRPO: generate, reference inference, reward
and advantage, actor update, weight sync).

Set-up builds one Trainer with the benchmark's weights and prompts and
drives it through the mix's first ``warm_steps`` steps; those steps fill
the pipeline, warm every shape and give the readings the reference
follows. The window is the same run's next whole steps: it starts at the
end of step ``warm_steps``'s actor update and ends at the first step end
``--seconds`` or more later, where the run is stopped at that step
boundary. With ``--trace 1`` the profiler then records one more step.
The runner is built as ``Trainer.fit`` builds it, so that the benchmark
holds the runner's stop event; ``fit`` has no stop of its own.

Weight sync is judged at the rollout workers: each receiver's first swap
to a version the reference follows gives the change of its device
weights from the initial ones, leaf by leaf, which is compared with the
reference's change at the version the receiver claims.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import math
import threading
import time
from typing import Dict, List

import numpy as np

from perfbench.core import compare, flops, profiling, registry
from perfbench.core import traffic as traffic_mod
from perfbench.core.weights import leaf, make, tree_items
from perfbench.reference import grpo as ref_grpo
from perfbench.reference import lm
from perfbench.reference.precision import Precision


def _row(batch, k, seq_len, uid):
    toks = np.asarray(batch["response"][k], np.int64)[:seq_len]
    mask = np.asarray(batch["response_mask"][k], np.float32)[:seq_len]
    return {"uid": uid, "tokens": toks, "mask": mask,
            "prompt_len": int(np.argmax(mask > 0)),
            "version": int(batch["version"][k]),
            "logprob": np.asarray(batch["logprob"][k], np.float32)[:seq_len],
            "ref_logprob": np.asarray(batch["ref_logprob"][k],
                                      np.float32)[:seq_len]}


def _tokens(row) -> int:
    return row["prompt_len"] + int(row["mask"].sum())


class Recorder:
    """Wraps the actor's update verb: records every micro-batch's rows,
    takes the program's readings at the step boundaries of set-up, and
    opens and closes the window (and the traced step) at step ends."""

    def __init__(self, eng, *, seed, layout, warm, ref_steps, seconds,
                 trace, seq_len, beta1, device, registry):
        self.eng, self.orig = eng, eng.update_actor
        self.seed, self.layout, self.device = seed, layout, device
        self.warm, self.ref_steps, self.seconds = warm, ref_steps, seconds
        self.seq_len, self.beta1 = seq_len, beta1
        self.rows: List[dict] = []
        self.steps: Dict[int, List[List[dict]]] = {}
        self.step_rows: Dict[int, List[dict]] = {}
        self.loss: Dict[int, float] = {}
        self.grad_norm = None
        self.change_norm = None
        self.recv_change: Dict[int, tuple] = {}   # receiver: (version, norms)
        self.t_start = self.t_end = None
        self.reg_start = self.reg_end = None
        self.end_step = None
        self.prof = profiling.Profiled() if trace else None
        self.stop = None                 # the runner's stop event
        self.registry = registry

    def update_actor(self, batch, **kw):
        step = int(self.eng.state.step)          # the step this batch adds to
        out = self.orig(batch, **kw)
        base = len(self.rows)
        rows = [_row(batch, k, self.seq_len, base + k)
                for k in range(len(batch["response"]))]
        self.rows += rows
        self.step_rows.setdefault(step + 1, []).extend(rows)
        if step < self.ref_steps:
            self.steps.setdefault(step, []).append(rows)
        if out:
            self._step_end(step + 1, out)
        return out

    def _step_end(self, n, out):
        import torch
        self.loss[n] = float(out["loss"])
        if n == 1:
            m = self.eng.state.opt_state["m"]
            self.grad_norm = {p: float(torch.linalg.vector_norm(t))
                              / (1 - self.beta1) for p, t in tree_items(m)}
        if n == self.ref_steps:
            self.change_norm = self._change(self.eng.state.params)
        if n == self.warm:
            if self.prof is not None:
                profiling.warm_profiler()
            if self.device != "cpu":
                torch.cuda.synchronize()
            self.reg_start = registry.read(self.registry)
            self.t_start = time.monotonic()
            return
        if self.t_start is None:
            return
        now = time.monotonic()
        if self.end_step is None and now - self.t_start >= self.seconds:
            self.t_end, self.end_step = now, n
            self.reg_end = registry.read(self.registry)
            if self.prof is not None:
                self.prof.start()
                return
        if self.end_step is not None:
            if self.prof is not None and n == self.end_step + 1:
                self.prof.stop()
            self.stop.set()

    def _change(self, params):
        """Each leaf's norm of change from the initial weights, made
        again from the seed."""
        import torch
        tree = dict(tree_items(params))
        out = {}
        for path, shape, init in self.layout:
            p0 = leaf(path, shape, init, self.seed, self.device)
            out[path] = float(torch.linalg.vector_norm(p0.sub_(tree[path])))
            del p0
        return out

    def watch(self, receivers):
        """Wrap each receiver's swap: its first swap to a version the
        reference follows gives that receiver's reading."""
        for i, recv in enumerate(receivers):
            recv._swap = self._swapped(i, recv, recv._swap)

    def _swapped(self, i, recv, swap):
        @functools.wraps(swap)
        def call(vw):
            out = swap(vw)
            v = int(recv.version)
            if i not in self.recv_change and 1 <= v <= self.ref_steps:
                self.recv_change[i] = (v, self._change(recv.params))
            return out
        return call


def _check_program_settings(trainer, mix):
    """The reference works the optimizer and the loss from the mix's
    settings; refuse a run whose program would use others."""
    opt = trainer.train_engine.opt_cfg
    want = mix["optimizer"]
    got = {"betas": list(opt.betas), "eps": opt.eps,
           "weight_decay": opt.weight_decay, "grad_clip": opt.grad_clip,
           "warmup_steps": opt.warmup_steps, "schedule": opt.schedule,
           "lr": opt.lr}
    want = dict(want, betas=list(want["betas"]), lr=mix["trainer"]["lr"])
    rl = trainer.train_engine.rl
    if got != want or rl.clip_eps != mix["trainer"]["clip_eps"] \
            or rl.kl_coef != mix["trainer"]["kl_coef"] or rl.entropy_coef:
        raise RuntimeError(f"the program's optimizer {got} or loss {rl} "
                           f"differ from the mix's {want}")


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_process: float) -> dict:
    import torch
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.obs import get_registry
    from repro_torch.core.workflow import (StageRunner, WorkflowConfig,
                                           build_dataflow)

    c = cell.config["port"]
    mix = cell.traffic
    tr = mix["trainer"]
    layout = lm.layout(c)
    reg = get_registry()
    reg.clear()
    params = make(layout, seed, device)
    warm = int(mix["warm_steps"])
    tcfg = TrainerConfig(
        arch=c["name"], reduced=False, algorithm=tr["algorithm"],
        mode=tr["mode"], num_steps=warm + int(seconds) + 16,
        prompts_per_step=mix["prompts_per_step"],
        group_size=mix["group_size"], max_new_tokens=mix["new_tokens"],
        rollout_workers=tr["rollout_workers"],
        rollout_batch=tr["rollout_batch"],
        train_micro_batch=tr["train_micro_batch"],
        staleness=tr["staleness"], lr=tr["lr"],
        seed=seed % (2 ** 31), seq_len=tr["seq_len"],
        kl_coef=tr["kl_coef"],
        rollout_backend=cell.config["run"]["rollout_backend"],
        cb_slots=tr["cb_slots"],
        heartbeat_timeout_s=tr["heartbeat_timeout_s"], device=device)
    trainer = Trainer(tcfg, model_cfg=ModelConfig(**c), params=params)
    _check_program_settings(trainer, mix)

    prompts = traffic_mod.Prompts(mix, seed, c["vocab_size"],
                                  mix["prompts_per_step"])
    by_key: Dict[bytes, dict] = {}
    lock = threading.Lock()

    def prompt_stream(step):
        block = prompts.make_block(step)
        with lock:
            for p in block:
                by_key[np.asarray(p["tokens"], np.int64).tobytes()] = p
        return block

    spans = profiling.Spans()
    ro = trainer.rollout_engine
    ro.reward_fn = functools.partial(traffic_mod.reward, mix["reward"])
    ro.generate_sequences = spans.wrap("generate", ro.generate_sequences)
    ro.compute_log_prob = spans.wrap("ref_inference", ro.compute_log_prob)
    ro.compute_rewards = spans.wrap("reward", ro.compute_rewards)
    rec = Recorder(trainer.train_engine, seed=seed, layout=layout,
                   warm=warm, ref_steps=int(mix["reference_steps"]),
                   seconds=seconds, trace=trace, seq_len=tr["seq_len"],
                   beta1=mix["optimizer"]["betas"][0], device=device,
                   registry=reg)
    trainer.train_engine.update_actor = spans.wrap("update",
                                                   rec.update_actor)

    t = trainer.tcfg
    shared = {f.name: getattr(t, f.name)
              for f in dataclasses.fields(WorkflowConfig) if hasattr(t, f.name)}
    wcfg = WorkflowConfig(**shared, num_rollout_workers=t.rollout_workers)
    graph = build_dataflow(t.algorithm, kl_coef=t.kl_coef, gamma=t.gamma,
                           lam=t.gae_lambda)
    runner = StageRunner(wcfg, graph, engines=trainer.engines,
                         prompt_stream=prompt_stream)
    rec.stop = runner._stop
    runner.sender.publish = spans.wrap("publish", runner.sender.publish)
    for r in runner.receivers:
        r._swap = spans.wrap("swap", r._swap)
    rec.watch(runner.receivers)
    n_receivers = len(runner.receivers)
    runner.run()
    with runner._pool_lock:
        threads = list(runner._threads)
    for th in threads:
        th.join()
    if rec.end_step is None:
        raise RuntimeError("the run stopped before its window closed")
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the window's readings
    window_s = rec.t_end - rec.t_start
    win_rows = [r for n in range(warm + 1, rec.end_step + 1)
                for r in rec.step_rows[n]]
    tokens = sum(_tokens(r) for r in win_rows)
    model_flops = sum(flops.grpo_sample_flops(
        c, r["prompt_len"], int(r["mask"].sum())) for r in win_rows)
    trace_obj = rec.prof.trace(spans.items) if rec.prof else None
    ctx = {"cell": cell, "window_s": window_s, "samples": len(win_rows),
           "delta": registry.delta(rec.reg_start, rec.reg_end),
           "model_flops": model_flops, "trace": trace_obj,
           "loss_shape": (tr["train_micro_batch"] * (tr["seq_len"] - 1),
                          c["vocab_size"], 2)}
    e2e = {"train_tokens_per_s": tokens / window_s,
           "setup_s": rec.t_start - t_process}

    # free the program, then the reference follows the first steps
    steps = [rec.steps[s] for s in range(int(mix["reference_steps"]))]
    prog = {"loss": [rec.loss[s + 1] for s in range(len(steps))],
            "grad_norm": rec.grad_norm, "change_norm": rec.change_norm,
            "recv_change": [rec.recv_change.get(i)
                            for i in range(n_receivers)]}
    all_rows = list(rec.rows)
    del trainer, runner, params, ro, rec, prompt_stream
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = ref_grpo.follow(c, Precision("bf16"), seed, steps, all_rows,
                          by_key, mix, device)
    checks = grpo_checks(cell, steps, prog, ref)
    return {"e2e": e2e, "ctx": ctx, "peak": peak, "trace": trace_obj,
            "checks": checks, "attempted": len(win_rows),
            "failed": 0 if compare.judge(checks) else len(win_rows),
            "followed": {"steps": steps, "all_rows": all_rows,
                         "prompts": by_key, "reference": ref,
                         "program": prog}}


def lp_pairs(steps, ref, field, key):
    """(program, reference) logprobs over each recorded row's response
    tokens; index j of both is token j + 1."""
    for st in steps:
        for mb in st:
            for r in mb:
                resp = r["mask"][1:] > 0
                yield r[field][1:][resp], ref[key][r["uid"]][resp]


def receiver_gap(recv_change, ref_change, keep):
    """The worst receiver's change gap against the reference's at the
    version it claims; infinite where a receiver has no reading (it never
    swapped to a version the reference follows)."""
    worst, name = 0.0, ""
    for i, got in enumerate(recv_change):
        if got is None:
            return math.inf, f"receiver {i}: no swap"
        v, norms = got
        g, leaf_name = compare.norm_gap(norms, ref_change[v], keep)
        if not g < worst:
            worst, name = g, f"receiver {i} v{v} {leaf_name}"
    return worst, name


def grpo_checks(cell, steps, prog, ref) -> dict:
    """The numbers compared. The first gradient's per-leaf norms are not
    compared: on the card neither the control nor a fault reads 3 times
    their widest sound gap (``PERF.md``), so a limit could only fail
    sound runs; the reference's norms still decide which leaves the
    change comparisons keep."""
    lim = cell.limits
    keep = compare.moving_leaves(ref["grad_norm"])
    change, change_leaf = compare.norm_gap(
        prog["change_norm"], ref["change_norm"][len(steps)], keep)
    recv, recv_leaf = receiver_gap(prog["recv_change"], ref["change_norm"],
                                   keep)
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    return {
        "rollout_lp_gap": {"value": compare.max_abs_gap(
            lp_pairs(steps, ref, "logprob", "rollout_lp")),
            "limit": lim["rollout_lp_gap"]},
        "ref_lp_gap": {"value": compare.max_abs_gap(
            lp_pairs(steps, ref, "ref_logprob", "ref_lp")),
            "limit": lim["ref_lp_gap"]},
        "loss_gap": {"value": loss, "limit": lim["loss_gap"]},
        "change_gap": {"value": change, "limit": lim["change_gap"],
                       "leaf": change_leaf},
        "receiver_gap": {"value": recv, "limit": lim["receiver_gap"],
                         "leaf": recv_leaf},
    }


def readings(cell, res, seed, device) -> dict:
    """The readings the limits are set from (``perfbench/limits.py``):
    the program's; the reference put in its place at fp8 (the control)
    and with half of each micro-batch left out; a token altered where it
    is produced; receivers that never swap their weights, or swap in the
    version before the one they claim. A state left unchanged reads 1 on
    ``change_gap`` by its definition."""
    f = res["followed"]
    c, mix, ref, prog = cell.config["port"], cell.traffic, \
        f["reference"], f["program"]
    out = {"program": {k: v["value"] for k, v in res["checks"].items()}}

    def as_program(readings, steps):
        st = copy.deepcopy(steps)
        for s in st:
            for mb in s:
                for r in mb:
                    r["logprob"] = np.concatenate(
                        [[0.0], readings["rollout_lp"][r["uid"]]])
                    r["ref_logprob"] = np.concatenate(
                        [[0.0], readings["ref_lp"][r["uid"]]])
        recv = [None if got is None else
                (got[0], readings["change_norm"][got[0]])
                for got in prog["recv_change"]]
        return st, {"loss": readings["loss"],
                    "grad_norm": readings["grad_norm"],
                    "change_norm": readings["change_norm"][len(steps)],
                    "recv_change": recv}

    for name, prec, half in (("control", "fp8", False),
                             ("half_batch", "bf16", True)):
        got = ref_grpo.follow(c, Precision(prec), seed, f["steps"],
                              f["all_rows"], f["prompts"], mix, device,
                              drop_half=half)
        st, as_prog = as_program(got, f["steps"])
        out[name] = {k: v["value"] for k, v in
                     grpo_checks(cell, st, as_prog, ref).items()}
        del got
        gc.collect()
    rows = [(r["tokens"], r["prompt_len"],
             np.concatenate([[0.0], ref["rollout_lp"][r["uid"]]]))
            for r in f["steps"][0][0]]
    out["token_altered"] = {"rollout_lp_gap": lm.altered_gap(
        c, seed, rows, device, Precision("bf16"))}
    out["state_unchanged"] = {"change_gap": 1.0}
    keep = compare.moving_leaves(ref["grad_norm"])
    zero = {k: 0.0 for k in ref["change_norm"][1]}
    for name, held in (("receiver_not_swapped", lambda v: zero),
                       ("receiver_stale", lambda v: ref["change_norm"].get(
                           v - 1, zero))):
        recv = [None if got is None else (got[0], held(got[0]))
                for got in prog["recv_change"]]
        out[name] = {"receiver_gap": receiver_gap(
            recv, ref["change_norm"], keep)[0]}
    return out
