#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package ``src/repro``. Phases, each of
which raises on failure:

1. setup: the card's name and power limit, TF32 off, the kernels built
   from ``src/repro_torch/csrc`` (build seconds printed);
2. each attention kernel against its plain PyTorch version at the serving
   path's shapes, in bf16 and fp32, with its time beside the plain
   version's, ``F.scaled_dot_product_attention``'s (timed as a yardstick
   only; the port never calls it) and the card's bound;
3. the continuous-batching engine serving full-width Qwen2.5-7B (all 28
   layers, vocab 152,064, random weights from a seed): 16 requests,
   4 slots, 32 new tokens each; the launch counts of both kernels over
   this run;
4. the fixed engine (``rl.sampling.generate``) at the same width;
5. teacher-forced consistency: a full forward (flash kernel) over finished
   sequences reproduces the logprobs their decode steps (decode kernel)
   recorded, in bf16 and in an fp32 run;
6. a ``torch.profiler`` trace of a short serving run: device time by
   kernel and the device's idle share; then the serving weights are freed;
7. the training path's kernels (``grpo_logprob``, ``fused_rl_loss``
   forward and backward) against their plain versions at vocab 152,064
   (4096 rows, and the trainer's micro-batch of 4 x 79 rows) and at the
   byte vocab 259 (rows off the 16-byte grid), bf16 and fp32, timed beside
   the plain versions, a one-call ``torch.log_softmax``/``torch.softmax``
   yardstick and the card's bound;
8. one GRPO micro-batch of full-width Qwen2.5-7B cut to 2 layers, through
   the kernels and through the plain loss, in bf16 and fp32 compute: loss,
   stats and every parameter's gradient agree, and the attention weights
   get a gradient;
9. ``Trainer.fit`` at that width, async, KL on, continuous rollout: 3
   steps of 16 samples, the launch counts of all five kernels over the
   run, wall, samples/s, weight-sync quantiles, peak memory, stage busy
   shares;
10. a ``torch.profiler`` trace of one actor update (forward, loss,
    backward, AdamW): device time by kernel and the device's idle share;
11. a JSON line per kernel and, last, the device line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# fused_rl_loss backward: relative to each element of dx, plus 1e-5 of its
# terms where they cancel (fused_rl_loss_bwd_tolerance)
DX_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}
# Teacher-forced logprob agreement. fp32: the decode and prefill paths
# differ only in summation order, so they agree within 1e-3 nats. bf16: the
# paths round at different places (8-bit mantissa, residual stream in bf16
# over 28 layers), so the decode path is held to the accuracy of the bf16
# prefill path itself: its distance from an fp32 forward over the same
# tokens may be at most BF16_TF_FACTOR times the bf16 forward's distance.
FP32_TF_TOL = 1e-3
BF16_TF_FACTOR = 2.0
L2_BYTES = 50 * 2 ** 20
SEQ_LEN_MAX = 2048         # longest byte prompt
TRAIN_LAYERS = 2           # depth of the training phases (width is full)
TRAIN_ROWS = 4 * 79        # a trainer micro-batch: 4 rows of seq_len 80
MAX_NEW = 32
NUM_SLOTS = 4
TEMPERATURE = 0.8
SEED = 0                   # weights, prompts and sampling keys


def _import_port():
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch is missing; run "
                         "this script from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    return torch


def _time_ms(torch, fn, arg_sets, iters):
    """Mean ms per call by CUDA events, cycling through ``arg_sets`` (sized
    to exceed L2, so each call finds its inputs cold as on the main path),
    after as many untimed calls to bring the clocks up."""
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _copies(torch, tensors):
    """Enough copies of ``tensors`` to exceed twice the L2 cache."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, math.ceil(2 * L2_BYTES / nbytes))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(min(n, 16) - 1)]


def _bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name, dtype, shape, out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    ok = bool(((out.float() - ref.float()).abs()
               <= tol + tol * ref.float().abs()).all().item())
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{name} {dtype} {shape}: kernel disagrees with "
                             f"its plain version (max abs err {err})")
    return err


def phase_kernels(torch, max_len, timed):
    """Kernel vs plain version; returns {name: row} for the timed shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    H, KVH, hd = 28, 4, 128
    rows, out = [], {}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for B, S, ragged in ((4, max_len, False), (4, 4099, True)):
            q, k, v = (randn((B, 1, H, hd), dt), randn((B, S, KVH, hd), dt),
                       randn((B, S, KVH, hd), dt))
            lo = 0 if ragged else 1        # ragged: one row with no key
            fill = torch.randint(lo, S + 1, (B,), generator=gen, device=dev)
            fill[0] = lo
            valid = torch.arange(S, device=dev)[None, :] < fill[:, None]
            err = _check("decode_attention", dtype, (B, S),
                         decode_attention(q, k, v, valid),
                         decode_attention_ref(q, k, v, valid))
            sets = _copies(torch, (q, k, v, valid))
            nbytes = sum(t.numel() * t.element_size()
                         for t in (q, k, v, valid, q))
            bound, by = _bound(nbytes, 4 * B * H * S * hd, dtype)
            row = dict(
                kernel="decode_attention", dtype=dtype, B=B, S=S,
                max_abs_err=err,
                ms=_time_ms(torch, decode_attention, sets, 50),
                plain_ms=_time_ms(torch, decode_attention_ref, sets, 10),
                library_ms=_time_ms(
                    torch, lambda q, k, v, m: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=m[:, None, None, :],
                        enable_gqa=True), sets, 50),
                bound_ms=bound, bound_by=by)
            rows.append(row)
            if (dtype, B, S) == timed["decode_attention"]:
                out["decode_attention"] = row

        for B, S, window in ((4, 8, 0), (4, 8, 256), (4, 1000, 0),
                             (4, 1000, 256), (4, 2048, 0), (4, 2048, 256),
                             (1, SEQ_LEN_MAX, 0)):
            q, k, v = (randn((B, S, H, hd), dt), randn((B, S, KVH, hd), dt),
                       randn((B, S, KVH, hd), dt))
            err = _check("flash_attention", dtype, (B, S, window),
                         flash_attention(q, k, v, window=window),
                         flash_attention_ref(q, k, v, window=window))
            sets = _copies(torch, (q, k, v))
            qpos = torch.arange(S, device=dev)[:, None]
            kpos = torch.arange(S, device=dev)[None, :]
            band = kpos <= qpos
            if window > 0:
                band &= kpos > qpos - window
            pairs = int(band.sum().item())
            nbytes = 2 * q.numel() * q.element_size() \
                + 2 * k.numel() * k.element_size()
            bound, by = _bound(nbytes, 4 * B * H * hd * pairs, dtype)
            row = dict(
                kernel="flash_attention", dtype=dtype, B=B, S=S,
                window=window, max_abs_err=err,
                ms=_time_ms(torch, lambda q, k, v: flash_attention(
                    q, k, v, window=window), sets, 10),
                plain_ms=_time_ms(torch, lambda q, k, v: flash_attention_ref(
                    q, k, v, window=window), sets, 3),
                library_ms=_time_ms(
                    torch, lambda q, k, v: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=band,
                        enable_gqa=True), sets, 10),
                bound_ms=bound, bound_by=by)
            rows.append(row)
            if (dtype, B, S, window) == timed["flash_attention"]:
                out["flash_attention"] = row
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    print("kernel_vs_plain_launches", json.dumps({
        "decode_attention": decode_attention.launches,
        "flash_attention": flash_attention.launches}))
    return out


def make_prompts(seed):
    """8 PromptDataset prompts, then 8 byte prompts of 256-2048 tokens;
    only the last reaches 2048, so it is prefilled alone (B=1, S=2048)."""
    import numpy as np

    from repro_torch.data import PromptDataset
    from repro_torch.data.tokenizer import BOS, N_SPECIALS
    prompts = [p["tokens"] for p in PromptDataset(seed=seed)
               .prompts_for_step(0, 8)]
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(256, SEQ_LEN_MAX - 8, size=7)) + [SEQ_LEN_MAX]
    for n in lens:
        body = rng.integers(N_SPECIALS, 256 + N_SPECIALS, size=int(n) - 1)
        prompts.append(np.concatenate([[BOS], body]).astype(np.int32))
    return prompts


def _forward_logprobs(torch, params, cfg, q):
    """Logprobs of ``q``'s response tokens under one full forward."""
    from repro_torch.models import forward
    dev = params["embed"]["table"].device
    toks = torch.tensor(q.tokens, device=dev)[None]
    with torch.no_grad():
        logits, _ = forward(params, cfg, {"tokens": toks})
    logp = torch.log_softmax(logits[0].float() / TEMPERATURE, dim=-1)
    t = torch.arange(q.prompt_len, len(q.tokens), device=dev)
    return logp[t - 1, toks[0, t]]


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _recorded(torch, seqs):
    return [torch.tensor(q.logprobs[q.prompt_len:], device="cuda")
            for q in seqs]


def profile_serving(torch, params, cfg, prompts, max_len):
    """Trace 4 long prompts (prefill + 8 decode rounds) and print device
    time by kernel name, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max_len, max_new_tokens=9,
        temperature=TEMPERATURE, seed=SEED, metrics=MetricsRegistry())
    seqs = [eng.make_sequence(p) for p in prompts[8:12]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.generate(params, seqs)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    # device-side kernel events only: an aten op's device time repeats its
    # kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(json.dumps({"phase": "profile", "wall_us": wall_us,
                      "kernel_names": len(events),
                      "device_busy_us": busy_us,
                      "device_idle_share": 1 - busy_us / wall_us}))
    for e in events[:15]:
        print("profile_kernel", json.dumps({
            "name": e.key[:90], "calls": e.count,
            "device_us": e.self_device_time_total,
            "share": e.self_device_time_total / busy_us}))
    # host side: self CPU time of the ops and runtime calls the profiler
    # sees (it adds its own cost to each); the rest of the wall is Python
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({"phase": "profile_host", "wall_us": wall_us,
                      "ops_self_cpu_us": sum(e.self_cpu_time_total
                                             for e in host)}))
    for e in host[:10]:
        print("profile_host_op", json.dumps({
            "name": e.key[:60], "calls": e.count,
            "self_cpu_us": e.self_cpu_time_total}))


def _loss_inputs(torch, gen, N, V, dt):
    """Logits and the (N,) vectors of one loss call; old and ref logprobs
    sit near the logits' own logprobs, as on the training path, so the
    ratios and the KL are of order one."""
    from repro_torch.kernels.grpo_logprob import grpo_logprob_ref
    dev = torch.device("cuda")
    x = (4 * torch.randn((N, V), generator=gen, device=dev)).to(dt)
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    lp = grpo_logprob_ref(x, t)[0]
    old = lp + 0.3 * torch.randn(N, generator=gen, device=dev)
    ref = lp + 0.1 * torch.randn(N, generator=gen, device=dev)
    adv = torch.randn(N, generator=gen, device=dev)
    dlp = torch.randn(N, generator=gen, device=dev)
    g_ent = torch.randn(N, generator=gen, device=dev)
    return x, t, old, ref, adv, dlp, g_ent


def _check_dx(dtype, shape, x, t, stats, dx):
    """dx of the backward kernel against its plain version, each element
    within its own limit; returns (max abs err, max err/limit)."""
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_bwd_tolerance)
    want = fused_rl_loss_bwd_ref(x, t, *stats)
    limit = fused_rl_loss_bwd_tolerance(x, t, *stats, want, DX_RTOL[dtype])
    err = (dx.float() - want.float()).abs()
    worst = (err / limit).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"fused_rl_loss_bwd {dtype} {shape}: dx "
                             f"disagrees with its plain version ({worst} "
                             f"times the limit)")
    return err.max().item(), worst


def phase_loss_kernels(torch, timed):
    """The three vocab-streaming kernels against their plain versions;
    returns {name: row} at the ``timed`` (dtype, N, V)."""
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_fwd,
                                                   fused_rl_loss_fwd_ref)
    from repro_torch.kernels.grpo_logprob import (grpo_logprob,
                                                  grpo_logprob_ref)
    V = 152_064
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, out = [], {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for N, VV in ((4096, V), (TRAIN_ROWS, V), (7, 259)):
            x, t, old, ref, adv, dlp, g_ent = _loss_inputs(torch, gen, N, VV,
                                                           dt)
            e = x.element_size()
            lp, ent = grpo_logprob(x, t)
            err_lp = max(_check("grpo_logprob", "float32", (N, VV), o, r)
                         for o, r in zip((lp, ent), grpo_logprob_ref(x, t)))
            fo = fused_rl_loss_fwd(x, t, old, ref, adv)
            err_f = max(_check("fused_rl_loss_fwd", "float32", (N, VV), o, r)
                        for o, r in zip(fo, fused_rl_loss_fwd_ref(
                            x, t, old, ref, adv)))
            lse, xbar = fo[5], fo[5] - fo[1]
            err_b, dx_share = _check_dx(
                dtype, (N, VV), x, t, (lse, xbar, dlp, g_ent),
                fused_rl_loss_bwd(x, t, lse, xbar, dlp, g_ent))
            sets = _copies(torch, (x, t, old, ref, adv, lse, xbar, dlp,
                                   g_ent))
            nv = N * VV
            cases = {
                "grpo_logprob": (
                    err_lp, lambda x, t, *r: grpo_logprob(x, t),
                    lambda x, t, *r: grpo_logprob_ref(x, t),
                    lambda x, *r: torch.log_softmax(x, dim=-1),
                    nv * e + 8 * N + 8 * N, 4 * nv),
                "fused_rl_loss_fwd": (
                    err_f, lambda x, t, o, r, a, *_: fused_rl_loss_fwd(
                        x, t, o, r, a),
                    lambda x, t, o, r, a, *_: fused_rl_loss_fwd_ref(
                        x, t, o, r, a),
                    lambda x, *r: torch.log_softmax(x, dim=-1),
                    nv * e + 8 * N + 12 * N + 24 * N, 4 * nv),
                "fused_rl_loss_bwd": (
                    err_b, lambda x, t, o, r, a, l, xb, d, g:
                    fused_rl_loss_bwd(x, t, l, xb, d, g),
                    lambda x, t, o, r, a, l, xb, d, g:
                    fused_rl_loss_bwd_ref(x, t, l, xb, d, g),
                    lambda x, *r: torch.softmax(x, dim=-1),
                    2 * nv * e + 8 * N + 16 * N, 6 * nv)}
            for name, (err, fn, plain, lib, nbytes, ops) in cases.items():
                # fp32 arithmetic on the CUDA cores whatever the input type
                bound, by = _bound(nbytes, ops, "float32")
                row = dict(kernel=name, dtype=dtype, N=N, V=VV,
                           max_abs_err=err,
                           **({"max_err_over_limit": dx_share}
                              if name == "fused_rl_loss_bwd" else {}),
                           ms=_time_ms(torch, fn, sets, 20),
                           plain_ms=_time_ms(torch, plain, sets, 5),
                           library_ms=_time_ms(torch, lib, sets, 20),
                           bound_ms=bound, bound_by=by)
                rows.append(row)
                if (dtype, N, VV) == timed:
                    out[name] = row
            del x, t, old, ref, adv, dlp, g_ent, sets, fo, lp, ent
            torch.cuda.empty_cache()
    for row in rows:
        print("kernel_vs_plain", json.dumps(row))
    return out


def _train_rows(cfg, n, seed, seq_len=80, prompt_len=16):
    """``n`` synthetic experience rows of ``seq_len`` tokens, as the
    TransferQueue hands them to the train stage."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mask = np.r_[np.zeros(prompt_len), np.ones(seq_len - prompt_len)]
    return {
        "response": [rng.integers(3, cfg.vocab_size, seq_len)
                     for _ in range(n)],
        "logprob": [(-12.0 + 0.3 * rng.standard_normal(seq_len))
                    .astype(np.float32) for _ in range(n)],
        "ref_logprob": [(-12.0 + 0.3 * rng.standard_normal(seq_len))
                        .astype(np.float32) for _ in range(n)],
        "response_mask": [mask.astype(np.float32)] * n,
        "advantage": [float(a) for a in rng.standard_normal(n)],
    }


def _plain_fused_rl_loss(logits, targets, old, ref, adv, *, clip_eps=0.2):
    """``fused_rl_loss`` through the unfused plain oracle (autograd)."""
    from repro_torch.kernels.fused_rl_loss import fused_rl_loss_oracle
    shape, V = targets.shape, logits.shape[-1]
    outs = fused_rl_loss_oracle(
        logits.reshape(-1, V), targets.reshape(-1), old.reshape(-1),
        ref.reshape(-1), adv.reshape(-1), clip_eps=clip_eps)
    return tuple(o.reshape(shape) for o in outs)


def phase_microbatch(torch, cfg2):
    """One GRPO micro-batch (4 x 80 tokens) at full width, 2 layers: the
    kernels' loss against the plain loss on the same params and batch."""
    import dataclasses

    from repro_torch.engines import pack_rows
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
    from repro_torch.models import init_params
    from repro_torch.rl import loss as loss_mod
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    params = init_params(SEED, cfg2)
    batch = pack_rows(_train_rows(cfg2, 4, SEED), 80)
    rl = GRPOConfig(kl_coef=0.05)
    tol = {"bfloat16": 2e-2, "float32": 1e-4}
    report = {"phase": "microbatch", "layers": cfg2.num_layers}
    for compute, gtol in tol.items():
        c = dataclasses.replace(cfg2, compute_dtype=compute)
        n = fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches
        torch.cuda.synchronize()
        t0 = time.monotonic()
        g_k, m_k = grpo_grad_step(params, c, rl, batch)
        torch.cuda.synchronize()
        t_k = time.monotonic() - t0
        if (fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches) != \
                (n[0] + 1, n[1] + 1):
            raise AssertionError("the micro-batch missed the loss kernels")
        inner = loss_mod.fused_rl_loss
        loss_mod.fused_rl_loss = _plain_fused_rl_loss
        try:
            t0 = time.monotonic()
            g_p, m_p = grpo_grad_step(params, c, rl, batch)
            torch.cuda.synchronize()
            t_p = time.monotonic() - t0
        finally:
            loss_mod.fused_rl_loss = inner
        stats = {k: (float(m_k[k]), float(m_p[k])) for k in m_k}
        for k, (a, b) in stats.items():
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * (1 + abs(b))):
                raise AssertionError(f"micro-batch {compute} {k}: kernel "
                                     f"{a} vs plain {b}")
        rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)))
        if not rel <= gtol:
            raise AssertionError(f"micro-batch {compute}: gradients differ "
                                 f"by {rel} relative (limit {gtol})")
        attn = {w: float(g_k["blocks"]["attn"][w]["w"].abs().max())
                for w in ("wq", "wk", "wv")}
        if min(attn.values()) <= 0.0:
            raise AssertionError(f"attention weights got no gradient: {attn}")
        report[compute] = {"stats_kernel_plain": stats,
                           "max_grad_rel_frobenius": rel, "limit": gtol,
                           "attn_grad_max": attn, "grad_step_s": t_k,
                           "plain_grad_step_s": t_p}
        del g_k, g_p
    print(json.dumps(report))
    del params
    torch.cuda.empty_cache()


def _counters():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
    from repro_torch.kernels.grpo_logprob import grpo_logprob
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "grpo_logprob": grpo_logprob,
            "fused_rl_loss_fwd": fused_rl_loss_fwd,
            "fused_rl_loss_bwd": fused_rl_loss_bwd}


def phase_trainer(torch, cfg2, smi):
    """``Trainer.fit`` on the card; returns (trainer, launches).

    lr 1e-6, a GRPO post-training rate for 7B models: at the CPU-scale
    default 3e-4, AdamW's first, sign-like steps on the KL term's
    near-zero gradients move every logit by about a nat per step, and the
    KL of random weights runs away within three steps."""
    from repro_torch.api import Trainer, TrainerConfig
    tcfg = TrainerConfig(
        mode="async", num_steps=3, prompts_per_step=4, group_size=4,
        rollout_workers=2, rollout_batch=2, train_micro_batch=4,
        max_new_tokens=64, seq_len=80, kl_coef=0.05, lr=1e-6,
        rollout_backend="continuous", staleness=1, seed=SEED)
    trainer = Trainer(tcfg, model_cfg=cfg2)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = trainer.fit()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {n: c.launches for n, c in counters.items()}
    n = tcfg.num_steps * tcfg.prompts_per_step * tcfg.group_size
    steps = [m for m in res.metrics if "grad_norm" in m]
    if res.samples_trained != n or len(steps) != tcfg.num_steps:
        raise AssertionError(f"trainer: {res.samples_trained} samples, "
                             f"{len(steps)} steps")
    for m in steps:
        for k in ("loss", "grad_norm", "policy_loss", "entropy",
                  "ratio_mean"):
            if not math.isfinite(m[k]):
                raise AssertionError(f"trainer: {k} not finite: {m}")
    if max(res.staleness_seen) > tcfg.staleness + 1:
        raise AssertionError(f"staleness {max(res.staleness_seen)}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran in training: {launches}")
    tel = res.telemetry
    sync = [v for v in tel["metrics"].get("weight_sync_seconds",
                                          {}).get("values", [])]
    print(json.dumps({
        "phase": "trainer", "card": smi, "layers": cfg2.num_layers,
        "steps": len(steps), "samples": res.samples_trained,
        "wall_s": wall, "samples_per_s": res.samples_trained / wall,
        "max_staleness": max(res.staleness_seen), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "weight_sync_seconds": sync, "stages": tel["stages"],
        "instances": tel["instances"], "metrics": steps}))
    return trainer, launches


def profile_actor_update(torch, trainer):
    """Trace one actor update (a micro-batch of 4 x 80 tokens through
    forward, loss and backward, then AdamW) on the trainer's engine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = trainer.train_engine
    eng.global_batch = 4
    rows = _train_rows(trainer.cfg, 4, SEED + 1)
    eng.update_actor(rows)                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = eng.update_actor(rows)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    if not out or not math.isfinite(out["loss"]):
        raise AssertionError(f"actor update: {out}")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(json.dumps({"phase": "profile_actor_update", "wall_us": wall_us,
                      "kernel_names": len(events),
                      "device_busy_us": busy_us,
                      "device_idle_share": 1 - busy_us / wall_us}))
    for e in events[:15]:
        print("profile_kernel", json.dumps({
            "name": e.key[:90], "calls": e.count,
            "device_us": e.self_device_time_total,
            "share": e.self_device_time_total / busy_us}))


def main():
    torch = _import_port()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import count_params, init_params
    from repro_torch.rl import generate

    # -- 1. setup ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.build_all()
    print(f"kernel build seconds {_build.build_seconds:.3f}")

    cfg = get_config("qwen2_5_7b")
    prompts = make_prompts(SEED)
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(
        cfg, num_slots=NUM_SLOTS, max_len=max(len(p) for p in prompts)
        + MAX_NEW, max_new_tokens=MAX_NEW, temperature=TEMPERATURE,
        seed=SEED, metrics=reg)
    max_len = eng.max_len                 # the decode window, page-rounded

    # -- 2. kernels vs plain versions --------------------------------------
    timed = {"decode_attention": ("bfloat16", NUM_SLOTS, max_len),
             "flash_attention": ("bfloat16", 1, SEQ_LEN_MAX, 0)}
    krows = phase_kernels(torch, max_len, timed)
    torch.cuda.empty_cache()

    # -- 3. continuous engine, full-width Qwen2.5-7B -----------------------
    t0 = time.monotonic()
    params = init_params(SEED, cfg)
    torch.cuda.synchronize()
    print(f"qwen2_5_7b: {cfg.num_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab_size} params={count_params(params)} "
          f"({cfg.param_dtype}, compute {cfg.compute_dtype}) "
          f"init {time.monotonic() - t0:.3f}s")
    seqs = [eng.make_sequence(p) for p in prompts]
    decode_attention.launches = flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    done, paused = eng.generate(params, seqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    n_new = sum(q.gen_len for q in done)
    if len(done) != len(seqs) or paused:
        raise AssertionError(f"{len(done)}/{len(seqs)} requests finished")
    for q in done:
        if max(q.tokens) >= cfg.vocab_size or min(q.tokens) < 0:
            raise AssertionError(f"uid {q.uid}: token id out of range")
        lps = q.logprobs[q.prompt_len:]
        if not all(math.isfinite(x) and x <= 0.0 for x in lps):
            raise AssertionError(f"uid {q.uid}: bad logprobs {lps[:4]}")
    if eng.pool.pages_in_use:
        raise AssertionError(f"{eng.pool.pages_in_use} KV pages leaked")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    snap = reg.snapshot()
    pre = snap["rollout_prefill_seconds"]["values"][0]
    dec = snap["rollout_decode_step_seconds"]["values"][0]
    print(json.dumps({
        "phase": "continuous_engine", "requests": len(done),
        "new_tokens": n_new, "wall_s": wall, "tokens_per_s": n_new / wall,
        "card": smi, "launches": launches,
        "prefill_dispatches": pre["count"], "prefill_s_sum": pre["sum"],
        "decode_steps": dec["count"], "decode_step_s_p50": dec["p50"],
        "decode_s_sum": dec["sum"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))

    # -- 4. fixed engine ---------------------------------------------------
    decode_attention.launches = 0
    t0 = time.monotonic()
    rows = generate(params, cfg, prompts[:4], SEED,
                    max_new_tokens=16, temperature=TEMPERATURE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_fixed = sum(len(r["response_ids"]) for r in rows)
    for r in rows:
        lp = r["logprobs"][r["prompt_len"]:]
        if not (r["tokens"] < cfg.vocab_size).all() or \
                not all(math.isfinite(x) and x <= 0.0 for x in lp):
            raise AssertionError("fixed engine: bad tokens or logprobs")
    if decode_attention.launches == 0:
        raise AssertionError("fixed engine never launched decode_attention")
    print(json.dumps({"phase": "fixed_engine", "requests": len(rows),
                      "new_tokens": n_fixed, "wall_s": wall,
                      "tokens_per_s": n_fixed / wall, "card": smi,
                      "decode_attention_launches":
                          decode_attention.launches}))

    # -- 5. teacher-forced consistency -------------------------------------
    by_uid = sorted(done, key=lambda q: q.uid)
    pair = [by_uid[0], by_uid[-1]]               # a short and the longest
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fwd16 = [_forward_logprobs(torch, params, cfg, q) for q in pair]
    fwd32 = [_forward_logprobs(torch, params, cfg32, q) for q in pair]
    rec16 = _recorded(torch, pair)
    tf = {"bf16_decode_vs_bf16_forward": _max_diff(rec16, fwd16),
          "bf16_decode_vs_fp32_forward": _max_diff(rec16, fwd32),
          "bf16_forward_vs_fp32_forward": _max_diff(fwd16, fwd32)}
    eng32 = ContinuousBatchingEngine(
        cfg32, num_slots=2, max_len=max_len,
        max_new_tokens=8, temperature=TEMPERATURE, seed=SEED,
        dtype=torch.float32, metrics=MetricsRegistry())
    done32, _ = eng32.generate(params, [eng32.make_sequence(prompts[0]),
                                        eng32.make_sequence(prompts[9])])
    tf["fp32_decode_vs_fp32_forward"] = _max_diff(
        _recorded(torch, done32),
        [_forward_logprobs(torch, params, cfg32, q) for q in done32])
    bf16_tol = BF16_TF_FACTOR * tf["bf16_forward_vs_fp32_forward"]
    print(json.dumps({"phase": "teacher_forced", "max_abs_logprob_diff": tf,
                      "tolerance": {"fp32_decode_vs_fp32_forward":
                                    FP32_TF_TOL,
                                    "bf16_decode_vs_fp32_forward":
                                    bf16_tol}}))
    if not tf["fp32_decode_vs_fp32_forward"] <= FP32_TF_TOL:
        raise AssertionError(f"teacher-forced fp32 logprobs differ: {tf}")
    if not tf["bf16_decode_vs_fp32_forward"] <= bf16_tol:
        raise AssertionError(f"bf16 decode logprobs are further from fp32 "
                             f"than the bf16 prefill path allows: {tf}")

    # -- 6. where the device time goes ---------------------------------------
    profile_serving(torch, params, cfg, prompts, max_len)
    del params, eng, eng32, done, done32, seqs, by_uid, pair
    torch.cuda.empty_cache()

    # -- 7. the training path's kernels vs plain versions ---------------------
    krows.update(phase_loss_kernels(torch, ("bfloat16", TRAIN_ROWS,
                                            cfg.vocab_size)))

    # -- 8. one GRPO micro-batch at full width --------------------------------
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    phase_microbatch(torch, cfg2)

    # -- 9. the trainer -----------------------------------------------------
    trainer, train_launches = phase_trainer(torch, cfg2, smi)
    for name in ("grpo_logprob", "fused_rl_loss_fwd", "fused_rl_loss_bwd"):
        launches[name] = train_launches[name]

    # -- 10. where an actor update's device time goes ------------------------
    profile_actor_update(torch, trainer)

    # -- 11. output -----------------------------------------------------------
    sources = {
        "decode_attention":
            "src/repro/kernels/decode_attention/decode_attention.py:72",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:94",
        "grpo_logprob": "src/repro/kernels/grpo_logprob/grpo_logprob.py:84",
        "fused_rl_loss_fwd":
            "src/repro/kernels/fused_rl_loss/fused_rl_loss.py:145",
        "fused_rl_loss_bwd":
            "src/repro/kernels/fused_rl_loss/fused_rl_loss.py:178"}
    files = {"fused_rl_loss_fwd": "fused_rl_loss",
             "fused_rl_loss_bwd": "fused_rl_loss"}
    kernels = []
    for name, row in krows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{files.get(name, name)}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
