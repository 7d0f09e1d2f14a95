"""Profiling-based half of the hybrid cost model (paper §4.3).

On a real cluster this runs the actual training/inference blocks on the
candidate resource allocation and feeds measured block times back into the
planner. Here it times a *reduced* model on one device (``cuda`` unless the
caller passes another) and extrapolates analytically to the target config
and hardware — block-level timing shape (decode/update) is real, the
absolute scale comes from the FLOP/byte ratio between the reduced and
target configs.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.planner.cost_model import HW, forward_flops, kv_cache_bytes
from repro_torch.device import resolve_device


def _time_it(fn, *args, iters: int = 3, device=None) -> float:
    """Seconds a call: one call to warm up, then the mean of ``iters``,
    each waited for (``torch.cuda.synchronize`` on a CUDA device)."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        sync()
    return (time.perf_counter() - t0) / iters


def profile_reduced_blocks(cfg: ModelConfig, *, batch: int = 2,
                           seq: int = 32, device=None) -> Dict[str, float]:
    """Measure decode-token / train-microbatch wall times of the reduced
    model on ``device``, its params drawn from a generator seeded with 0.
    Returns raw seconds."""
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_train_step
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_state import TrainState

    dev = resolve_device(device)
    red = cfg.reduced()
    params = init_params(0, red, device=dev)

    cache = init_cache(red, batch, seq, device=dev)
    tok = torch.zeros((batch,), dtype=torch.int64, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
    with torch.no_grad():
        t_decode = _time_it(lambda: decode_step(params, red, cache, tok, pos),
                            device=dev)

    state = TrainState.create(params)
    b = {"tokens": torch.zeros((batch, seq), dtype=torch.int64, device=dev),
         "response_mask": torch.ones((batch, seq), device=dev),
         "old_logprob": torch.zeros((batch, seq), device=dev),
         "advantage": torch.ones((batch,), device=dev)}
    rl, oc = GRPOConfig(), OptimizerConfig()
    t_train = _time_it(lambda: grpo_train_step(state, red, rl, oc, b),
                       device=dev)
    return {"reduced_decode_s": t_decode, "reduced_train_s": t_train,
            "reduced_cfg": red, "batch": batch, "seq": seq}


def stage_latencies_from_registry(registry) -> Dict[str, float]:
    """Measured seconds-per-row per stage from the live obs registry
    (``stage_batch_seconds`` sum over ``stage_samples_total``) — the
    profiled half of the hybrid cost model for elastic stage sizing.
    Stages that have not completed a batch yet are absent; callers fall
    back to the analytic estimate for those."""
    hist = registry.get("stage_batch_seconds")
    samples = registry.get("stage_samples_total")
    out: Dict[str, float] = {}
    if hist is None or samples is None:
        return out
    for row in hist.snapshot():
        stage = row["labels"].get("stage")
        if not stage:
            continue
        n = samples.value(stage=stage)
        if n > 0 and row["sum"] > 0:
            out[stage] = row["sum"] / n
    return out


def make_profile_fn(cfg: ModelConfig, w, hw: HW = HW(), *, device=None):
    """Returns a ``profile_fn(plan) -> overrides`` for
    ``plan_resources(..., profile_fn=...)``: measures the reduced blocks
    once on ``device``, then extrapolates per-plan via analytic FLOP/byte
    ratios. ``profile_fn.raw`` holds the measurement and
    ``profile_fn.decode_over_bound`` the measured reduced decode step over
    its analytic lower bound on ``hw``."""
    prof = profile_reduced_blocks(cfg, device=device)
    red = prof["reduced_cfg"]

    red_decode_lb = max(
        forward_flops(red, prof["batch"], 1, kv_len=prof["seq"]) / hw.peak_flops,
        (red.active_param_count() * 2
         + kv_cache_bytes(red, prof["batch"], prof["seq"])) / hw.hbm_bw)
    # the reference's measured-over-ideal inflation, kept so both packages
    # give the same overrides for one HW; it is not a figure observed on
    # the card (decode_over_bound is)
    eff = 1.15

    def profile_fn(plan) -> Dict[str, float]:
        bsz = 8
        kv = w.prompt_len + w.mean_response_len
        t_c = forward_flops(cfg, bsz, 1, kv_len=kv) / (
            plan.rollout_tp * hw.peak_flops)
        t_m = (cfg.active_param_count() * 2 / plan.rollout_tp
               + kv_cache_bytes(cfg, bsz, kv)) / hw.hbm_bw
        return {"decode_token_s": eff * max(t_c, t_m)}

    profile_fn.raw = prof
    profile_fn.decode_over_bound = prof["reduced_decode_s"] / red_decode_lb
    return profile_fn
