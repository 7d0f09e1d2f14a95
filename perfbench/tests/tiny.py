"""Small cells for the CPU tests: the real cells' files with the sizes
cut, so that a driver runs in seconds on the CPU."""
from __future__ import annotations

import copy

from perfbench.core.spec import PB, Cell, read_json

TINY_PORT = {
    "dense": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512),
}

TINY_GRPO = dict(prompt_len={"dist": "uniform", "min": 12, "max": 24},
                 prompts_per_step=2, group_size=4, new_tokens=6)
TINY_TRAINER = dict(rollout_workers=2, rollout_batch=1, cb_slots=4,
                    train_micro_batch=4, seq_len=32)
TINY_ROLLOUT = dict(prompt_len={"dist": "uniform", "min": 8, "max": 40},
                    response_len={"dist": "lognormal", "mean": 4,
                                  "sigma": 0.6, "min": 1, "max": 8},
                    block=4, group_size=2,
                    engine={"num_slots": 4, "max_len": 48, "page_size": 8},
                    ramp_rounds_per_request=1, trace_seconds=0.2,
                    check_requests=3)


def cell(config: str, traffic: str, limits=None) -> Cell:
    cfg = read_json(PB / "configs" / f"{config}.json")
    cfg["port"] = dict(cfg["port"], **TINY_PORT[cfg["port"]["arch_type"]])
    mix = copy.deepcopy(read_json(PB / "traffic" / f"{traffic}.json"))
    if mix["entry"] == "grpo":
        mix.update(TINY_GRPO)
        mix["trainer"].update(TINY_TRAINER)
    else:
        mix.update(TINY_ROLLOUT)
    lim = limits or {"rollout_lp_gap": 1e-3, "ref_lp_gap": 1e-3,
                     "loss_gap": 1e-4,
                     "change_gap": 1e-2, "logprob_gap": 1e-3}
    return Cell(name=f"tiny.{config}.{traffic}", chips=1, config=cfg,
                traffic=mix, limits=lim, end_to_end=[], per_layer=[])
