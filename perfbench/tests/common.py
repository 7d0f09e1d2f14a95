"""Running a driver on the CPU at a small size, as run.py runs it on the
card, with limits that fit the small size."""
from __future__ import annotations

import time

from perfbench.core import compare
from perfbench.core.spec import load_module
from perfbench.tests import tiny

# The small sizes' limits: above what sound runs read here (logprob gaps
# under 1e-3, loss gaps under 2e-4, changes
# under 0.05: the smallest leaves' AdamW steps sit near its eps) and far
# under what each fault reads (a state or a receiver left unchanged reads
# 1, half a batch and an altered token 0.1 or more).
TINY_LIMITS = {"rollout_lp_gap": 0.02, "ref_lp_gap": 0.02,
               "loss_gap": 2e-3, "change_gap": 0.25,
               "receiver_gap": 0.25, "logprob_gap": 0.02}


def run_tiny(config: str, traffic: str, seed: int = 2**31 + 11,
             seconds: float = 0.5):
    cell = tiny.cell(config, traffic, TINY_LIMITS)
    driver = load_module("drivers", cell.traffic["entry"])
    res = driver.run(cell, seed=seed, seconds=seconds, trace=False,
                     device="cpu", t_process=time.monotonic())
    return cell, res, compare.judge(res["checks"])
