"""On the card: the drivers at a small size through the port's CUDA
kernels, sound and against the control. Skips where there is no card
(the fixture decides, never the import)."""
import pytest
import torch

from perfbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def test_rollout_on_the_card(card):
    import time

    from perfbench.core.spec import load_module
    from perfbench.tests.common import TINY_LIMITS
    cell = tiny.cell("qwen2_5_7b_l18", "rollout_groups", TINY_LIMITS)
    cell.config["port"].update(head_dim=64, num_heads=4, num_kv_heads=2,
                               d_model=256)
    driver = load_module("drivers", "rollout")
    res = driver.run(cell, seed=2**31 + 3, seconds=0.5, trace=True,
                     device=card, t_process=time.monotonic())
    got = driver.readings(cell, res, 2**31 + 3, card)
    assert got["program"]["logprob_gap"] <= TINY_LIMITS["logprob_gap"]
    assert got["control"]["logprob_gap"] > got["program"]["logprob_gap"]
    assert res["trace"].busy_s > 0
