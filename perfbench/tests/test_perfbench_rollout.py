"""The rollout driver on the CPU at a small size: the closed loop fills
the pool, a sound run is correct, an altered token is caught, and the
control reads above the program."""
from perfbench.tests.common import run_tiny

# long enough for requests to finish in the window on a loaded CPU
SECONDS = 2.0


def test_sound_run_is_correct():
    cell, res, ok = run_tiny("qwen2_5_7b_l18", "rollout_groups",
                             seconds=SECONDS)
    assert ok, res["checks"]
    e = res["e2e"]
    assert e["gen_tokens_per_s"] > 0 and e["token_gap_p95_ms"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["ctx"]["model_flops"] > 0
    assert len(res["followed"]["sample"]) == min(
        cell.traffic["check_requests"], res["attempted"])


def test_altered_token_is_not_correct(monkeypatch):
    from perfbench.tests.test_perfbench_grpo import _token_cb
    _token_cb(monkeypatch)
    cell, res, ok = run_tiny("qwen2_5_7b_l18", "rollout_groups",
                             seconds=SECONDS)
    assert not ok and res["failed"] > 0, res["checks"]


def test_control_reads_above_the_program():
    from perfbench.core.spec import load_module
    cell, res, ok = run_tiny("qwen2_5_7b_l18", "rollout_groups",
                             seconds=SECONDS)
    got = load_module("drivers", "rollout").readings(cell, res, 2**31 + 11,
                                                     "cpu")
    assert got["control"]["logprob_gap"] > 3 * got["program"]["logprob_gap"]
    assert got["token_altered"]["logprob_gap"] > 0.05
