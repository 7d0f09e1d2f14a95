"""The GRPO driver on the CPU at a small size: a sound run is correct and
reports its metrics; with the timed path broken underneath (a step that
returns its state unchanged, half of each micro-batch left out, a token
altered where it is produced, rollout workers that never take the
published weights) ``correct`` comes out false."""
import numpy as np
import pytest

from perfbench.tests.common import run_tiny

CONFIGS = ["qwen2_5_7b_l3"]


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(config):
    cell, res, ok = run_tiny(config, "grpo_math")
    assert ok, res["checks"]
    assert res["e2e"]["train_tokens_per_s"] > 0 and res["attempted"] > 0
    assert res["e2e"]["setup_s"] > 0 and res["failed"] == 0
    ctx = res["ctx"]
    assert ctx["model_flops"] > 0 and ctx["samples"] == res["attempted"]


def _unchanged(monkeypatch):
    from repro_torch.training.train_state import TrainState
    orig = TrainState.apply_gradients

    def apply_gradients(self, grads, opt_cfg):
        new, gnorm = orig(self, grads, opt_cfg)
        return new._replace(params=self.params), gnorm
    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from repro_torch.engines import train_engine
    orig = train_engine.pack_rows

    def pack_rows(batch, seq_len, device=None):
        n = len(batch["response"]) // 2
        return orig({k: v[:n] for k, v in batch.items()}, seq_len, device)
    monkeypatch.setattr(train_engine, "pack_rows", pack_rows)


def _token_cb(monkeypatch):
    from repro_torch.engines.continuous_batching import engine
    orig = engine.ContinuousBatchingEngine._append_token

    def _append_token(self, seq, tok, lp):
        if seq.gen_len == 2:
            tok = (tok + 1) % self.cfg.vocab_size
        orig(self, seq, tok, lp)
    monkeypatch.setattr(engine.ContinuousBatchingEngine, "_append_token",
                        _append_token)


def _receiver_not_swapped(monkeypatch):
    from repro_torch.core.workflow.weight_sync import WeightReceiver
    orig = WeightReceiver._swap

    def _swap(self, vw):
        params = self.params
        orig(self, vw)
        self.params = params         # the version moves, the weights not
    monkeypatch.setattr(WeightReceiver, "_swap", _swap)


@pytest.mark.parametrize("config,fault,check", [
    ("qwen2_5_7b_l3", _unchanged, "change_gap"),
    ("qwen2_5_7b_l3", _half_batch, "loss_gap"),
    ("qwen2_5_7b_l3", _token_cb, "rollout_lp_gap"),
    ("qwen2_5_7b_l3", _receiver_not_swapped, "receiver_gap"),
])
def test_a_broken_path_is_not_correct(monkeypatch, config, fault, check):
    fault(monkeypatch)
    cell, res, ok = run_tiny(config, "grpo_math")
    assert not ok
    c = res["checks"][check]
    assert not c["value"] <= c["limit"], res["checks"]
    assert res["failed"] > 0


def test_control_reads_above_the_program():
    """The control (the reference in fp8 in the program's place) and the
    planted faults, read as ``perfbench/limits.py`` reads them on the
    card, here at the small size."""
    from perfbench.core.spec import load_module
    cell, res, ok = run_tiny("qwen2_5_7b_l3", "grpo_math")
    got = load_module("drivers", "grpo").readings(cell, res, 2**31 + 11,
                                                  "cpu")
    prog, ctl = got["program"], got["control"]
    assert ctl["rollout_lp_gap"] > 3 * prog["rollout_lp_gap"]
    assert got["half_batch"]["loss_gap"] > 3 * prog["loss_gap"]
    assert got["token_altered"]["rollout_lp_gap"] > 0.05
    assert np.isfinite(list(got["half_batch"].values())).all()
    assert got["receiver_not_swapped"]["receiver_gap"] == 1.0
    assert got["receiver_stale"]["receiver_gap"] > \
        3 * prog["receiver_gap"]
