"""The port's training workflow end to end on the CPU: ``Trainer.fit`` in
every mode and on both rollout backends, with and without the KL stage;
the weight path's aliasing rules; the refusals of what is not ported yet;
and the framework-free modules, which the port copies with only their
import paths changed."""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro_torch.api import Trainer, TrainerConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.workflow import (WeightChannel, WeightReceiver,
                                       WeightSender)
from repro_torch.engines import TrainEngine
from repro_torch.launch import train as train_launch
from repro_torch.models import init_params
from repro_torch.rl import loss as loss_mod

SRC = Path(__file__).resolve().parents[1] / "src"
TINY = dict(num_steps=2, prompts_per_step=2, group_size=2, max_new_tokens=4,
            seq_len=24, device="cpu")


def _cfg():
    return ModelConfig(**dataclasses.asdict(tiny_cfg()))


def _spy(monkeypatch, name):
    calls = []
    inner = getattr(loss_mod, name)

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(loss_mod, name, spy)
    return calls


@pytest.mark.parametrize("mode,backend,kl", [
    ("baseline", "fixed", 0.05), ("streaming", "continuous", 0.0),
    ("async", "fixed", 0.0), ("async", "fixed", 0.05),
    ("async", "continuous", 0.0), ("async", "continuous", 0.05)])
def test_trainer_fit_every_mode(monkeypatch, mode, backend, kl):
    """Every sample trains once, every step yields finite metrics, the
    staleness stays in bound, and the actor loss (and, with KL, the
    reference-inference logprobs) went through the kernels' call sites."""
    fused = _spy(monkeypatch, "fused_rl_loss")
    logprob = _spy(monkeypatch, "grpo_logprob")
    t = TrainerConfig(mode=mode, rollout_backend=backend, kl_coef=kl, **TINY)
    res = Trainer(t, model_cfg=_cfg()).fit()
    n = t.num_steps * t.prompts_per_step * t.group_size
    assert res.samples_trained == len(res.staleness_seen) == n
    assert len(res.metrics) == t.num_steps
    for m in res.metrics:
        for k in ("loss", "grad_norm", "policy_loss", "entropy"):
            assert math.isfinite(m[k]), (k, m)
    bound = 0 if mode != "async" else t.staleness + 1
    assert max(res.staleness_seen) <= bound
    assert len(fused) >= n // t.train_micro_batch
    assert (len(logprob) > 0) == (kl > 0)


def test_optimizer_step_leaves_receivers_and_snapshots_alone():
    """JAX's immutability hid two hazards: receivers start from the
    trainer's own initial tensors, and an async publish snapshots while the
    trainer steps on. The step makes new parameter tensors, so neither
    sees a write."""
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    before = {k: v.clone() for k, v in params["blocks"]["attn"]["wq"].items()}
    eng = TrainEngine(cfg, params, global_batch=2, seq_len=16)
    chan = WeightChannel()
    recv = WeightReceiver(chan, eng.params, version=0)
    sender = WeightSender(chan, mode="async")
    sender.publish(eng.params, 1)
    rng = np.random.default_rng(0)
    rows = {"response": [rng.integers(3, 259, 12) for _ in range(2)],
            "logprob": [np.full(12, -5.5, np.float32)] * 2,
            "response_mask": [np.r_[np.zeros(4), np.ones(8)]] * 2,
            "advantage": [1.0, -1.0]}
    out = eng.update_actor(rows)
    sender.flush()
    assert out and eng.version == 1
    new = eng.params["blocks"]["attn"]["wq"]["w"]
    assert not torch.equal(new, before["w"])           # the trainer moved
    assert torch.equal(recv.params["blocks"]["attn"]["wq"]["w"], before["w"])
    snap = chan.peek().host_params["blocks"]["attn"]["wq"]["w"]
    assert torch.equal(snap, before["w"])
    assert snap.data_ptr() != new.data_ptr()
    assert recv.maybe_swap() and recv.version == 1      # swaps the snapshot


def test_refusals_of_what_is_not_ported_yet(monkeypatch):
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="item 8"):
        Trainer(TrainerConfig(algorithm="ppo", **TINY), model_cfg=cfg)
    tr = Trainer(TrainerConfig(**TINY), model_cfg=cfg)
    with pytest.raises(NotImplementedError, match="item 9"):
        tr.fit(resume="auto")
    for kw in (dict(checkpoint_dir="x"), dict(auto_size_workers=True),
               dict(elastic_interval_s=1.0)):
        with pytest.raises(NotImplementedError, match="item 9|item 10"):
            Trainer(TrainerConfig(**TINY, **kw), model_cfg=cfg).fit()
    for argv in (["--resume", "auto"], ["--checkpoint-dir", "x"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            train_launch.main(["--device", "cpu", *argv])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainerConfig(**{**TINY, "device": "cuda"}), model_cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--steps", "1"])


def test_train_launcher_on_cpu(capsys):
    assert train_launch.main(["--device", "cpu", "--steps", "2",
                              "--prompts-per-step", "2", "--group-size", "2",
                              "--max-new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert '"device": "cpu"' in out and '"max_staleness"' in out


COPIED = ["rl/reward.py", "engines/adapter.py",
          "core/transfer_queue/__init__.py",
          "core/transfer_queue/control_plane.py",
          "core/transfer_queue/data_plane.py", "core/transfer_queue/queue.py",
          "core/supervision/__init__.py", "core/supervision/errors.py",
          "core/supervision/faults.py", "core/supervision/retry.py",
          "core/supervision/supervisor.py", "core/obs/__init__.py",
          "core/obs/report.py", "core/obs/sampler.py",
          "core/workflow/__init__.py", "core/workflow/events.py",
          "core/workflow/async_engine.py"]


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_differ_only_in_import_paths(path):
    def norm(text):
        text = text.replace("repro_torch", "repro")
        return re.sub(r"\s+", " ", text)
    assert norm((SRC / "repro_torch" / path).read_text()) == \
        norm((SRC / "repro" / path).read_text())


def test_reward_decodes_ids_past_the_byte_vocab():
    """A full-vocab model samples ids past the byte tokenizer's 259: they
    decode to nothing instead of raising, so rewards score the bytes."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.rl.reward import math_reward
    tok = ByteTokenizer()
    ids = [*tok.encode("12", add_bos=False), 151_000, 259, 40_000]
    assert tok.decode(ids) == "12"
    assert math_reward(12, ids) == 1.0


def test_launch_counter_loses_no_update_across_threads():
    """Rollout and trainer threads bump the kernels' launch counters
    concurrently: with more threads than cores and a tiny switch interval,
    every increment lands."""
    import os
    import sys
    import threading

    from repro_torch.kernels import _build

    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(n_each)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_each
