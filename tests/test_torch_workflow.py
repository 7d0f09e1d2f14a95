"""The port's training workflow end to end on the CPU: ``Trainer.fit`` in
every mode and on both rollout backends, with and without the KL stage,
and with the planner's sizing and live rebalance; the weight path's
aliasing rules; the refusals; and the framework-free modules, which the
port copies with only their import paths changed."""
import ast
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
    """PPO (item 8) builds its critic and the planner's options (item 10)
    train every step (the next test); what is refused is CUDA where there
    is none."""
    cfg = _cfg()
    tr = Trainer(TrainerConfig(algorithm="ppo", **TINY), model_cfg=cfg)
    assert "critic" in tr.engines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainerConfig(**{**TINY, "device": "cuda"}), model_cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--steps", "1"])


@pytest.mark.parametrize("kw", [
    dict(auto_size_workers=True, max_stage_workers=3),
    dict(elastic_interval_s=0.05, max_stage_workers=3),
    dict(auto_size_workers=True, elastic_interval_s=0.05,
         max_stage_workers=2, kl_coef=0.05)])
def test_trainer_fit_with_the_planner(monkeypatch, kw):
    """``auto_size_workers`` sizes the pools from the cost model and
    ``elastic_interval_s`` rebalances them live: every step trains, every
    pool stays within [1, max_stage_workers], the step driver keeps one
    worker, and the controller is built (with a rebalance cadence only)
    and its steps resize within the cap: the live loop's, if the run
    outlasted its first wake, and one more taken after the run, since a
    short CPU run may end before the loop wakes."""
    from repro_torch.core.planner import ElasticController
    from repro_torch.core.workflow import StageRunner
    sized, resizes, steps, ctrls = [], [], [], []
    init, resize = StageRunner.__init__, StageRunner._resize_stage
    step, ctrl_init = ElasticController.step, ElasticController.__init__

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        sized.append(dict(self._desired))

    def spy_resize(self, name, delta):
        ok = resize(self, name, delta)
        resizes.append((name, delta, ok, self._desired[name]))
        return ok

    def spy_step(self):
        steps.append(step(self))
        return steps[-1]

    def spy_ctrl_init(self, *a, **k):
        ctrl_init(self, *a, **k)
        ctrls.append(self)
    monkeypatch.setattr(StageRunner, "__init__", spy_init)
    monkeypatch.setattr(ElasticController, "__init__", spy_ctrl_init)
    monkeypatch.setattr(StageRunner, "_resize_stage", spy_resize)
    monkeypatch.setattr(ElasticController, "step", spy_step)
    t = TrainerConfig(**{**TINY, "num_steps": 3, **kw})
    res = Trainer(t, model_cfg=_cfg()).fit()
    n = t.num_steps * t.prompts_per_step * t.group_size
    assert res.samples_trained == n and len(res.metrics) == t.num_steps
    assert all(math.isfinite(m["loss"]) for m in res.metrics)
    assert sized[0]["actor_update"] == 1
    cap = t.max_stage_workers
    assert all(1 <= v <= cap for v in sized[0].values())
    assert len(ctrls) == (1 if t.elastic_interval_s > 0 else 0)
    if ctrls:
        n_steps = len(steps)
        ctrls[0].step()
        assert len(steps) == n_steps + 1 and isinstance(steps[-1], list)
    else:
        assert not steps
    assert all(1 <= d <= cap for _, _, _, d in resizes)


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
          "core/workflow/async_engine.py", "core/recovery/__init__.py",
          "core/recovery/snapshot.py", "core/planner/simulator.py",
          "core/planner/planner.py", "core/planner/elastic.py"]


# Where the port changed a copied module on purpose, the case checks
# exactly that change. control_plane.py drops two counters nothing read
# (each pattern cuts one statement out of the reference's text).
CUT = {"core/transfer_queue/control_plane.py": (
    r"self\._m_requests = m\.counter\(.*?task=task\)\s*",
    r"self\._m_rows_ready = m\.counter\(.*?task=task\)\s*",
    r"self\._m_rows_ready\.inc\(\)\s*",
    r"self\._m_requests\.inc\(\)\s*")}
# events.py stamps spans on the device trace's clock with thread, parent
# and trace ids (core/obs/tracing.py): its recording and export functions
# are rewritten; every other function, its analysis and rendering, and
# its module constants stay the reference's.
REWRITTEN = {"core/workflow/events.py": {
    "EventLog.__init__", "EventLog.record", "EventLog.span",
    "EventLog._Span.__init__", "EventLog._Span.__enter__",
    "EventLog._Span.__exit__", "EventLog.to_chrome_trace"}}


def _functions(text):
    """{qualified name: source} of every function, methods included."""
    out = {}

    def walk(node, prefix):
        for n in ast.iter_child_nodes(node):
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                if isinstance(n, ast.FunctionDef):
                    out[prefix + n.name] = ast.get_source_segment(text, n)
                walk(n, prefix + n.name + ".")
    walk(ast.parse(text), "")
    return out


def _constants(text):
    return [ast.dump(n) for n in ast.parse(text).body
            if isinstance(n, ast.Assign)]


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_differ_only_in_import_paths(path):
    def norm(text):
        text = text.replace("repro_torch", "repro")
        return re.sub(r"\s+", " ", text)
    port = (SRC / "repro_torch" / path).read_text()
    ref = (SRC / "repro" / path).read_text()
    if path in REWRITTEN:
        pf, rf = _functions(port), _functions(ref)
        kept = set(rf) - REWRITTEN[path]
        assert len(kept) >= 13 and kept <= set(pf)
        for name in sorted(kept):
            assert norm(pf[name]) == norm(rf[name]), name
        assert _constants(port) == _constants(ref)
        return
    for pattern in CUT.get(path, ()):
        ref, n = re.subn(pattern, "", ref, flags=re.S)
        assert n == 1, pattern
    assert norm(port) == norm(ref)


def test_cost_model_differs_only_in_imports_and_the_hw_figures():
    """``core/planner/cost_model.py`` is the reference's file but for its
    import paths, the ``HW`` class (the H100's figures in place of a
    TPU's) and the docstring line that named the TPU."""
    def norm(path):
        text = path.read_text().replace("repro_torch", "repro")
        text = re.sub(r"@dataclasses\.dataclass\(frozen=True\)\nclass HW:"
                      r".*?\n\n\n", "<HW>", text, flags=re.S)
        text = re.sub(r"  \* flash attention on [^\n]*\n", "<flash>", text)
        return re.sub(r"\s+", " ", text)
    port = norm(SRC / "repro_torch" / "core/planner/cost_model.py")
    ref = norm(SRC / "repro" / "core/planner/cost_model.py")
    assert port.count("<HW>") == ref.count("<HW>") == 1
    assert port.count("<flash>") == ref.count("<flash>") == 1
    assert port == ref


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
