"""The port's durable run-level checkpointing and trainer recovery, after
``tests/test_recovery.py``: the checkpoint format (a round trip, and
checkpoints crossing between the reference and the port both ways with
the same numbers), atomic versioned snapshots (LATEST pointer, keep-last-k
retention, torn-write fallback), warm in-process trainer restart through
the supervised StageRunner with zero lost or duplicated rows, cold
``fit(resume=...)`` reproducing an uninterrupted fixed-seed run bit for
bit, and the abnormal-exit flush path."""
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import init_params as jax_init_params
from repro.training import TrainState as RefTrainState
from repro.training import restore_checkpoint as ref_restore
from repro.training import save_checkpoint as ref_save
from repro_torch.api import Trainer, TrainerConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs import MetricsRegistry, render_report, scoped
from repro_torch.core.recovery import RunCheckpointer
from repro_torch.core.supervision import FaultConfig
from repro_torch.core.workflow import (StageGraph, StageRunner, StageSpec,
                                       WorkflowConfig)
from repro_torch.launch import train as train_launch
from repro_torch.models import init_params
from repro_torch.models.convert import state_from_reference
from repro_torch.training import TrainState, restore_checkpoint, \
    save_checkpoint


def _cfg():
    return ModelConfig(**dataclasses.asdict(tiny_cfg()))


def _equal_trees(a, b, ordered=True):
    """Leaf for leaf, the same numbers, dtype and kind of leaf; with
    ``ordered`` the dicts' keys also in the same order."""
    if isinstance(a, dict):
        assert list(a) == list(b) if ordered else set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k], ordered)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y, ordered)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert a.device == b.device and torch.equal(a, b)
    else:
        assert type(a) is type(b) and a == b


# ---------------------------------------------------------------------- #
# the checkpoint format                                                   #
# ---------------------------------------------------------------------- #

def _port_state(seed=0):
    """A TrainState of the reduced Qwen with moments and counters that are
    not their initial values."""
    state = TrainState.create(init_params(seed, _cfg(), device="cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    for name in ("m", "v"):
        for t in jax.tree.leaves(state.opt_state[name]):
            t.copy_(torch.rand(t.shape, generator=g))
    state.opt_state["count"] = 5
    return state._replace(step=5)


def test_checkpoint_round_trip_keeps_tree_order_devices_and_ints(tmp_path):
    state = _port_state()
    save_checkpoint(str(tmp_path / "ck"), state, step=5)
    meta = json.loads((tmp_path / "ck" / "meta.json").read_text())
    # the reference's key strings and order, one npz member a leaf
    assert meta["step"] == 5 and len(meta["keys"]) == 47
    assert meta["keys"][0] == ".params/blocks/attn/wk/b"
    assert meta["keys"][-2:] == [".opt_state/v/lm_head/w", ".step"]
    with np.load(tmp_path / "ck" / "arrays.npz") as z:
        assert sorted(z.files) == sorted(f"a{i}" for i in range(47))
        assert z["a46"].dtype == np.int32 and z["a46"].shape == ()
    like = TrainState.create(init_params(1, _cfg(), device="cpu"))
    back, step = restore_checkpoint(str(tmp_path / "ck"), like)
    assert step == 5 and isinstance(back, TrainState)
    _equal_trees(back.params, state.params)
    _equal_trees(back.opt_state, state.opt_state)
    assert back.step == 5 and type(back.step) is int
    # a save over an existing checkpoint replaces it whole
    save_checkpoint(str(tmp_path / "ck"), like, step=0)
    again, step = restore_checkpoint(str(tmp_path / "ck"), state)
    assert step == 0 and again.step == 0
    _equal_trees(again.params, like.params)
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_checkpoint_structure_mismatch_raises(tmp_path):
    state = _port_state()
    save_checkpoint(str(tmp_path / "ck"), state.params, step=1)
    with pytest.raises(ValueError, match="only in target"):
        restore_checkpoint(str(tmp_path / "ck"), state)


def test_reference_checkpoint_restores_into_the_port_and_back(tmp_path):
    """A checkpoint the reference wrote restores into the port's
    ``TrainState`` with the same numbers, and one the port wrote restores
    into the reference's."""
    ref_cfg = tiny_cfg()
    params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    rng = np.random.default_rng(3)
    moment = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), params)
    ref_state = RefTrainState(params, {"m": moment, "v": jax.tree.map(
        jnp.abs, moment), "count": jnp.asarray(7, jnp.int32)},
        jnp.asarray(7, jnp.int32))
    ref_save(str(tmp_path / "from_ref"), ref_state, step=7)
    like = TrainState.create(init_params(1, _cfg(), device="cpu"))
    got, step = restore_checkpoint(str(tmp_path / "from_ref"), like)
    assert step == 7 and got.step == 7 and got.opt_state["count"] == 7
    # the restored tree keeps the port's key order; the reference's
    # (sorted, from JAX) differs, so the numbers are matched by key
    want = state_from_reference(ref_state, device="cpu")
    assert list(got.params) == list(like.params)
    assert list(got.params["blocks"]) == list(like.params["blocks"])
    _equal_trees(got.params, want.params, ordered=False)
    _equal_trees(got.opt_state, want.opt_state, ordered=False)

    state = _port_state(seed=2)
    save_checkpoint(str(tmp_path / "from_port"), state, step=5)
    back, step = ref_restore(str(tmp_path / "from_port"), ref_state)
    assert step == 5 and int(back.step) == 5
    assert int(back.opt_state["count"]) == 5
    assert back.step.dtype == jnp.int32
    want = state_from_reference(back, device="cpu")
    _equal_trees(want.params, state.params, ordered=False)
    _equal_trees(want.opt_state, state.opt_state, ordered=False)


# ---------------------------------------------------------------------- #
# RunCheckpointer: atomic snapshots, LATEST pointer, retention            #
# ---------------------------------------------------------------------- #

def test_snapshot_roundtrip_latest_pointer_and_retention(tmp_path):
    reg = MetricsRegistry()
    ck = RunCheckpointer(str(tmp_path), keep_last=2, metrics=reg)
    like = {"w": torch.zeros((2, 2))}
    for step in (1, 2, 3):
        ck.save(step, {"trainer_version": step, "acked_uids": [0, step]},
                {"actor": {"w": torch.full((2, 2), float(step))}})
    assert ck.list_snapshots() == ["snapshot-00000002", "snapshot-00000003"]
    assert (tmp_path / "LATEST").read_text().strip() == "snapshot-00000003"
    path = ck.resolve("auto")
    doc = ck.load(path)
    assert doc["step"] == 3 and doc["trainer_version"] == 3
    assert doc["engines"] == ["actor"] and doc["acked_uids"] == [0, 3]
    tree, step = ck.load_engine(path, "actor", like)
    assert step == 3
    assert torch.equal(tree["w"], torch.full((2, 2), 3.0))
    writes = reg.snapshot()["checkpoint_write_seconds"]["values"]
    assert sum(v["count"] for v in writes) == 3
    assert reg.get("checkpoint_bytes_total").value() > 0


def test_resolve_auto_skips_torn_and_corrupt_snapshots(tmp_path):
    ck = RunCheckpointer(str(tmp_path), keep_last=4,
                         metrics=MetricsRegistry())
    state = {"w": torch.ones((2, 2))}
    good = ck.save(1, {"trainer_version": 1}, {"actor": state})
    bad = ck.save(2, {"trainer_version": 2}, {"actor": state})
    torn = tmp_path / ".tmp-snapshot-00000003-dead"
    torn.mkdir()
    (torn / "run.json").write_text('{"schema": "asyncflow-run-snap')
    with open(os.path.join(bad, "actor", "arrays.npz"), "wb") as f:
        f.write(b"\x00garbage")
    assert (tmp_path / "LATEST").read_text().strip() == "snapshot-00000002"
    assert ck.resolve("auto") == good
    with pytest.raises(FileNotFoundError):
        ck.resolve(bad)
    ck.save(4, {"trainer_version": 4}, {"actor": state})
    assert not torn.exists()


# ---------------------------------------------------------------------- #
# warm trainer restart through the stage graph (toy engines)              #
# ---------------------------------------------------------------------- #

def _toy_graph(enrich_fn=None):
    def gen(batch, *, params, rng, version=0, **kw):
        return {"rows": [dict(item=x, token_len=1)
                         for x in batch["prompt"] for _ in range(2)]}

    def enrich(batch, *, indices, **kw):
        return {"updates": {"score": [v + 1 for v in batch["item"]]}}

    def train(batch, **kw):
        return {"n": len(batch["version"])}

    g = StageGraph(source_columns=("prompt",))
    g.add(StageSpec("generate", inputs=("prompt",),
                    outputs=("item", "version"), fn=gen, kind="generate"))
    g.add(StageSpec("enrich", inputs=("item",), outputs=("score",),
                    fn=enrich_fn or enrich))
    g.add(StageSpec("actor_update", inputs=("item", "score", "version"),
                    engine="trainer", fn=train, kind="train",
                    drives_steps=True))
    return g


def _toy_runner(graph=None, metrics=None, **cfg_kw):
    cfg_kw.setdefault("mode", "streaming")
    cfg_kw.setdefault("num_rollout_workers", 2)
    cfg_kw.setdefault("rollout_batch", 2)
    cfg_kw.setdefault("train_micro_batch", 4)
    cfg_kw.setdefault("prompts_per_step", 4)
    cfg_kw.setdefault("group_size", 2)
    cfg_kw.setdefault("num_steps", 3)
    return StageRunner(
        WorkflowConfig(**cfg_kw), graph or _toy_graph(),
        engines={"trainer": SimpleNamespace(params={"w": torch.zeros(1)})},
        prompt_stream=lambda s: [1, 2, 3, 4],
        metrics=metrics or MetricsRegistry())


def test_trainer_kill_warm_restart_zero_lost_or_duplicated(tmp_path):
    reg = MetricsRegistry()
    runner = _toy_runner(metrics=reg, checkpoint_dir=str(tmp_path),
                         faults=FaultConfig(seed=0,
                                            stages=("actor_update",),
                                            crash_on_calls=(3,)),
                         heartbeat_timeout_s=30.0)
    r = runner.run()
    assert r.samples_trained == 3 * 8
    assert reg.get("trainer_restarts_total").value() == 1
    assert reg.get("rows_requeued_total").value(task="actor_update") >= 4
    assert reg.get("rows_dropped_duplicate_total").value() == 0
    assert reg.get("faults_injected_total").value(
        stage="actor_update", kind="crash") == 1
    ck = RunCheckpointer(str(tmp_path), metrics=MetricsRegistry())
    doc = ck.load(ck.resolve("auto"))
    assert doc["step"] == 3 and doc["samples_trained"] == 24
    report = render_report(r.telemetry)
    assert "recovery:" in report and "1 trainer restarts" in report


def test_trainer_restart_budget_exhaustion_fails_the_run(tmp_path):
    reg = MetricsRegistry()
    runner = _toy_runner(metrics=reg, checkpoint_dir=str(tmp_path),
                         faults=FaultConfig(seed=0,
                                            stages=("actor_update",),
                                            crash_on_calls=(0, 1, 2, 3)),
                         max_trainer_restarts=2, heartbeat_timeout_s=30.0)
    with pytest.raises(RuntimeError, match=r"stage 'actor_update'"):
        runner.run()
    assert reg.get("trainer_restarts_total").value() == 2


def test_trainer_crash_without_checkpointing_is_fatal():
    runner = _toy_runner(faults=FaultConfig(seed=0,
                                            stages=("actor_update",),
                                            crash_on_calls=(0,)),
                         heartbeat_timeout_s=30.0)
    with pytest.raises(RuntimeError, match=r"stage 'actor_update'"):
        runner.run()


def test_abnormal_exit_flushes_final_sample_and_last_snapshot(tmp_path):
    jsonl = tmp_path / "metrics.jsonl"
    snaps = tmp_path / "snaps"

    def bad_enrich(batch, *, indices, **kw):
        raise KeyError("enrich exploded")

    runner = _toy_runner(graph=_toy_graph(enrich_fn=bad_enrich),
                         checkpoint_dir=str(snaps),
                         metrics_jsonl=str(jsonl))
    with pytest.raises(RuntimeError, match="enrich exploded"):
        runner.run()
    lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert lines and "metrics" in lines[-1]
    ck = RunCheckpointer(str(snaps), metrics=MetricsRegistry())
    path = ck.resolve("auto")
    assert path is not None and ck.load(path)["step"] == 0


# ---------------------------------------------------------------------- #
# real engines: warm restart + cold resume bit-identity                   #
# ---------------------------------------------------------------------- #

def _real_tcfg(**overrides):
    kw = dict(num_steps=4, prompts_per_step=2, group_size=2,
              rollout_workers=1, rollout_batch=2, train_micro_batch=4,
              max_new_tokens=6, seq_len=24, mode="streaming",
              num_storage_units=1, seed=0, rollout_backend="continuous",
              cb_slots=2, heartbeat_timeout_s=30.0,
              checkpoint_interval_steps=1, device="cpu")
    kw.update(overrides)
    return TrainerConfig(**kw)


def _fit_scoped(tcfg, cfg, params, resume=None):
    with scoped() as reg:
        r = Trainer(tcfg, model_cfg=cfg, params=params).fit(resume=resume)
        snap = reg.snapshot()
    return r, snap


def _assert_metrics_identical(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert ma["step"] == mb["step"]
        for k in ("loss", "policy_loss", "grad_norm", "mean_reward"):
            assert ma[k] == mb[k], k


def test_real_trainer_kill_warm_restart_bit_identical(tmp_path):
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    faults = FaultConfig(seed=0, stages=("actor_update",),
                         crash_on_calls=(2,))
    r_clean, _ = _fit_scoped(
        _real_tcfg(checkpoint_dir=str(tmp_path / "clean")), cfg, params)
    r_kill, snap = _fit_scoped(
        _real_tcfg(checkpoint_dir=str(tmp_path / "kill"), faults=faults),
        cfg, params)
    restarts = sum(v["value"] for v in snap.get(
        "trainer_restarts_total", {}).get("values", []))
    assert restarts == 1
    assert r_kill.samples_trained == r_clean.samples_trained == 16
    _assert_metrics_identical(r_clean.metrics, r_kill.metrics)
    assert r_kill.staleness_seen == r_clean.staleness_seen


@pytest.mark.parametrize("kl", [0.0, 0.05])
def test_cold_resume_bit_identical_to_uninterrupted_run(tmp_path, kl):
    """Phase one trains steps 0-1 with snapshots and exits; a FRESH
    Trainer (new engines, re-initialized params) runs ``fit(resume="auto")``
    and finishes steps 2-3; the stitched run's metrics equal an
    uninterrupted 4-step run's bit for bit, with and without the KL
    stage."""
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    ckpt = str(tmp_path / "run")
    r_full, _ = _fit_scoped(_real_tcfg(mode="baseline", kl_coef=kl), cfg,
                            params)
    r_half, _ = _fit_scoped(
        _real_tcfg(mode="baseline", kl_coef=kl, num_steps=2,
                   checkpoint_dir=ckpt), cfg, params)
    fresh = init_params(0, cfg, device="cpu")
    r_res, _ = _fit_scoped(_real_tcfg(mode="baseline", kl_coef=kl,
                                      checkpoint_dir=ckpt),
                           cfg, fresh, resume="auto")
    assert r_res.samples_trained == r_full.samples_trained == 16
    _assert_metrics_identical(r_half.metrics, r_res.metrics[:2])
    _assert_metrics_identical(r_full.metrics, r_res.metrics)
    assert r_res.staleness_seen == r_full.staleness_seen


def test_resume_auto_with_empty_dir_starts_fresh(tmp_path):
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    tcfg = _real_tcfg(mode="baseline", num_steps=1,
                      checkpoint_dir=str(tmp_path / "empty"))
    r, _ = _fit_scoped(tcfg, cfg, params, resume="auto")
    assert r.samples_trained == 4 and len(r.metrics) == 1
    with pytest.raises(FileNotFoundError):
        Trainer(_real_tcfg(mode="baseline",
                           checkpoint_dir=str(tmp_path / "empty2")),
                model_cfg=cfg, params=params).fit(
            resume=str(tmp_path / "nowhere" / "snapshot-00000007"))


def test_trainer_final_dump_restores_into_a_fresh_trainer(tmp_path):
    """After ``tests/test_system.py::test_trainer_checkpoint_roundtrip``:
    the legacy ``<dir>/final`` dump restores into a fresh trainer."""
    ckpt = str(tmp_path / "rl_ckpt")
    kw = dict(num_steps=1, prompts_per_step=2, group_size=2,
              rollout_workers=1, rollout_batch=2, train_micro_batch=4,
              max_new_tokens=4, seq_len=24, device="cpu")
    t = Trainer(TrainerConfig(mode="streaming", checkpoint_dir=ckpt, **kw))
    t.fit()
    t2 = Trainer(TrainerConfig(**kw))
    assert t2.restore(os.path.join(ckpt, "final")) == 1
    _equal_trees(t2.train_engine.state.params, t.train_engine.state.params)
    assert t2.train_engine.state.step == 1


def test_ppo_snapshot_holds_the_critic_and_resumes(tmp_path):
    """A PPO run's snapshots bundle the critic as the ``critic`` engine, and
    a resumed run restores both engines' states."""
    cfg = _cfg()
    ckpt = str(tmp_path / "ppo")
    kw = dict(algorithm="ppo", mode="baseline", checkpoint_dir=ckpt)
    r1, _ = _fit_scoped(_real_tcfg(num_steps=1, **kw), cfg,
                        init_params(0, cfg, device="cpu"))
    ck = RunCheckpointer(ckpt, metrics=MetricsRegistry())
    path = ck.resolve("auto")
    assert ck.load(path)["engines"] == ["actor", "critic"]
    tr = Trainer(_real_tcfg(num_steps=2, **kw), model_cfg=cfg,
                 params=init_params(0, cfg, device="cpu"))
    saved, _ = ck.load_engine(path, "critic", tr.critic_engine.state)
    r2 = tr.fit(resume="auto")
    assert r2.samples_trained == 8 and len(r2.metrics) == 2
    _assert_metrics_identical(r1.metrics, r2.metrics[:1])
    assert tr.critic_engine.state.step == saved.step + 1 == 2


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "cli")
    argv = ["--device", "cpu", "--prompts-per-step", "2", "--group-size",
            "2", "--max-new-tokens", "4", "--mode", "baseline",
            "--checkpoint-dir", ckpt]
    assert train_launch.main([*argv, "--steps", "1"]) == 0
    assert train_launch.main([*argv, "--steps", "2", "--resume",
                              "auto"]) == 0
    ck = RunCheckpointer(ckpt, metrics=MetricsRegistry())
    assert ck.load(ck.resolve("auto"))["step"] == 2
    assert os.path.isdir(os.path.join(ckpt, "final"))
    assert '"max_staleness"' in capsys.readouterr().out
