"""The port's planner against the reference's on the CPU: the cost model,
the simulator, the plan search, stage sizing and the elastic controller.

The two packages' ``HW()`` defaults differ (the reference's are a TPU's,
the port's an H100's), so every comparison hands both the same explicit
figures. The arithmetic is the same Python, so the numbers must be equal,
not close."""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as ref_get_config
from repro.core import planner as rp
from repro.core.obs import MetricsRegistry as RefRegistry
from repro.core.workflow import StageGraph as RefGraph
from repro.core.workflow import StageSpec as RefSpec
from repro.core.workflow import build_dataflow as ref_build_dataflow
from repro.models import decode_window as ref_decode_window
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro.rl.grpo import grpo_train_step as ref_grpo_train_step
from repro.training import OptimizerConfig as RefOptimizerConfig
from repro.training import TrainState as RefTrainState
from repro_torch.configs import get_config
from repro_torch.core import planner as tp
from repro_torch.core.obs import MetricsRegistry
from repro_torch.core.workflow import StageGraph, StageSpec, build_dataflow
from repro_torch.models import decode_window
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.rl import grpo_train_step
from repro_torch.rl.grpo import GRPOConfig
from repro_torch.training import OptimizerConfig, TrainState

SRC = Path(__file__).resolve().parents[1] / "src"
# one set of figures for both packages, neither package's default
FIGURES = dict(peak_flops=400e12, hbm_bw=1.5e12, ici_bw=200e9,
               hbm_bytes=40e9, host_net_bw=20e9)
REF_HW, HW = rp.HW(**FIGURES), tp.HW(**FIGURES)
SHAPES = sorted(INPUT_SHAPES)
MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 4},
          {"pod": 2, "data": 4, "model": 8}]
MODES = ("colocated", "separated", "separated_tq", "separated_async")


def _both(arch):
    return ref_get_config(arch), get_config(arch)


def test_port_hw_defaults_are_the_h100s():
    hw = tp.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes,
            hw.host_net_bw) == (989e12, 3.35e12, 900e9, 85.0e9, 54.5e9)
    assert [f.name for f in dataclasses.fields(tp.HW)] == \
        [f.name for f in dataclasses.fields(rp.HW)]
    # the reference's TPU figures appear nowhere in the port
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"\bv5[ep]\b", text), path
        for lit in ("197e12", "819e9", "50e9", "96e9", "25e9"):
            assert lit not in text, (path, lit)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_model_volumes_equal_the_reference(arch):
    ref, cfg = _both(arch)
    for shape in SHAPES:
        shp = INPUT_SHAPES[shape]
        B, S = shp.global_batch, min(shp.seq_len, 4096)
        assert tp.forward_flops(cfg, B, S) == rp.forward_flops(ref, B, S)
        assert tp.forward_flops(cfg, B, 1, kv_len=S) == \
            rp.forward_flops(ref, B, 1, kv_len=S)
        assert tp.forward_flops(cfg, B, S, window=512) == \
            rp.forward_flops(ref, B, S, window=512)
        assert tp.step_flops(cfg, shape) == rp.step_flops(ref, shape)
        assert tp.kv_cache_bytes(cfg, B, S) == rp.kv_cache_bytes(ref, B, S)
        for n in (1, 16, 256):
            assert tp.step_hbm_bytes(cfg, shape, n) == \
                rp.step_hbm_bytes(ref, shape, n)
        for mesh in MESHES:
            n = int(np.prod(list(mesh.values())))
            for seq_shard in (False, True):
                assert tp.step_hbm_bytes(
                    cfg, shape, n, mesh_shape=mesh,
                    kv_seq_shard=seq_shard) == rp.step_hbm_bytes(
                    ref, shape, n, mesh_shape=mesh, kv_seq_shard=seq_shard)
            assert tp.step_collective_bytes(cfg, shape, mesh) == \
                rp.step_collective_bytes(ref, shape, mesh)
            assert tp.roofline_terms(cfg, shape, mesh, HW) == \
                rp.roofline_terms(ref, shape, mesh, REF_HW)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_window_equals_the_reference(arch):
    ref, cfg = _both(arch)
    for shape in SHAPES:
        assert decode_window(cfg, shape) == ref_decode_window(ref, shape)


@pytest.mark.parametrize("arch", ["qwen2_5_7b", "falcon_mamba_7b",
                                  "recurrentgemma_9b", "deepseek_v2_236b"])
def test_cost_oracle_and_simulator_equal_the_reference(arch):
    ref, cfg = _both(arch)
    over = {"train_microbatch_s": 0.02}
    for kw in ({}, {"overrides": over}):
        a, b = tp.CostOracle(cfg, HW, **kw), rp.CostOracle(ref, REF_HW, **kw)
        for args in ((8, 2048, 4), (1, 64, 1), (64, 8192, 8)):
            assert a.decode_token_s(*args) == b.decode_token_s(*args)
            assert a.prefill_s(*args) == b.prefill_s(*args)
            assert a.train_microbatch_s(*args) == \
                b.train_microbatch_s(*args)
        for host in (False, True):
            assert a.weight_sync_s(8, 4, host) == b.weight_sync_s(8, 4, host)
    w = dict(prompts_per_step=32, group_size=4, num_steps=3,
             mean_response_len=512, prompt_len=128, seq_len_train=1024)
    plan = dict(n_chips=64, rollout_chips=32, train_chips=32, rollout_tp=4,
                train_tp=8, reshard_s=0.5)
    for mode in MODES:
        for seed in (0, 1, 2):
            got = tp.simulate(cfg, tp.ClusterPlan(**plan), tp.Workload(**w),
                              mode, hw=HW, seed=seed)
            want = rp.simulate(ref, rp.ClusterPlan(**plan),
                               rp.Workload(**w), mode, hw=REF_HW, seed=seed)
            assert got == want, (mode, seed)


@pytest.mark.parametrize("n_chips", [32, 128])
def test_plan_resources_equals_the_reference(n_chips):
    ref, cfg = _both("qwen2_5_7b")
    w = dict(prompts_per_step=64, group_size=4, num_steps=2)
    assert [dataclasses.astuple(p) for p in tp.candidate_plans(n_chips)] == \
        [dataclasses.astuple(p) for p in rp.candidate_plans(n_chips)]
    prof = lambda plan: {"decode_token_s": 1e-3 * plan.rollout_tp}  # noqa
    for kw in ({}, {"profile_fn": prof, "profile_top_k": 2}):
        got = tp.plan_resources(cfg, n_chips, tp.Workload(**w), hw=HW, **kw)
        want = rp.plan_resources(ref, n_chips, rp.Workload(**w), hw=REF_HW,
                                 **kw)
        assert dataclasses.astuple(got.plan) == \
            dataclasses.astuple(want.plan)
        assert (got.throughput, got.candidates_scored) == \
            (want.throughput, want.candidates_scored)


def _trainers(kl):
    """Both packages' Trainers on one tiny model: their GRPO graphs and
    engines, as ``StageRunner`` sizes them."""
    from conftest import tiny_cfg
    from repro.api import Trainer as RefTrainer
    from repro.api import TrainerConfig as RefTrainerConfig
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.configs.base import ModelConfig
    ref_cfg = tiny_cfg()
    kw = dict(num_steps=1, prompts_per_step=2, group_size=4,
              max_new_tokens=6, seq_len=24, kl_coef=kl)
    ref = RefTrainer(RefTrainerConfig(**kw), model_cfg=ref_cfg)
    port = Trainer(TrainerConfig(**kw, device="cpu"),
                   model_cfg=ModelConfig(**dataclasses.asdict(ref_cfg)))
    return ref, port


@pytest.mark.parametrize("kl", [0.0, 0.05])
def test_stage_costs_and_sizing_equal_the_reference(kl):
    ref, port = _trainers(kl)
    g, rg = build_dataflow("grpo", kl_coef=kl), \
        ref_build_dataflow("grpo", kl_coef=kl)
    for profiled in (None, {"reward": 3e-4}):
        got = tp.estimate_stage_costs(g, port.engines, seq_len=24,
                                      group_size=4, hw=HW, profiled=profiled)
        want = rp.estimate_stage_costs(rg, ref.engines, seq_len=24,
                                       group_size=4, hw=REF_HW,
                                       profiled=profiled)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.items()}
        for cap in (1, 2, 8):
            sized = tp.auto_size_workers(g, got, max_workers=cap)
            assert sized == rp.auto_size_workers(rg, want, max_workers=cap)
            assert sized["actor_update"] == 1
            assert all(1 <= n <= cap for n in sized.values())
            assert tp.simulate_stage_pipeline(got, sized, 64) == \
                rp.simulate_stage_pipeline(want, sized, 64)


def _scripted(pkg_graph, pkg_spec, registry_cls, controller_cls):
    """One scripted run of an elastic controller: the actions of each
    step and the apply calls, on a fresh registry of its package."""
    g = pkg_graph(source_columns=("prompt",))
    g.add(pkg_spec("generate", inputs=("prompt",), outputs=("item",),
                   kind="generate"))
    g.add(pkg_spec("enrich", inputs=("item",), outputs=("score",)))
    g.add(pkg_spec("actor_update", inputs=("item", "score"), kind="train",
                   drives_steps=True))
    g.validate()
    m = registry_cls()
    stalls = m.counter("stage_stalls_total", "")
    waits = m.counter("tq_blocked_wait_seconds_total", "")
    batches = m.histogram("stage_batch_seconds", "")
    desired = {"generate": 1, "enrich": 1, "actor_update": 1}
    calls = []

    def apply(name, delta):
        calls.append((name, delta))
        if not 1 <= desired[name] + delta <= 3:
            return False
        desired[name] += delta
        return True

    ec = controller_cls(g, m, desired, apply, patience=2, max_workers=3)
    steps = []
    rng = np.random.default_rng(0)
    for i in range(24):
        if rng.random() < 0.6:
            waits.inc(float(rng.choice([0.01, 0.2])), task="actor_update",
                      consumer="train-0")
        if rng.random() < 0.5:
            stalls.inc(int(rng.integers(1, 4)), stage="enrich")
        if rng.random() < 0.3:
            batches.observe(0.01, stage="enrich")
        if i == 12:
            desired["generate"] = 3
        steps.append(ec.step())
    reb = {(r["labels"]["stage"], r["labels"]["action"]): r["value"]
           for r in m.counter("stage_rebalance_total", "").snapshot()}
    return steps, calls, dict(desired), reb


def test_elastic_controller_decisions_equal_the_reference():
    got = _scripted(StageGraph, StageSpec, MetricsRegistry,
                    tp.ElasticController)
    want = _scripted(RefGraph, RefSpec, RefRegistry, rp.ElasticController)
    assert got == want
    steps, calls, _, _ = got
    assert any(a["action"] == "grow" for s in steps for a in s)
    assert all(name != "actor_update" for name, _ in calls)


def test_grpo_train_step_matches_reference(tiny_dense_cfg, tiny_dense_params):
    """One GRPO update in fp32 from the same params and batch: the step
    and the metrics (``grad_norm`` among them) within 1e-5 relative of the
    reference's jitted ``grpo_train_step``, and the new params within 1e-5
    relative as one tree. Leaf by leaf the bar is 1e-4: the key bias has
    an analytic gradient of 0 (a shift common to every key leaves the
    softmax as it is), so its gradient is rounding noise, which AdamW's
    first step scales to about ±lr in both packages alike."""
    import jax.numpy as jnp

    from repro_torch.configs.base import ModelConfig
    ref_cfg = dataclasses.replace(tiny_dense_cfg, compute_dtype="float32")
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(3)
    B, S = 4, 20
    mask = np.zeros((B, S), np.float32)
    mask[:, 6:] = 1.0
    batch = {"tokens": rng.integers(3, 259, (B, S)).astype(np.int32),
             "response_mask": mask,
             "old_logprob": (-5.5 + 0.3 * rng.standard_normal((B, S)))
             .astype(np.float32),
             "ref_logprob": (-5.5 + 0.1 * rng.standard_normal((B, S)))
             .astype(np.float32),
             "advantage": rng.standard_normal(B).astype(np.float32)}
    opt = dict(lr=1e-3, warmup_steps=2)
    new_ref, m_ref = ref_grpo_train_step(
        RefTrainState.create(tiny_dense_params), ref_cfg,
        RefGRPOConfig(kl_coef=0.05), RefOptimizerConfig(**opt),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_reference(jax.tree.map(np.asarray,
                                                tiny_dense_params),
                                   device="cpu")
    tb = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
          for k, v in batch.items()}
    new, m = grpo_train_step(TrainState.create(params), cfg,
                             GRPOConfig(kl_coef=0.05), OptimizerConfig(**opt),
                             tb)
    assert new.step == int(new_ref.step) == 1
    assert set(m) == set(m_ref) and "grad_norm" in m
    for k in m_ref:
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    num = den = 0.0
    for a, b in zip(jax.tree.leaves(params_to_reference(new.params)),
                    jax.tree.leaves(new_ref.params)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
        num, den = num + np.sum((a - b) ** 2), den + np.sum(b * b)
    assert np.sqrt(num) <= 1e-5 * np.sqrt(den)


def test_profiling_runs_on_the_cpu_with_the_references_keys():
    """``profile_reduced_blocks`` times the reduced model's decode step and
    GRPO update on the CPU; ``make_profile_fn``'s overrides equal the
    reference's for one HW (they rest on its constant ``eff``, not on the
    timing), and it reports the measured decode over its bound."""
    ref, cfg = _both("qwen2_5_7b")
    prof = tp.profile_reduced_blocks(cfg, device="cpu")
    want = rp.profile_reduced_blocks(ref)
    assert set(prof) == set(want)
    assert prof["reduced_decode_s"] > 0 and prof["reduced_train_s"] > 0
    assert dataclasses.asdict(prof["reduced_cfg"]) == \
        dataclasses.asdict(want["reduced_cfg"])
    w = dict(prompts_per_step=64, group_size=4, num_steps=2)
    pf = tp.make_profile_fn(cfg, tp.Workload(**w), HW, device="cpu")
    rpf = rp.make_profile_fn(ref, rp.Workload(**w), REF_HW)
    assert set(pf.raw) == set(rpf.raw) and pf.decode_over_bound > 0
    for plan in tp.candidate_plans(128)[:4]:
        assert pf(plan) == rpf(rp.ClusterPlan(*dataclasses.astuple(plan)))
    pr = tp.plan_resources(cfg, 128, tp.Workload(**w), hw=HW, profile_fn=pf,
                           profile_top_k=2)
    assert pr.throughput > 0


def test_stage_latencies_from_registry():
    reg = MetricsRegistry()
    h = reg.histogram("stage_batch_seconds", "")
    c = reg.counter("stage_samples_total", "")
    for stage, secs, n in (("generate", (0.2, 0.4), 6), ("reward", (0.1,), 0)):
        for s in secs:
            h.observe(s, stage=stage)
        if n:
            c.inc(n, stage=stage)
    got = tp.stage_latencies_from_registry(reg)
    assert got == pytest.approx({"generate": 0.1})
    assert tp.stage_latencies_from_registry(MetricsRegistry()) == {}
    assert set(tp.__all__) == set(rp.__all__)


def test_planner_sizes_a_port_trainer_run():
    """``StageRunner`` takes the sizing: the cost model's counts land in
    the worker pools (the generate stage's receivers among them)."""
    from repro_torch.core.workflow import StageRunner, WorkflowConfig
    _, port = _trainers(0.05)
    g = build_dataflow("grpo", kl_coef=0.05)
    wcfg = WorkflowConfig(mode="async", num_steps=1, prompts_per_step=2,
                          group_size=4, auto_size_workers=True,
                          max_stage_workers=3)
    runner = StageRunner(wcfg, g, engines=port.engines,
                         prompt_stream=lambda s: [])
    costs = tp.estimate_stage_costs(g, port.engines, seq_len=24,
                                    group_size=4)
    sized = tp.auto_size_workers(g, costs, max_workers=3)
    assert {k: dataclasses.astuple(v) for k, v in runner.stage_costs.items()} \
        == {k: dataclasses.astuple(v) for k, v in costs.items()}
    assert runner._desired == sized
    assert runner.n_gen_workers == len(runner.receivers) == sized["generate"]


def test_a_shrunk_rollout_worker_lets_its_weights_go():
    """A generate worker that exits because the elastic controller shrank
    its pool drops its receiver's weights: on one card each receiver's
    weights are a device copy of the model."""
    from repro_torch.core.workflow import StageRunner, WorkflowConfig
    _, port = _trainers(0.0)
    runner = StageRunner(
        WorkflowConfig(mode="async", num_steps=1, prompts_per_step=2,
                       group_size=4, num_rollout_workers=2),
        build_dataflow("grpo"), engines=port.engines,
        prompt_stream=lambda s: [])
    kept, gone = runner.receivers
    runner._desired["generate"] = 1                  # the pool shrank by one
    runner._active["generate"] = 2
    runner._generate_worker(1, gone)
    assert gone.params is None and kept.params is not None
    assert runner._active["generate"] == 1
