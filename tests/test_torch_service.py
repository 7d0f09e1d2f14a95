"""The port's service API (``AsyncFlowService``, paper §5.1), after
``tests/test_system.py::test_service_api_roundtrip`` and the two service
tests of ``tests/test_stage_graph.py``, with the port's engine names; and
``init_engines`` building each registered engine on the CPU."""
import dataclasses

import numpy as np
import torch

from conftest import tiny_cfg
from repro_torch.api import AsyncFlowService
from repro_torch.configs.base import ModelConfig
from repro_torch.core.workflow import StageGraph, StageSpec, WorkflowConfig
from repro_torch.data import PromptDataset
from repro_torch.engines import CriticEngine, RolloutEngine, TrainEngine
from repro_torch.models import init_params
from repro_torch.rl.ppo import init_critic_params


def _cfg():
    return ModelConfig(**dataclasses.asdict(tiny_cfg()))


def test_service_api_roundtrip():
    svc = AsyncFlowService()
    svc.create_queue("exp", capacity=8,
                     tasks={"actor_update": ["prompt", "reward"]})
    svc.put_prompts_data("exp", ["p0", "p1", "p2"])
    svc.put_experience_data(
        "exp", {"prompt": ["x"] * 2, "reward": [1.0, 0.0]})
    # rows with both columns present are consumable
    got = svc.get_experience_data("exp", "actor_update", 2, timeout=1.0)
    assert got is not None and len(got["reward"]) == 2
    # weight sync notify bumps versions
    v1 = svc.weight_sync_notify({"w": torch.zeros(2)})
    v2 = svc.weight_sync_notify({"w": torch.ones(2)})
    assert v2 == v1 + 1
    recv = svc.register_receiver({"w": torch.zeros(2)})
    svc.sender.flush()
    assert recv.wait_and_swap(v2, timeout=2.0)
    assert float(recv.params["w"][0]) == 1.0


def test_init_engines_takes_the_ports_registered_names():
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    svc = AsyncFlowService()
    svc.init_engines({
        "rollout": {"engine": "torch_rollout", "cfg": cfg, "group_size": 2,
                    "max_new_tokens": 4, "ref_rows": 4, "ref_len": 24,
                    "device": "cpu"},
        "actor": {"engine": "torch_train", "cfg": cfg,
                  "init_params": params, "algorithm": "ppo",
                  "global_batch": 4, "seq_len": 24},
        "critic": {"engine": "torch_critic", "cfg": cfg,
                   "critic_params": init_critic_params(gen, cfg),
                   "global_batch": 4, "seq_len": 24}})
    assert isinstance(svc.engines["rollout"], RolloutEngine)
    assert isinstance(svc.engines["actor"], TrainEngine)
    assert isinstance(svc.engines["critic"], CriticEngine)
    assert svc.engines["actor"].algorithm == "ppo"
    r = svc.run_dataflow("ppo", WorkflowConfig(
        mode="streaming", num_rollout_workers=1, rollout_batch=2,
        train_micro_batch=4, prompts_per_step=2, group_size=2,
        num_steps=1), lambda s: PromptDataset(seed=0).prompts_for_step(s, 2))
    assert r.samples_trained == 4 and r.aux_metrics["critic_update"]


def test_service_custom_stage_registration():
    cfg = _cfg()
    params = init_params(0, cfg, device="cpu")
    svc = AsyncFlowService()
    graph = svc.build_dataflow("grpo", kl_coef=0.0)

    def seq_stats(batch, *, indices, **kw):
        return {"updates": {"resp_len":
                            [int(np.asarray(m).sum())
                             for m in batch["response_mask"]]}}

    svc.register_stage(graph, StageSpec(
        "seq_stats", inputs=("response_mask",), outputs=("resp_len",),
        fn=seq_stats))
    graph.validate()

    wcfg = WorkflowConfig(mode="streaming", num_rollout_workers=1,
                          rollout_batch=2, train_micro_batch=4,
                          prompts_per_step=2, group_size=2, num_steps=1)
    engines = {
        "rollout": RolloutEngine(cfg, group_size=2, max_new_tokens=4,
                                 ref_rows=4, ref_len=24, device="cpu"),
        "actor": TrainEngine(cfg, params, global_batch=4, seq_len=24)}
    r = svc.run_dataflow(graph, wcfg,
                         lambda s: PromptDataset(seed=0).prompts_for_step(
                             s, 2),
                         engines=engines)
    assert r.samples_trained == 4
    assert any(e.kind == "seq_stats" for e in r.log.events())


def _toy_graph():
    def gen(batch, *, params, rng, version=0, **kw):
        return {"rows": [dict(item=x, token_len=1)
                         for x in batch["prompt"] for _ in range(2)]}

    def enrich(batch, *, indices, **kw):
        return {"updates": {"score": [v + 1 for v in batch["item"]]}}

    def train(batch, **kw):
        return {"n": len(batch["version"])}

    g = StageGraph(source_columns=("prompt",))
    g.add(StageSpec("generate", inputs=("prompt",),
                    outputs=("item", "version"), engine="", fn=gen,
                    kind="generate"))
    g.add(StageSpec("enrich", inputs=("item",), outputs=("score",),
                    fn=enrich))
    g.add(StageSpec("actor_update", inputs=("item", "score", "version"),
                    engine="trainer", fn=train, kind="train",
                    drives_steps=True))
    return g


def test_service_register_custom_dataflow():
    svc = AsyncFlowService()
    svc.register_dataflow("toy", lambda **kw: _toy_graph())
    g = svc.build_dataflow("toy")
    assert set(g.stages) == {"generate", "enrich", "actor_update"}
