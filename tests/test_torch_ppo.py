"""The port's PPO against the reference on the same numbers, for the
reduced dense, ssm and hybrid configs in fp32 compute, with parameters
carried over by ``convert.py``: ``forward_hidden`` and ``critic_forward``
within 1e-5; the actor and critic losses, their stats and every gradient
within 1e-4 relative of ``jax.grad`` (the critic's ``lm_head`` gradient
exactly zero in both); ``gae_stage`` exactly; one ``ppo_train_step`` and
two updates of each engine (metrics within 1e-4 relative, params at
``tests/test_torch_train.py``'s AdamW bar); ``CriticEngine.compute_values``
against
``JaxCriticEngine``'s; and ``Trainer(algorithm="ppo")`` in every mode, in
this process and in one that never imports JAX."""
import dataclasses
import functools
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokenizer import ByteTokenizer
from repro.engines import JaxCriticEngine
from repro.engines.train_engine import pack_rows as ref_pack_rows
from repro.models import init_params as jax_init_params
from repro.models import transformer as ref_transformer
from repro.rl import ppo as ref_ppo
from repro.training import OptimizerConfig as RefOptimizerConfig
from repro.training import TrainState as RefTrainState
from repro_torch.api import Trainer, TrainerConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import CriticEngine, TrainEngine, pack_rows
from repro_torch.models import transformer
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference,
                                        state_from_reference,
                                        state_to_reference)
from repro_torch.rl import ppo
from repro_torch.training import OptimizerConfig, TrainState

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["qwen2_5_7b", "falcon_mamba_7b", "recurrentgemma_9b"]
S = 20            # packed sequence length
HIDDEN_TOL = 1e-5
GRAD_TOL = 1e-4


def _frob(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference cfg, reference actor and critic params, port cfg, port
    actor and critic params); fp32 compute, the byte vocab."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  vocab_size=ByteTokenizer.vocab_size,
                                  compute_dtype="float32")
    actor = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    critic = ref_ppo.init_critic_params(jax.random.PRNGKey(1), ref_cfg)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    return ref_cfg, actor, critic, cfg, _port(actor), _port(critic)


def _assert_params_close(before, got, want, lr):
    """Params after one AdamW step, at the bar of
    ``tests/test_torch_train.py``: the first step moves each element by
    lr·g/(|g| + eps), and where g is at the level of fp32 rounding its sign
    is noise, so elements are held within lr and each leaf's whole update
    within 1e-3 relative."""
    for a0, a, b in zip(jax.tree.leaves(before), jax.tree.leaves(got),
                        jax.tree.leaves(want)):
        a0, b = np.asarray(a0), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=lr, rtol=0)
        assert _frob(a - a0, b - a0) < 1e-3


def _port(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _rows(n, seed, *, kl=False):
    """PPO experience rows as the TransferQueue hands them to the train
    stages: per-token advantages, returns and old values."""
    rng = np.random.default_rng(seed)
    cols = ("response", "logprob", "response_mask", "advantage", "returns",
            "values", "reward", "ref_logprob")
    rows = {k: [] for k in cols}
    for _ in range(n):
        L = int(rng.integers(10, S + 1))
        plen = int(rng.integers(3, 7))
        mask = np.zeros(L, np.float32)
        mask[plen:] = 1.0
        rows["response"].append(rng.integers(3, 259, L).astype(np.int32))
        rows["logprob"].append((-5.56 + 0.3 * rng.standard_normal(L))
                               .astype(np.float32))
        rows["response_mask"].append(mask)
        rows["advantage"].append((rng.standard_normal(L) * mask)
                                 .astype(np.float32))
        rows["returns"].append((rng.standard_normal(L) * mask)
                               .astype(np.float32))
        rows["values"].append((0.1 * rng.standard_normal(L))
                              .astype(np.float32))
        rows["reward"].append(float(rng.choice([1.0, 0.2, -0.1])))
        rows["ref_logprob"].append((-5.56 + 0.1 * rng.standard_normal(L))
                                   .astype(np.float32))
    if not kl:
        del rows["ref_logprob"]
    return rows


def _batches(rows):
    jb = ref_pack_rows(rows, S)
    tb = pack_rows(rows, S, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    return jb, tb


def _tokens(seed, B=2, L=12):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 259, (B, L)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_critic_forward_match_reference(arch):
    """Both routes of ``forward_hidden`` (kernels' plain versions on the
    CPU, and the differentiable one) and ``critic_forward`` against the
    reference within 1e-5."""
    ref_cfg, actor, critic, cfg, t_actor, t_critic = _setup(arch)
    toks = _tokens(1)
    want = np.asarray(ref_transformer.forward_hidden(actor, ref_cfg,
                                                     jnp.asarray(toks)))
    for use_kernels in (True, False):
        got = transformer.forward_hidden(t_actor, cfg,
                                         torch.from_numpy(toks).long(),
                                         use_kernels=use_kernels)
        assert got.shape == (2, 12, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), want, atol=HIDDEN_TOL,
                                   rtol=HIDDEN_TOL)
    want_v = np.asarray(ref_ppo.critic_forward(critic, ref_cfg,
                                               jnp.asarray(toks)))
    got_v = ppo.critic_forward(t_critic, cfg, torch.from_numpy(toks).long())
    assert got_v.dtype == torch.float32 and got_v.shape == (2, 12)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=HIDDEN_TOL,
                               rtol=HIDDEN_TOL)


def test_forward_lm_is_the_trunk_and_the_unembed():
    """``forward_lm``'s logits are ``forward_hidden`` through the
    unembed, bit for bit."""
    _, _, _, cfg, t_actor, _ = _setup("qwen2_5_7b")
    toks = torch.from_numpy(_tokens(2)).long()
    logits, _, _ = transformer.forward_lm(t_actor, cfg, toks)
    hidden = transformer.forward_hidden(t_actor, cfg, toks)
    from repro_torch.models.layers import dense
    assert torch.equal(logits, dense(t_actor["lm_head"], hidden,
                                     torch.float32))


def _lm_head_grads(tree):
    return [g for k, g in (tree.get("backbone") or {}).items()
            if k == "lm_head"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kl", [False, True])
def test_actor_and_critic_losses_and_grads_match_jax_grad(arch, kl):
    """``ppo_actor_loss_fn`` (fused loss, per-token advantages) and
    ``ppo_critic_loss_fn``: loss and stats within 1e-4 relative, every
    gradient within 1e-4 relative (Frobenius, per leaf) of ``jax.grad``
    through the reference (its fused Pallas loss in interpret mode); the
    critic's ``lm_head`` never reaches the value loss, so its gradient is
    zero in both."""
    from repro_torch.autodiff import grad_and_metrics
    ref_cfg, actor, critic, cfg, t_actor, t_critic = _setup(arch)
    jb, tb = _batches(_rows(3, seed=4, kl=kl))
    ref_rl = ref_ppo.PPOConfig(kl_coef=0.1 if kl else 0.0,
                               entropy_coef=0.01, use_pallas_logprob=True)
    rl = ppo.PPOConfig(kl_coef=0.1 if kl else 0.0, entropy_coef=0.01)
    cases = [(ref_ppo.ppo_actor_loss_fn, actor, ppo.ppo_actor_loss_fn,
              t_actor, False),
             (ref_ppo.ppo_critic_loss_fn, critic, ppo.ppo_critic_loss_fn,
              t_critic, True)]
    for ref_fn, ref_p, fn, p, zero_unused in cases:
        (_, m_ref), g_ref = jax.value_and_grad(ref_fn, has_aux=True)(
            ref_p, ref_cfg, jb, ref_rl)
        grads, metrics = grad_and_metrics(fn, p, cfg, tb, rl,
                                          zero_unused=zero_unused)
        assert set(metrics) == set(m_ref)
        for k in m_ref:
            np.testing.assert_allclose(float(metrics[k]), float(m_ref[k]),
                                       atol=1e-6, rtol=GRAD_TOL, err_msg=k)
        got = params_to_reference(grads)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(g_ref)):
            assert a.shape == b.shape and _frob(a, b) < GRAD_TOL
        for a, b in zip(_lm_head_grads(got), _lm_head_grads(g_ref)):
            assert not np.any(a["w"]) and not np.any(np.asarray(b["w"]))
    if arch == "qwen2_5_7b":                 # untied: the critic has one
        assert _lm_head_grads(got)


def test_critic_grads_need_zero_unused_and_the_actors_do_not():
    """Without ``zero_unused`` the critic's unused ``lm_head`` raises, as
    any parameter autograd did not reach does for the actor."""
    from repro_torch.autodiff import grad_and_metrics
    _, _, _, cfg, _, t_critic = _setup("qwen2_5_7b")
    _, tb = _batches(_rows(2, seed=5))
    with pytest.raises(RuntimeError, match="not have been used"):
        grad_and_metrics(ppo.ppo_critic_loss_fn, t_critic, cfg, tb,
                         ppo.PPOConfig())


def test_gae_stage_rows_match_reference_exactly():
    rng = np.random.default_rng(6)
    batch = {"response_mask": [], "reward": [], "values": []}
    for L in (9, 14, 5, 11):
        mask = np.zeros(L, np.float32)
        mask[int(rng.integers(0, 4)):] = 1.0
        batch["response_mask"].append(mask)
        batch["reward"].append(float(rng.choice([1.0, 0.2, -0.1])))
        batch["values"].append(rng.standard_normal(L).astype(np.float32))
    batch["response_mask"][2][:] = 0.0           # a row with no response
    for gamma, lam in ((1.0, 0.95), (0.9, 0.8)):
        want = ref_ppo.gae_stage(batch, gamma=gamma, lam=lam)["updates"]
        got = ppo.gae_stage(batch, gamma=gamma, lam=lam)["updates"]
        assert list(got) == list(want) == ["returns", "advantage"]
        for k in want:
            for a, b in zip(got[k], want[k]):
                assert a.dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_ppo_train_step_matches_reference(arch):
    """One whole-batch step of both networks from the same states: new
    params and moments of the actor and the critic, and the metrics, within
    1e-4 relative."""
    ref_cfg, actor, critic, cfg, _, _ = _setup(arch)
    jb, tb = _batches(_rows(3, seed=7, kl=True))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    ref_rl = ref_ppo.PPOConfig(kl_coef=0.05)
    rl = ppo.PPOConfig(kl_coef=0.05)
    ra, rc = RefTrainState.create(actor), RefTrainState.create(critic)
    new_ra, new_rc, m_ref = ref_ppo.ppo_train_step(
        ra, rc, ref_cfg, ref_rl, RefOptimizerConfig(**opt), jb)
    ta = state_from_reference(ra, device="cpu")
    tc = state_from_reference(rc, device="cpu")
    new_a, new_c, metrics = ppo.ppo_train_step(
        ta, tc, cfg, rl, OptimizerConfig(**opt), tb)
    assert set(metrics) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(float(metrics[k]), float(m_ref[k]),
                                   atol=1e-6, rtol=GRAD_TOL, err_msg=k)
    for got, want, before in ((new_a, new_ra, ra), (new_c, new_rc, rc)):
        p, opt_state, step = state_to_reference(got)
        assert int(step) == int(want.step) == 1
        _assert_params_close(before.params, p, want.params, opt["lr"])
        # m is linear in the gradients, v quadratic: twice their error
        for name, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
            for a, b in zip(jax.tree.leaves(opt_state[name]),
                            jax.tree.leaves(want.opt_state[name])):
                assert _frob(a, b) < tol, name


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_values_matches_jax_critic_engine(arch):
    ref_cfg, _, critic, cfg, _, t_critic = _setup(arch)
    rng = np.random.default_rng(8)
    batch = {"response": [rng.integers(3, 259, L).astype(np.int32)
                          for L in (7, 13, 10)]}
    want = JaxCriticEngine(ref_cfg, critic).compute_values(batch)
    got = CriticEngine(cfg, t_critic).compute_values(batch)
    for a, b, r in zip(got["updates"]["values"], want["updates"]["values"],
                       batch["response"]):
        assert a.dtype == np.float32 and a.shape == (len(r),)
        np.testing.assert_allclose(a, b, atol=HIDDEN_TOL, rtol=HIDDEN_TOL)


def test_two_update_critic_calls_match_reference_engine():
    """Gradient accumulation over two micro-batches, then one AdamW step
    of the critic: metrics and updated params agree with
    ``JaxCriticEngine``; the PPO actor engine likewise."""
    ref_cfg, actor, critic, cfg, t_actor, t_critic = _setup("qwen2_5_7b")
    kw = dict(global_batch=6, seq_len=S)
    from repro.engines import JaxTrainEngine
    pairs = [(JaxCriticEngine(ref_cfg, critic, **kw),
              CriticEngine(cfg, t_critic, **kw), "update_critic"),
             (JaxTrainEngine(ref_cfg, actor, algorithm="ppo", **kw),
              TrainEngine(cfg, t_actor, algorithm="ppo", **kw),
              "update_actor")]
    for ref_eng, eng, verb in pairs:
        p0 = params_to_reference(eng.params)
        for i in range(2):
            rows = _rows(3, seed=20 + i)
            out_ref = getattr(ref_eng, verb)(rows)
            out = getattr(eng, verb)(rows)
            if i == 0:
                assert out_ref == out == {}
        assert set(out) == set(out_ref) and eng.version == 1
        for k in out_ref:
            np.testing.assert_allclose(out[k], out_ref[k], atol=1e-6,
                                       rtol=GRAD_TOL, err_msg=k)
        _assert_params_close(p0, params_to_reference(eng.params),
                             ref_eng.params, eng.opt_cfg.lr)


@pytest.mark.parametrize("mode", ["baseline", "streaming", "async"])
def test_ppo_trainer_every_mode(mode):
    """After ``tests/test_stage_graph.py::test_ppo_all_modes_through_stage_graph``:
    every sample trains, one actor step per step, finite actor and critic
    metrics, the PPO stages ran, staleness in bound."""
    tcfg = TrainerConfig(algorithm="ppo", mode=mode, num_steps=2,
                         prompts_per_step=2, group_size=2,
                         rollout_workers=2, rollout_batch=1,
                         train_micro_batch=2, max_new_tokens=4, seq_len=24,
                         device="cpu")
    tr = Trainer(tcfg)
    assert set(tr.engines) == {"rollout", "actor", "critic"}
    r = tr.fit()
    assert r.samples_trained == 2 * 4
    assert len(r.metrics) == 2
    assert all(math.isfinite(m["loss"]) for m in r.metrics)
    critic = r.aux_metrics.get("critic_update", [])
    assert critic and all(math.isfinite(m["value_loss"]) for m in critic)
    kinds = {e.kind for e in r.log.events()}
    assert {"values", "advantage", "critic_update"} <= kinds
    if mode == "baseline":
        assert max(r.staleness_seen) == 0
    if mode == "async":
        assert max(r.staleness_seen) <= 2


def test_ppo_critic_seed_and_tree():
    """The critic is drawn from ``seed + 1`` with the reference's tree:
    the backbone's keys and a (d, 1) value head."""
    tcfg = TrainerConfig(algorithm="ppo", seed=3, device="cpu",
                         num_steps=1)
    tr = Trainer(tcfg)
    crit = tr.critic_engine.params
    assert set(crit) == {"backbone", "value_head"}
    assert set(crit["backbone"]) == set(tr.train_engine.params)
    assert tuple(crit["value_head"]["w"].shape) == (tr.cfg.d_model, 1)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    again = ppo.init_critic_params(gen, tr.cfg)
    assert torch.equal(again["value_head"]["w"], crit["value_head"]["w"])
    assert isinstance(tr.critic_engine.state, TrainState)


def test_ppo_trainer_and_resume_without_jax(tmp_path):
    """PPO on the reduced Qwen, then a GRPO run with snapshots and a
    resume, in a process that never imports JAX."""
    code = (
        "import sys\n"
        "from repro_torch.api import Trainer, TrainerConfig\n"
        "kw = dict(device='cpu', num_steps=2, prompts_per_step=2,"
        " group_size=2, max_new_tokens=4, seq_len=24)\n"
        "res = Trainer(TrainerConfig(algorithm='ppo', **kw)).fit()\n"
        "assert res.samples_trained == 8, res.samples_trained\n"
        "assert res.aux_metrics['critic_update'], res.aux_metrics\n"
        f"ck = {str(tmp_path / 'run')!r}\n"
        "Trainer(TrainerConfig(checkpoint_dir=ck, **kw)).fit()\n"
        "kw['num_steps'] = 3\n"
        "res = Trainer(TrainerConfig(checkpoint_dir=ck, **kw))"
        ".fit(resume='auto')\n"
        "assert res.samples_trained == 12 and len(res.metrics) == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
