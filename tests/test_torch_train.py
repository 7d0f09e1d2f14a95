"""The port's training side against the reference on the same numbers:
one AdamW step per LR schedule, the GRPO loss and its gradients on one
packed batch, two ``update_actor`` calls of the train engine, and the
rollout engine's reward and reference-logprob verbs. fp32 compute; values
within 2e-5, gradients within 1e-4 relative (Frobenius, per leaf)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.engines import JaxRolloutEngine, JaxTrainEngine
from repro.engines.train_engine import _grad_microbatch
from repro.engines.train_engine import pack_rows as ref_pack_rows
from repro.models import init_params as jax_init_params
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro.training import OptimizerConfig as RefOptimizerConfig
from repro.training import TrainState as RefTrainState
from repro.training import clip_by_global_norm as ref_clip
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import RolloutEngine, TrainEngine, pack_rows
from repro_torch.models import attention
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference,
                                        state_from_reference,
                                        state_to_reference)
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
from repro_torch.training import OptimizerConfig, clip_by_global_norm


def _leaves(tree):
    return jax.tree.leaves(tree)


def _frob(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _setup():
    ref_cfg = tiny_cfg(compute_dtype="float32")
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    return ref_cfg, ref_params, cfg


def _port_params(ref_params):
    return params_from_reference(jax.tree.map(np.asarray, ref_params),
                                 device="cpu")


def _rows(n, seed, *, S=24, kl=True):
    """Variable-length experience rows as the TransferQueue hands them to
    the train stage."""
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in ("response", "logprob", "response_mask",
                            "advantage", "reward", "ref_logprob")}
    for _ in range(n):
        L = int(rng.integers(10, S + 1))
        plen = int(rng.integers(3, 7))
        rows["response"].append(rng.integers(3, 259, L).astype(np.int32))
        rows["logprob"].append((-5.56 + 0.3 * rng.standard_normal(L))
                               .astype(np.float32))
        mask = np.zeros(L, np.float32)
        mask[plen:] = 1.0
        rows["response_mask"].append(mask)
        rows["advantage"].append(float(rng.standard_normal()))
        rows["reward"].append(float(rng.choice([1.0, 0.2, -0.1])))
        rows["ref_logprob"].append((-5.56 + 0.1 * rng.standard_normal(L))
                                   .astype(np.float32))
    if not kl:
        del rows["ref_logprob"]
    return rows


@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_adamw_step_matches_reference(schedule):
    """One AdamW step from the same state (nonzero moments, count 5, grads
    large enough to be clipped), carried over by ``state_from_reference``:
    params, m, v, count and the grad norm agree."""
    _, ref_params, _ = _setup()
    rng = np.random.default_rng(7)
    flat, treedef = jax.tree.flatten(ref_params)

    def rand(scale, pos=False):
        xs = [(scale * rng.standard_normal(a.shape)).astype(np.float32)
              for a in flat]
        return treedef.unflatten([np.abs(x) if pos else x for x in xs])

    grads, m, v = rand(0.5), rand(0.01), rand(1e-3, pos=True)
    ref_state = RefTrainState(ref_params, {"m": m, "v": v,
                                           "count": jnp.asarray(5, jnp.int32)},
                              jnp.asarray(5, jnp.int32))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8, schedule=schedule,
               stable_frac=0.5)
    new_ref, gnorm_ref = ref_state.apply_gradients(
        jax.tree.map(jnp.asarray, grads), RefOptimizerConfig(**opt))

    state = state_from_reference(ref_state, device="cpu")
    new, gnorm = state.apply_gradients(
        params_from_reference(grads, device="cpu"), OptimizerConfig(**opt))
    assert float(gnorm_ref) > 1.0                      # clipping is active
    np.testing.assert_allclose(float(gnorm), float(gnorm_ref), rtol=2e-5)
    clipped_ref, _ = ref_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    clipped, _ = clip_by_global_norm(
        params_from_reference(grads, device="cpu"), 1.0)
    for a, b in zip(_leaves(params_to_reference(clipped)),
                    _leaves(clipped_ref)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-7, rtol=2e-5)
    p, opt_state, step = state_to_reference(new)
    assert int(step) == int(new_ref.step) == 6
    assert int(opt_state["count"]) == int(new_ref.opt_state["count"]) == 6
    for got, want in ((p, new_ref.params), (opt_state["m"],
                                            new_ref.opt_state["m"]),
                      (opt_state["v"], new_ref.opt_state["v"])):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-6,
                                       rtol=2e-5)


def test_grpo_grads_match_reference_on_a_packed_batch(monkeypatch):
    """``grpo_grad_step`` (plain attention route, fused loss through its
    autograd Function) against the reference's jitted ``_grad_microbatch``
    on one packed batch with KL: metrics within 2e-5, every parameter's
    gradient within 1e-4 relative. The flash kernel is never reached."""
    ref_cfg, ref_params, cfg = _setup()
    rows = _rows(4, seed=1)
    jb = ref_pack_rows(rows, 24)
    tb = pack_rows(rows, 24, device="cpu")
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))

    def no_flash(*a, **kw):
        raise AssertionError("the training forward reached flash_attention")
    monkeypatch.setattr(attention, "flash_attention", no_flash)

    g_ref, m_ref = _grad_microbatch(
        ref_params, ref_cfg, RefGRPOConfig(kl_coef=0.1, entropy_coef=0.01,
                                           use_pallas_logprob=True), jb)
    params = _port_params(ref_params)
    grads, metrics = grpo_grad_step(
        params, cfg, GRPOConfig(kl_coef=0.1, entropy_coef=0.01), tb)
    assert set(metrics) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(float(metrics[k]), float(m_ref[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
    got = params_to_reference(grads)
    for a, b in zip(_leaves(got), _leaves(g_ref)):
        assert a.shape == b.shape and _frob(a, b) < 1e-4
    # the parameters themselves were not marked for autograd
    assert not any(t.requires_grad for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def test_grpo_grad_step_raises_for_a_parameter_cut_from_the_graph(
        monkeypatch):
    """A route that records no graph for a parameter (as a kernel without
    a backward would) raises instead of handing back no gradient."""
    from repro_torch.rl import grpo
    _, ref_params, cfg = _setup()

    def cut_wq(params, cfg, batch, **kw):
        attn = dict(params["blocks"]["attn"])
        attn["wq"] = {k: v.detach() for k, v in attn["wq"].items()}
        blocks = {**params["blocks"], "attn": attn}
        return forward(params | {"blocks": blocks}, cfg, batch, **kw)

    forward = grpo.forward
    monkeypatch.setattr(grpo, "forward", cut_wq)
    with pytest.raises(RuntimeError, match="not have been used"):
        grpo_grad_step(_port_params(ref_params), cfg, GRPOConfig(),
                       pack_rows(_rows(2, seed=3, kl=False), 24,
                                 device="cpu"))


def test_two_update_actor_calls_match_reference_engine():
    """Gradient accumulation over two micro-batches, then one AdamW step:
    the first call returns nothing, the second the step's metrics; metrics
    and updated params agree with ``JaxTrainEngine``."""
    ref_cfg, ref_params, cfg = _setup()
    kw = dict(global_batch=8, seq_len=24)
    ref_eng = JaxTrainEngine(ref_cfg, ref_params,
                             rl=RefGRPOConfig(kl_coef=0.05,
                                              use_pallas_logprob=True), **kw)
    eng = TrainEngine(cfg, _port_params(ref_params),
                      rl=GRPOConfig(kl_coef=0.05), **kw)
    p0 = params_to_reference(eng.params)
    for i in range(2):
        rows = _rows(4, seed=10 + i)
        out_ref, out = ref_eng.update_actor(rows), eng.update_actor(rows)
        if i == 0:
            assert out_ref == out == {}
    assert set(out) == set(out_ref) and eng.version == 1
    for k in out_ref:
        np.testing.assert_allclose(out[k], out_ref[k], atol=2e-5,
                                   rtol=2e-5, err_msg=k)
    # AdamW's first step moves each element by lr*g/(|g| + eps): where g
    # is at the level of fp32 rounding its sign is noise, so elements are
    # held within lr and each leaf's whole update within 1e-3 relative
    lr = eng.opt_cfg.lr
    p1 = params_to_reference(eng.params)
    for a0, a, b in zip(_leaves(p0), _leaves(p1), _leaves(ref_eng.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=lr, rtol=0)
        assert _frob(a - a0, np.asarray(b) - a0) < 1e-3
    assert int(eng.state.step) == int(ref_eng.state.step) == 1


def test_rollout_reward_and_ref_logprob_verbs_match_reference():
    """``compute_rewards`` (rewards and the deferred group-advantage
    writes) and ``compute_log_prob`` (teacher-forced reference logprobs,
    flash + grpo_logprob routes on their plain versions) on the same
    rows."""
    ref_cfg, ref_params, cfg = _setup()
    ref_eng = JaxRolloutEngine(ref_cfg, group_size=2, ref_params=ref_params)
    eng = RolloutEngine(cfg, group_size=2, ref_params=_port_params(ref_params),
                        ref_rows=4, ref_len=24, device="cpu")
    rng = np.random.default_rng(4)
    resp = [np.asarray(list(b"12") + [10], np.int32) + 3,
            rng.integers(3, 259, 5).astype(np.int32),
            np.asarray(list(b" 7"), np.int32) + 3,
            rng.integers(3, 259, 4).astype(np.int32)]
    batch = {"answer": [12, 12, 7, 7], "response_ids": resp,
             "group": [(1, 0, 2), (1, 1, 2), (2, 1, 2), (2, 0, 2)]}
    out_ref = ref_eng.compute_rewards(batch, indices=[0, 1, 2, 3])
    out = eng.compute_rewards(batch, indices=[0, 1, 2, 3])
    assert out["updates"] == out_ref["updates"]
    assert [w[:2] for w in out["writes"]] == [w[:2] for w in
                                              out_ref["writes"]]
    np.testing.assert_allclose([w[2] for w in out["writes"]],
                               [w[2] for w in out_ref["writes"]], atol=1e-6)

    seqs = {"response": [rng.integers(3, 259, n).astype(np.int32)
                         for n in (9, 17, 24, 5)]}
    lp_ref = ref_eng.compute_log_prob(seqs)["updates"]["ref_logprob"]
    lp = eng.compute_log_prob(seqs)["updates"]["ref_logprob"]
    for a, b in zip(lp, lp_ref):
        assert a.dtype == np.float32 and a.shape == b.shape and a[0] == 0.0
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def test_embedding_gather_backward_is_deterministic():
    """The embedding's gather adds each token id's rows in the order they
    occur (sort, then segment sum): bit-identical across calls, within
    1e-6 relative of autograd's own backward of the plain gather, the same
    forward values, no graph without grad, and the table's last row (the
    last segment) reached."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(300, 64, generator=gen)
    tokens = torch.randint(0, 40, (16, 48), generator=gen)   # many repeats
    tokens[3, 5] = tokens[9, 0] = 299
    up = torch.randn(16, 48, 64, generator=gen)

    def grad(fn):
        t = table.detach().requires_grad_()
        out = fn(t)
        return out, torch.autograd.grad(out, t, up)[0]
    (y1, a), (_, b) = (grad(lambda t: layers._Gather.apply(t, tokens))
                       for _ in range(2))
    y0, plain = grad(lambda t: t[tokens])
    assert torch.equal(y1, y0)
    assert torch.equal(a, b)
    assert float((a - plain).abs().max()) <= 1e-6 * float(plain.abs().max())
    assert not a[40:299].any() and a[299].any()
    p = {"table": table.detach().requires_grad_()}
    with torch.no_grad():
        y = layers.embed(p, tokens)
    assert y.grad_fn is None and torch.equal(y, table[tokens].bfloat16())
    assert layers.embed(p, tokens).grad_fn is not None


@pytest.mark.parametrize("ref_rows,ref_len", [(1, 0), (3, 24)])
def test_reference_logprobs_do_not_depend_on_the_batch(ref_rows, ref_len):
    """The reference stage's batches follow the run's timing, so every
    reference call has one shape (``ref_rows`` sequences padded to
    ``ref_len``; a longer sequence alone): a sequence gets the same bytes
    in any batch, and the reference's values."""
    ref_cfg, ref_params, cfg = _setup()
    eng = RolloutEngine(cfg, ref_params=_port_params(ref_params),
                        ref_rows=ref_rows, ref_len=ref_len, device="cpu")
    rows = _rows(5, seed=4)["response"]
    rows.append(np.random.default_rng(5).integers(3, 259, 30))  # > ref_len
    whole = eng._ref_logprobs(rows)
    parts = eng._ref_logprobs(rows[:2]) + eng._ref_logprobs(rows[2:])
    alone = [eng._ref_logprobs([r])[0] for r in rows]
    for a, b, c, r in zip(whole, parts, alone, rows):
        assert a.shape == (len(r),) and a[0] == 0.0
        assert np.array_equal(a, b) and np.array_equal(a, c)
    ref = JaxRolloutEngine(ref_cfg, ref_params=ref_params)
    want = ref.compute_log_prob({"response": rows})["updates"]["ref_logprob"]
    for a, b in zip(whole, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4)


def test_step_driver_takes_its_rows_in_row_order():
    """The step driver hands its verb the rows by row index, whatever
    order they became ready in."""
    from repro_torch.core.workflow import StageRunner
    idxs, batch = StageRunner._in_row_order(
        [7, 2, 5], {"response": ["c", "a", "b"], "advantage": [3, 1, 2]})
    assert idxs == [2, 5, 7]
    assert batch == {"response": ["a", "b", "c"], "advantage": [1, 2, 3]}
    same = {"response": ["a"]}
    assert StageRunner._in_row_order([4], same) == ([4], same)
