"""The port's moe family against the reference on the same numbers:
``moe_ffn`` (routing, capacity, the aux loss), its ties, drops and
device-limited routing, ``moe_router_stats``, the model's forward and
decode over the split cache, one GRPO gradient step, the continuous
engine, ``Trainer.fit``, the planner's profiler and the launchers.

Params come from the reference (``models/convert.py``). Two configs: a
reduced ``grok_1_314b`` (GELU experts, top 2 of 4, 4/1 heads) and a
reduced GQA variant of ``deepseek_v2_236b`` (SwiGLU experts, one shared
expert, ``first_dense_layers=1``, 4/2 heads). Bars: 2e-5 in fp32 (block
outputs), 1e-4 in fp32 through the whole model, 2e-2 in bf16; gradients
within 1e-4 relative in fp32.

Capacity is the reference's: a pick past its expert's first C is
dropped, and C follows the number of tokens in the call. A decode step's
call holds one token a row and a forward's the whole batch, so the two
drop different picks; where a test holds decode to a forward it routes
every token to every expert (``top_k = num_experts``), where nothing can
drop."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokenizer import ByteTokenizer
from repro.engines.train_engine import _grad_microbatch
from repro.engines.train_engine import pack_rows as ref_pack_rows
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models.layers import dense as jax_dense
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.layers import mlp
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step

FFN_TOL = 2e-5
FP32_TOL = 1e-4
BF16_TOL = 2e-2
GRAD_RTOL = 1e-4


def _ref_cfg(name, compute_dtype="float32", **kw):
    base = dict(vocab_size=ByteTokenizer.vocab_size,
                compute_dtype=compute_dtype)
    if name == "deepseek_gqa":
        base.update(attention="gqa", num_kv_heads=2)
        name = "deepseek_v2_236b"
    return dataclasses.replace(ref_get_config(name).reduced(),
                               **{**base, **kw})


CFGS = ["grok_1_314b", "deepseek_gqa"]


def _port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _setup(name, compute_dtype="float32", top_k=None):
    kw = {} if top_k is None else {"top_k": top_k}
    ref_cfg = _ref_cfg(name, compute_dtype, **kw)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, _port_cfg(ref_cfg), params


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _ffn_params(ref_params):
    pj = jax.tree.map(lambda a: a[0], ref_params["blocks"]["ffn"])
    pt = params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    return pj, pt


def _ref_expert_ids(pj, x, cfg):
    """The reference's top-k picks, computed as ``moe_ffn`` computes them
    (no device limit)."""
    N = x.shape[0] * x.shape[1]
    xf = x.reshape(N, -1)
    probs = jax.nn.softmax(
        jax_dense(pj["router"], xf, xf.dtype).astype(jnp.float32), -1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def _port_expert_ids(pt, x, cfg):
    xf = x.reshape(-1, x.shape[-1])
    return tmoe._top_k(tmoe._router_probs(pt, xf), cfg.top_k)[1].numpy()


def _both_ffn(name, compute_dtype, x, **cfg_kw):
    ref_cfg, ref_params, _, _ = _setup(name, compute_dtype)
    ref_cfg = dataclasses.replace(ref_cfg, **cfg_kw)
    cfg = _port_cfg(ref_cfg)
    pj, pt = _ffn_params(ref_params)
    dt = getattr(jnp, compute_dtype)
    xj = jnp.asarray(x, dt)
    xt = torch.from_numpy(x).to(getattr(torch, compute_dtype))
    want = jmoe.moe_ffn(pj, xj, ref_cfg)
    with torch.no_grad():
        got = tmoe.moe_ffn(pt, xt, cfg)
    return (pj, xj, ref_cfg), (pt, xt, cfg), want, got


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_moe_ffn_and_aux_match_reference(name, compute_dtype):
    """Same picks first, then the output and the aux loss."""
    x = np.random.default_rng(1).standard_normal(
        (2, 24, 256)).astype(np.float32)
    (pj, xj, rc), (pt, xt, cfg), (yj, aj), (yt, at) = _both_ffn(
        name, compute_dtype, x)
    np.testing.assert_array_equal(_port_expert_ids(pt, xt, cfg),
                                  _ref_expert_ids(pj, xj, rc))
    tol = FFN_TOL if compute_dtype == "float32" else BF16_TOL
    assert yt.dtype == getattr(torch, compute_dtype)
    _close(yt, yj, tol)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert float(at) > 0


@pytest.mark.parametrize("name", CFGS)
def test_capacity_drops_picks_as_the_reference_does(name):
    """A decode step's call: 4 slots, one token each, top 2 of 4 experts,
    so C = 2. Every row is the same token, so all pick the same two
    experts and each expert keeps the first two rows' picks: half of the
    picks drop on both sides, and the last two rows get nothing from the
    routed experts."""
    ref_cfg, _, cfg, _ = _setup(name)
    assert tmoe.capacity(4, cfg) == 2
    row = np.random.default_rng(2).standard_normal((1, 1, 256))
    x = np.repeat(row, 4, axis=0).astype(np.float32)
    (pj, xj, rc), (pt, xt, c), (yj, _), (yt, _) = _both_ffn(name, "float32",
                                                             x)
    sj = jmoe.moe_router_stats(pj, xj, rc)
    st = tmoe.moe_router_stats(pt, xt, c)
    assert float(st.dropped_fraction) == float(sj.dropped_fraction) == 0.5
    np.testing.assert_array_equal(st.tokens_per_expert.numpy(),
                                  np.asarray(sj.tokens_per_expert))
    _close(yt, yj, FFN_TOL)
    # a dropped row gets the shared expert alone (nothing without one)
    rest = yt[2:].reshape(2, -1)
    alone = (mlp(pt["shared"], xt[2:].reshape(2, -1), c.activation,
                 xt.dtype) if "shared" in pt else torch.zeros_like(rest))
    assert torch.equal(rest, alone)
    assert not torch.equal(yt[1].reshape(1, -1), alone[:1])


def test_capacity_rounds_halves_to_even():
    """C = round(N k / E * 1.25) with Python's round, at least 1."""
    cfg = _port_cfg(_ref_cfg("grok_1_314b"))          # top 2 of 4
    assert [tmoe.capacity(n, cfg) for n in (1, 2, 4, 6, 12, 100)] == \
        [1, 1, 2, 4, 8, 62]


def test_router_stats_on_random_tokens_match_reference():
    ref_cfg, ref_params, cfg, _ = _setup("grok_1_314b")
    pj, pt = _ffn_params(ref_params)
    x = np.random.default_rng(3).standard_normal(
        (4, 9, 256)).astype(np.float32)
    sj = jmoe.moe_router_stats(pj, jnp.asarray(x), ref_cfg)
    st = tmoe.moe_router_stats(pt, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(st.tokens_per_expert.numpy(),
                                  np.asarray(sj.tokens_per_expert))
    assert float(st.dropped_fraction) == pytest.approx(
        float(sj.dropped_fraction), abs=1e-7)


@pytest.mark.parametrize("name", CFGS)
def test_tied_router_picks_the_lowest_experts(name):
    """A zero router: every prob is 1/E, and both sides pick experts 0 and
    1 for every token, in that order."""
    ref_cfg, ref_params, cfg, _ = _setup(name)
    pj, pt = _ffn_params(ref_params)
    pj = {**pj, "router": {"w": jnp.zeros_like(pj["router"]["w"])}}
    pt = {**pt, "router": {"w": torch.zeros_like(pt["router"]["w"])}}
    x = np.random.default_rng(4).standard_normal(
        (2, 5, 256)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ids_t = _port_expert_ids(pt, xt, cfg)
    np.testing.assert_array_equal(ids_t, _ref_expert_ids(pj, xj, ref_cfg))
    assert (ids_t == np.array([0, 1])).all()
    yj, aj = jmoe.moe_ffn(pj, xj, ref_cfg)
    with torch.no_grad():
        yt, at = tmoe.moe_ffn(pt, xt, cfg)
    _close(yt, yj, FFN_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


@pytest.mark.parametrize("top_k", [2, 4])
def test_device_limited_routing_matches_reference(top_k):
    """As ``tests/test_models_smoke.py::test_moe_device_limited_routing``:
    8 experts in 4 device groups, each token's picks from at most 2 of
    them. Both sides agree with and without the limit. At top 2 the limit
    changes only the aux loss (the two best experts always lie in the two
    best groups); at top 4 it changes the picks, and the output."""
    import dataclasses as dc
    ref_cfg = dc.replace(ref_get_config("deepseek_v2_236b").reduced(),
                         moe_device_limit=2, moe_ep_degree=4, num_experts=8,
                         top_k=top_k, moe_d_ff=32)
    cfg = _port_cfg(ref_cfg)
    pj = jmoe.init_moe(jax.random.PRNGKey(0), ref_cfg)
    pt = params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (2, 8, ref_cfg.d_model)))
    xt = torch.from_numpy(x)
    outs = []
    for limit in (2, 0):
        rc, c = dc.replace(ref_cfg, moe_device_limit=limit), \
            dc.replace(cfg, moe_device_limit=limit)
        yj, aj = jmoe.moe_ffn(pj, jnp.asarray(x), rc)
        with torch.no_grad():
            yt, at = tmoe.moe_ffn(pt, xt, c)
        _close(yt, yj, FFN_TOL)
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
        outs.append((yt, float(at)))
    assert outs[0][1] != outs[1][1]
    moved = float((outs[0][0] - outs[1][0]).abs().max())
    assert moved > 1e-3 if top_k == 4 else moved == 0.0


@pytest.mark.parametrize("name", CFGS)
def test_init_params_matches_reference_tree(name):
    """Keys, shapes and dtypes against the reference's tree, the stacked
    experts (L, E, d, dff) and, for first_dense_layers, ``dense_blocks``;
    the experts' init scale."""
    ref_cfg, ref_params, cfg, _ = _setup(name)
    params = init_params(3, cfg, device="cpu")
    assert ("dense_blocks" in params) == bool(cfg.first_dense_layers)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (_, t), (_, a) in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    up = params["blocks"]["ffn"]["experts"]["up"]
    assert tuple(up.shape) == (cfg.num_layers - cfg.first_dense_layers,
                               cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert abs(float(up.std()) - 0.02) < 1e-3
    # and back: the reference runs on the port's params
    back = params_to_reference(params)
    toks = jnp.asarray(np.full((1, 4), 7, np.int32))
    assert np.isfinite(np.asarray(jax_forward(back, ref_cfg,
                                              {"tokens": toks})[0])).all()


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_aux_and_prefill_cache_match_reference(name, compute_dtype):
    """Logits (the kernels' plain versions here, the Pallas kernels in
    interpret mode there), the aux loss summed over the moe layers, and
    the prefill cache, split into ``dense_kv`` and ``kv`` as the
    reference's. In bf16 the two packages' hidden states differ by a
    rounding here and there, which can swap a token's second expert where
    two probs nearly tie (three of these 40 tokens at top 2): a jump no
    bar on the logits holds. So bf16 routes every token to every expert,
    where the picks cannot swap; ``moe_ffn`` alone is held at top 2 in
    bf16 on inputs both sides share."""
    top_k = 4 if compute_dtype == "bfloat16" else None
    ref_cfg, ref_params, cfg, params = _setup(name, compute_dtype, top_k)
    toks = np.random.default_rng(5).integers(3, 259, (2, 20)).astype(
        np.int32)
    lj, aj, cj = jax_forward(ref_params, ref_cfg,
                             {"tokens": jnp.asarray(toks)}, use_pallas=True,
                             return_cache=True)
    with torch.no_grad():
        lt, at, ct = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                             return_cache=True)
    tol = FP32_TOL if compute_dtype == "float32" else BF16_TOL
    _close(lt, lj, tol)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-4)
    assert sorted(ct) == sorted(cj)
    for key in ct:
        for kv in ("k", "v"):
            assert tuple(ct[key][kv].shape) == cj[key][kv].shape
            _close(ct[key][kv], cj[key][kv], tol)


@pytest.mark.parametrize("name", CFGS)
def test_stepwise_decode_matches_reference(name):
    """Four slots decoding 10 ragged steps over one stacked cache (the
    dense layers first): the logits and the cache against the reference's
    decode, which drops the same picks (C = 1 at 4 slots)."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    B, T = 4, 10
    toks = np.random.default_rng(6).integers(3, 259, (B, T))
    cj = jax_init_cache(ref_cfg, B, T, dtype=jnp.float32)
    ct = init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    assert ct["k"].shape[0] == cfg.num_layers
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg))
    for t in range(T):
        pos = np.array([t, max(t - 1, 0), max(t - 3, 0), t])
        lj, cj = step(ref_params, cache=cj,
                      token=jnp.asarray(toks[:, t], jnp.int32),
                      pos=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct, torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos))
        _close(lt, lj, FP32_TOL)
    for kv in ("k", "v"):
        _close(ct[kv], cj[kv], FP32_TOL)


@pytest.mark.parametrize("name", CFGS)
def test_decode_equals_forward_teacher_forced(name):
    """With every token routed to every expert nothing drops, so the
    decode steps over the split cache give the forward's logits; and the
    prefill cache seeds a decode that continues it."""
    ref_cfg, _, cfg, params = _setup(name, top_k=4)
    B, T, P = 2, 12, 7
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        3, 259, (B, T)))
    with torch.no_grad():
        full, _, pre = forward(params, cfg, {"tokens": toks[:, :P]},
                               return_cache=True)
        want, _ = forward(params, cfg, {"tokens": toks})
        cache = init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
        for t in range(T):
            lt, cache = decode_step(params, cfg, cache, toks[:, t],
                                    torch.full((B,), t))
            _close(lt, want[:, t].numpy(), FP32_TOL)
        # prefill, then decode the rest from the prefilled cache
        stacked = {kv: torch.cat([pre[k][kv] for k in ("dense_kv", "kv")
                                  if k in pre]) for kv in ("k", "v")}
        c2 = init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
        for kv in ("k", "v"):
            c2[kv][:, :, :P] = stacked[kv]
        for t in range(P, T):
            lt, c2 = decode_step(params, cfg, c2, toks[:, t],
                                 torch.full((B,), t))
            _close(lt, want[:, t].numpy(), FP32_TOL)
    _close(full, want[:, :P].numpy(), FP32_TOL)


def _rows(n, seed, S=20):
    rng = np.random.default_rng(seed)
    rows = {k: [] for k in ("response", "logprob", "response_mask",
                            "advantage", "ref_logprob")}
    for _ in range(n):
        L = int(rng.integers(10, S + 1))
        rows["response"].append(rng.integers(3, 259, L).astype(np.int32))
        rows["logprob"].append((-5.56 + 0.3 * rng.standard_normal(L))
                               .astype(np.float32))
        rows["response_mask"].append(np.r_[np.zeros(4), np.ones(L - 4)]
                                     .astype(np.float32))
        rows["advantage"].append(float(rng.standard_normal()))
        rows["ref_logprob"].append((-5.56 + 0.1 * rng.standard_normal(L))
                                   .astype(np.float32))
    return rows


@pytest.mark.parametrize("name", CFGS)
def test_grpo_grad_step_matches_reference(name):
    """One GRPO micro-batch with KL: the metrics (the aux loss inside the
    loss) and every parameter's gradient against ``jax.grad`` through the
    reference's ``_grad_microbatch``; the router, every expert weight and
    the shared expert get a nonzero gradient."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    rows = _rows(4, seed=1)
    rl = dict(kl_coef=0.1, entropy_coef=0.01)
    g_ref, m_ref = _grad_microbatch(
        ref_params, ref_cfg, RefGRPOConfig(use_pallas_logprob=True, **rl),
        ref_pack_rows(rows, 20))
    grads, metrics = grpo_grad_step(params, cfg, GRPOConfig(**rl),
                                    pack_rows(rows, 20, device="cpu"))
    for k in m_ref:
        np.testing.assert_allclose(float(metrics[k]), float(m_ref[k]),
                                   atol=2e-5, rtol=2e-5, err_msg=k)
    got = jax.tree.leaves(params_to_reference(grads))
    want = jax.tree.leaves(g_ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert a.shape == b.shape and rel < GRAD_RTOL
    ffn = grads["blocks"]["ffn"]
    watched = {"router": ffn["router"]["w"], **ffn["experts"],
               **{f"shared_{k}": v["w"]
                  for k, v in ffn.get("shared", {}).items()}}
    for k, g in watched.items():
        assert float(g.abs().max()) > 0, k


def test_moe_grads_are_bit_identical_across_calls():
    """Two gradient calls on one micro-batch: the same bits (no scatter
    adds in the dispatch or the combine; the gather's backward sorted)."""
    _, _, cfg, params = _setup("deepseek_gqa")
    batch = pack_rows(_rows(4, seed=2), 20, device="cpu")
    rl = GRPOConfig(kl_coef=0.1)
    g1, m1 = grpo_grad_step(params, cfg, rl, batch)
    g2, m2 = grpo_grad_step(params, cfg, rl, batch)
    for a, b in zip(jax.tree.leaves(params_to_reference(g1)),
                    jax.tree.leaves(params_to_reference(g2))):
        np.testing.assert_array_equal(a, b)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)


def test_continuous_engine_serves_moe_teacher_forced():
    """The continuous engine on the moe config with a dense first layer
    (its prefill cache concatenated before the moe layers' into the
    pool): every sequence's logprobs against the reference's forward over
    its tokens, fp32, with every token routed to every expert so that
    neither the bucketed prefill nor the batched decode drops a pick."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg, ref_params, cfg, params = _setup("deepseek_gqa", top_k=4)
    assert cfg.first_dense_layers == 1
    temp = 0.8
    eng = ContinuousBatchingEngine(
        cfg, num_slots=3, page_size=4, max_len=32, max_new_tokens=6,
        temperature=temp, eos_id=-1, seed=7, dtype=torch.float32,
        device="cpu")
    rng = np.random.default_rng(5)
    seqs = [eng.make_sequence(rng.integers(3, 259, n).tolist())
            for n in (3, 5, 4, 9, 6)]
    fin, _ = eng.generate(params, seqs)
    assert len(fin) == len(seqs) and not eng.pool.pages_in_use
    for q in fin:
        toks = np.asarray(q.tokens, np.int32)[None]
        logits, _ = jax_forward(ref_params, ref_cfg,
                                {"tokens": jnp.asarray(toks)})
        logp = jax.nn.log_softmax(
            np.asarray(logits, np.float32)[0] / temp, axis=-1)
        want = [float(logp[t - 1, toks[0, t]])
                for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want,
                                   atol=FP32_TOL, rtol=FP32_TOL)


def test_continuous_engine_refuses_mla_as_the_reference_does():
    """The reference's continuous engine refuses the MLA moe config (the
    reduced DeepSeek-V2); the port's serves it, dropless, from a paged
    latent pool: each served logprob against the reference's forward,
    fp32, every token routed to every expert so that the reference's
    capacity drops nothing either."""
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg = ref_get_config("deepseek_v2_236b").reduced()
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    assert "attention='mla'" in str(want.value)
    ref_cfg = dataclasses.replace(ref_cfg, vocab_size=ByteTokenizer.vocab_size,
                                  compute_dtype="float32",
                                  top_k=ref_cfg.num_experts)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    eng = ContinuousBatchingEngine(_port_cfg(ref_cfg), num_slots=2,
                                   page_size=4, max_len=24,
                                   max_new_tokens=4, eos_id=-1, seed=3,
                                   dtype=torch.float32, device="cpu")
    assert eng.cfg.moe_dropless and eng.pool.latent is not None
    rng = np.random.default_rng(9)
    fin, _ = eng.generate(params, [eng.make_sequence(
        rng.integers(3, 259, n).tolist()) for n in (3, 6, 5)])
    assert len(fin) == 3
    for q in fin:
        toks = np.asarray(q.tokens, np.int32)[None]
        logits, _ = jax_forward(ref_params, ref_cfg,
                                {"tokens": jnp.asarray(toks)})
        logp = jax.nn.log_softmax(np.asarray(logits, np.float32)[0], -1)
        want_lp = [float(logp[t - 1, toks[0, t]])
                   for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want_lp,
                                   atol=FP32_TOL, rtol=FP32_TOL)


def test_trainer_fit_baseline_on_moe():
    """GRPO with KL, baseline mode, 2 steps on the reduced Grok with the
    continuous rollout backend."""
    import math
    from repro_torch.api import Trainer, TrainerConfig
    cfg = _port_cfg(_ref_cfg("grok_1_314b"))
    res = Trainer(TrainerConfig(
        arch="grok_1_314b", mode="baseline", rollout_backend="continuous",
        num_steps=2, prompts_per_step=2, group_size=2, max_new_tokens=4,
        seq_len=24, kl_coef=0.05, device="cpu"), model_cfg=cfg).fit()
    assert res.samples_trained == 8 and len(res.metrics) == 2
    for m in res.metrics:
        assert all(math.isfinite(m[k]) for k in ("loss", "grad_norm"))


def test_profile_reduced_blocks_on_moe():
    from repro_torch.configs import get_config
    from repro_torch.core.planner.profiling import profile_reduced_blocks
    prof = profile_reduced_blocks(get_config("grok_1_314b"), device="cpu")
    assert prof["reduced_cfg"].arch_type == "moe"
    assert prof["reduced_decode_s"] > 0 and prof["reduced_train_s"] > 0


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_grok_on_cpu(launcher, capsys):
    from repro_torch.launch import serve, train
    if launcher == "serve":
        rc = serve.main(["--device", "cpu", "--arch", "grok_1_314b",
                         "--engine", "continuous", "--requests", "3",
                         "--max-new-tokens", "4"])
    else:
        rc = train.main(["--device", "cpu", "--arch", "grok_1_314b",
                         "--steps", "1", "--prompts-per-step", "2",
                         "--group-size", "2", "--max-new-tokens", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "grok_1_314b" and out["device"] == "cpu"
