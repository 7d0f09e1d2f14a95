"""The port's hybrid family (Griffin / RecurrentGemma) against the reference
on the same numbers: the plain ``rglru_scan`` against the Pallas kernel in
interpret mode and the reference's oracle; ``rglru_full`` through both
routes and ``rglru_decode``; the param tree; ``forward`` and step-by-step
decode over a ring that wraps; the fixed engine; one GRPO gradient step;
``Trainer.fit``; and the refusals.

Params come from the reference (``models/convert.py``) on a reduced
``recurrentgemma_9b`` (d_model 256, 4 heads, 1 KV head, hd 64, rnn_width
256, byte vocab) at 4 layers, one (recurrent, recurrent, attention) tile
and one recurrent remainder layer (the reference's own hybrid test), and
at 6, two tiles. fp32 unless noted. The port's kernel route scans
sequentially like the reference's oracle; the Pallas kernel, the
reference's plain route and the port's training route scan associatively,
each in its own order of the products."""
import dataclasses
import functools
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
from repro.engines.train_engine import _grad_microbatch
from repro.engines.train_engine import pack_rows as ref_pack_rows
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.rglru_scan import rglru_scan_ref as jax_rglru_scan_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import rglru as jrglru
from repro.models.transformer import forward_lm as jax_forward_lm
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import rglru as trglru
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step

SRC = Path(__file__).resolve().parents[1] / "src"
# The reference kernel test's bar for the Pallas scan against its oracle
# (a up to 0.999 over 512 steps carries rounding with a gain near 1/(1-a)).
KERNEL_TOL = 2e-4
# The sequential oracle against the port's plain version: the same products
# in the same order -> 1e-5.
SCAN_TOL = 1e-5
# fp32 logits and block outputs: the same sums in another order (scan
# order, summation order of the products) -> 1e-4.
FP32_TOL = 1e-4
BF16_TOL = 2e-2
WINDOW = 8        # local attention window, so that 20 tokens wrap the ring


def _ref_cfg(compute_dtype="float32", num_layers=4):
    return dataclasses.replace(
        ref_get_config("recurrentgemma_9b").reduced(),
        vocab_size=ByteTokenizer.vocab_size, compute_dtype=compute_dtype,
        num_layers=num_layers, local_window=WINDOW)


def _port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="float32", num_layers=4):
    ref_cfg = _ref_cfg(compute_dtype, num_layers)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, _port_cfg(ref_cfg), params


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _scan_inputs(B, S, W, seed):
    """The reference kernel test's distributions: a ~ U[0.4, 0.999],
    b normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, (B, S, W)).astype(np.float32)
    return a, rng.standard_normal((B, S, W)).astype(np.float32)


@pytest.mark.parametrize("B,S,W", [(1, 256, 128), (2, 512, 256),
                                   (3, 128, 384)])
def test_plain_scan_matches_pallas_kernel(B, S, W):
    """At the reference kernel test's shapes (they tile, so the reference
    runs its Pallas kernel, in interpret mode here)."""
    a, b = _scan_inputs(B, S, W, seed=S + W)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    _close(got, want, KERNEL_TOL)


def test_plain_scan_carries_across_pallas_block_boundaries():
    """The reference's carry test: a = 0.9, b = 1 over four 128-step
    blocks of the Pallas kernel, which converge to 10, at its bars."""
    a, b = np.full((1, 512, 128), 0.9, np.float32), np.ones((1, 512, 128),
                                                            np.float32)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=128)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-4)
    assert abs(float(got[0, -1, 0]) - 10.0) < 1e-4


@pytest.mark.parametrize("B,S,W", [(2, 79, 96), (1, 33, 40)])
def test_plain_scan_matches_reference_oracle_on_ragged_shapes(B, S, W):
    """S and W that do not tile (the reference's wrapper takes its oracle
    there; the port's kernel masks them in place); bf16 inputs are cast to
    fp32 on both sides."""
    a, b = _scan_inputs(B, S, W, seed=S)
    want = jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    _close(rglru_scan(torch.from_numpy(a), torch.from_numpy(b)), want,
           SCAN_TOL)
    got = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    _close(got, jax_rglru_scan_ref(jnp.asarray(a),
                                   jnp.asarray(b, jnp.bfloat16)), SCAN_TOL)


def test_scan_wrapper_raises_under_grad_on_the_card_path(monkeypatch):
    """The kernel has no backward: on the CUDA path, inputs that require
    grad under grad mode raise rather than lose their gradient; under
    no_grad the call goes on to its checks. On the CPU the plain version
    runs and is differentiable."""
    a, b = map(torch.from_numpy, _scan_inputs(1, 4, 8, 0))
    b.requires_grad_()
    rglru_scan(a, b).sum().backward()
    assert b.grad is not None and float(b.grad.abs().max()) > 0
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    n = rglru_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(a, b)
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported shapes"):
            rglru_scan(a, b[:, :3])
        with pytest.raises(ValueError, match="unsupported shapes"):
            rglru_scan(a[0], b[0])
    assert rglru_scan.launches == n


def _tile_rec0(tree):
    """Tile 0's first recurrent block, as a tree of views."""
    def first(t):
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return first(tree["tiles"]["0_recurrent"]["rec"])


@pytest.mark.parametrize("route", ["kernel", "associative"])
def test_rglru_full_routes_match_reference(route):
    """One block, tile 0's first recurrent layer: the kernel flag (plain
    version here, the Pallas kernel in interpret mode in the reference)
    and the training route (the associative scan on both sides), on 64
    steps so that the scans cross several levels."""
    ref_cfg, ref_params, cfg, params = _setup()
    pj = jax.tree.map(lambda a: a[0],
                      ref_params["tiles"]["0_recurrent"]["rec"])
    pt = _tile_rec0(params)
    x = np.random.default_rng(2).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    want = jrglru.rglru_full(pj, jnp.asarray(x), ref_cfg,
                             use_pallas=route == "kernel")
    xt = torch.from_numpy(x).requires_grad_(route != "kernel")
    got = trglru.rglru_full(pt, xt, cfg, use_kernels=route == "kernel")
    _close(got, want, FP32_TOL)
    if route != "kernel":     # the training route is differentiable
        got.sum().backward()
        assert float(xt.grad.abs().max()) > 0


def test_associative_scan_matches_sequential_scan():
    """The training route's scan against the plain sequential one, at a
    length that is not a power of two and with a up to 0.999."""
    a, b = map(torch.from_numpy, _scan_inputs(2, 100, 24, 9))
    prod, h = trglru.associative_scan(a, b)
    _close(h, rglru_scan_ref(a, b).numpy(), SCAN_TOL * 10)
    _close(prod, torch.cumprod(a.double(), dim=1).numpy(), SCAN_TOL)


def test_rglru_decode_matches_reference_and_keeps_fp32_state():
    ref_cfg, ref_params, cfg, params = _setup("bfloat16")
    pj = jax.tree.map(lambda a: a[0],
                      ref_params["tiles"]["0_recurrent"]["rec"])
    pt = _tile_rec0(params)
    cj = jax.tree.map(lambda a: a[0], jrglru.init_rglru_cache(ref_cfg, 2, 1))
    cache = init_cache(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert {k: v.dtype for k, v in cache["rec"].items()} == {
        "h": torch.float32, "conv": torch.float32}
    assert cache["att"]["k"].dtype == torch.bfloat16
    ct = {k: v[0] for k, v in cache["rec"].items()}
    rng = np.random.default_rng(5)
    for _ in range(6):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, cj = jrglru.rglru_decode(pj, jnp.asarray(x, jnp.bfloat16), cj,
                                     ref_cfg)
        yt, ct = trglru.rglru_decode(pt, torch.from_numpy(x).bfloat16(), ct,
                                     cfg)
        _close(yt, yj, BF16_TOL)
    _close(ct["h"], cj["h"], BF16_TOL)
    _close(ct["conv"], cj["conv"], BF16_TOL)
    # the layer views wrote through to the stacked cache
    assert torch.equal(cache["rec"]["h"][0], ct["h"])


@pytest.mark.parametrize("num_layers", [4, 6])
def test_init_params_matches_reference_tree(num_layers):
    """Keys, shapes and dtypes of ``init_params`` against the reference's
    tree (the stacked ``tiles`` and the ``rem`` list), and the RG-LRU's
    init scales: a = exp(-8 softplus(lambda)) in [0.9, 0.999], conv_w
    0.1 normal, conv_b 0."""
    ref_cfg, ref_params, cfg, _ = _setup(num_layers=num_layers)
    params = init_params(3, cfg, device="cpu")
    assert ("rem" in params) == (num_layers % 3 != 0)
    assert isinstance(params.get("rem", []), list)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (_, t), (_, a) in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    rec = params["tiles"]["0_recurrent"]["rec"]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(rec["lambda"]))
    assert float(a.min()) >= 0.9 - 1e-5 and float(a.max()) <= 0.999 + 1e-5
    assert abs(float(rec["conv_w"].std()) - 0.1) < 5e-3
    assert float(rec["conv_b"].abs().max()) == 0.0
    assert abs(float(rec["gate_a"]["w"].std()) - 0.02) < 1e-3


@pytest.mark.parametrize("num_layers", [4, 6])
def test_forward_and_decode_match_reference_fp32(num_layers):
    """Logits of a full forward (the kernel route, plain versions here) and
    of step-by-step decode over 20 tokens with a ring of WINDOW = 8 keys,
    which wraps, against the reference's. The decode keeps the reference's
    bf16 KV cache against the reference's decode; with an fp32 cache it
    matches the fp32 forward too. The prefill cache holds the tiles'
    attention K/V, as the reference's."""
    ref_cfg, ref_params, cfg, params = _setup(num_layers=num_layers)
    toks = np.random.default_rng(1).integers(
        3, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jax_forward(ref_params, ref_cfg,
                          {"tokens": jnp.asarray(toks)}, use_pallas=True)
    with torch.no_grad():
        got, aux, kv = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                               return_cache=True)
    assert aux == 0.0
    _close(got, want, FP32_TOL)
    _, _, kvj = jax_forward_lm(ref_params, ref_cfg, jnp.asarray(toks),
                               return_cache=True)
    for name in ("k", "v"):
        _close(kv["att_kv"][name], kvj["att_kv"][name], FP32_TOL)
    cj = jax_init_cache(ref_cfg, 2, 20)
    ct = init_cache(cfg, 2, 20, device="cpu")
    c32 = init_cache(cfg, 2, 20, dtype=torch.float32, device="cpu")
    assert ct["att"]["k"].shape[2] == WINDOW
    for t in range(toks.shape[1]):
        pos = np.full(2, t, np.int32)
        lj, cj = jax_decode_step(ref_params, ref_cfg, cj,
                                 jnp.asarray(toks[:, t]), jnp.asarray(pos))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct,
                                 torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos))
            l32, c32 = decode_step(params, cfg, c32,
                                   torch.from_numpy(toks[:, t]),
                                   torch.from_numpy(pos))
        _close(lt, lj, FP32_TOL)
        _close(l32, want[:, t], FP32_TOL)
    for name, t in ct["rec"].items():
        _close(t, cj["rec"][name], FP32_TOL)
    # bf16 K/V: fp32 values a rounding apart may round to neighbours
    for name, t in ct["att"].items():
        _close(t, cj["att"][name], BF16_TOL)


def test_bf16_forward_and_decode_match_reference():
    ref_cfg, ref_params, cfg, params = _setup("bfloat16")
    toks = np.random.default_rng(3).integers(
        3, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jax_forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                         use_kernels=False)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    cj = jax_init_cache(ref_cfg, 2, 12)
    ct = init_cache(cfg, 2, 12, device="cpu")
    for t in range(toks.shape[1]):
        pos = np.full(2, t, np.int32)
        lj, cj = jax_decode_step(ref_params, ref_cfg, cj,
                                 jnp.asarray(toks[:, t]), jnp.asarray(pos))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct,
                                 torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos))
        _close(lt, lj, BF16_TOL)


def test_fixed_engine_logprobs_match_forward():
    """The fixed engine (``rl.sampling.generate``) on the hybrid, 4 prompts
    past the window so the ring wraps. It keeps a bf16 KV cache, as the
    reference's does, so its logprobs are scored by the reference's decode
    steps over the same cache dtype, fed the port's tokens (teacher-forced,
    as sampled tokens cannot match the reference's)."""
    from repro_torch.rl import generate
    ref_cfg, ref_params, cfg, params = _setup()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 259, n).astype(np.int32) for n in (3, 9, 13,
                                                                 5)]
    rows = generate(params, cfg, prompts, 0, max_new_tokens=6,
                    temperature=0.8, eos_id=-1, device="cpu")
    toks = np.stack([r["tokens"] for r in rows]).astype(np.int32)
    B, total = toks.shape
    assert total > WINDOW
    cache = jax_init_cache(ref_cfg, B, total)
    want = np.zeros((B, total), np.float32)
    for t in range(total - 1):
        logits, cache = jax_decode_step(ref_params, ref_cfg, cache,
                                        jnp.asarray(toks[:, t]),
                                        jnp.full((B,), t, jnp.int32))
        logp = np.asarray(jax.nn.log_softmax(
            logits.astype(jnp.float32) / 0.8))
        want[:, t + 1] = logp[np.arange(B), toks[:, t + 1]]
    for i, r in enumerate(rows):
        assert (r["tokens"][:r["prompt_len"]] == prompts[i]).all()
        np.testing.assert_allclose(r["logprobs"][r["prompt_len"]:],
                                   want[i, r["prompt_len"]:],
                                   atol=FP32_TOL, rtol=FP32_TOL)


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


def test_grpo_grad_step_matches_reference():
    """One GRPO micro-batch with KL on the reduced 4-layer model, over
    sequences longer than the window: the metrics and every parameter's
    gradient against the reference's jitted ``_grad_microbatch`` (the
    associative scan and ``sdpa`` both sides) within 1e-4 relative; every
    RG-LRU and attention parameter gets a nonzero gradient."""
    ref_cfg, ref_params, cfg, params = _setup()
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
        assert a.shape == b.shape and rel < 1e-4
    watched = [grads["tiles"]["0_recurrent"]["rec"],
               grads["tiles"]["2_attention"]["attn"],
               grads["rem"][0]["rec"]]
    for tree in watched:
        for k, g in tree.items():
            leaves = g.values() if isinstance(g, dict) else [g]
            assert all(float(t.abs().max()) > 0 for t in leaves), k


def test_trainer_fit_on_hybrid_without_jax():
    """GRPO with the KL stage on the hybrid at 4 layers (one tile and a
    remainder layer) and a window the responses cross, fixed rollout
    backend, in a process that never imports JAX."""
    code = (
        "import dataclasses, sys\n"
        "from repro_torch.api import Trainer, TrainerConfig\n"
        "from repro_torch.configs import get_config\n"
        "cfg = dataclasses.replace(get_config('recurrentgemma_9b')"
        ".reduced(), num_layers=4, local_window=8, vocab_size=259)\n"
        "res = Trainer(TrainerConfig(arch='recurrentgemma_9b', device='cpu',"
        " num_steps=2, prompts_per_step=2, group_size=2, max_new_tokens=4,"
        " kl_coef=0.05), model_cfg=cfg).fit()\n"
        "assert res.samples_trained == 8, res.samples_trained\n"
        "assert max(res.staleness_seen) <= 2, res.staleness_seen\n"
        "assert len(res.metrics) == 2, res.metrics\n"
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


def test_continuous_engine_refuses_hybrid_as_the_reference_does():
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg, _, cfg, _ = _setup()
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(cfg, device="cpu")
    assert "continuous batching supports" in str(got.value)
    assert "arch_type='hybrid'" in str(got.value)
    assert str(got.value).split("(got")[1] == str(want.value).split("(got")[1]
