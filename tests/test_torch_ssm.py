"""The port's ssm family (Falcon-Mamba) against the reference on the same
numbers: the plain ``mamba_scan`` against the Pallas kernel in interpret
mode and the reference's oracle; ``mamba_full`` through its three routes
and ``mamba_decode``; the param tree; ``forward`` and step-by-step decode;
one GRPO gradient step; ``Trainer.fit``; and the refusals.

Params come from the reference (``models/convert.py``) on a reduced
``falcon_mamba_7b`` (2 layers, d_model 256, d_inner 512, N 16, dt_rank
16, byte vocab). fp32 unless noted. The port's plain ``mamba_scan`` is a
sequential sum like the reference's oracle, so against the Pallas kernel
the order of the products differs; the port's training routes scan in log
depth, as the reference's do."""
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
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.kernels.mamba_scan import mamba_scan_ref as jax_mamba_scan_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jssm
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
from repro_torch.tree import tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
# fp32: the same sums, in another order (sequential here, associative in
# the Pallas kernel and the reference's plain route) -> 1e-5 relative on
# the scan, 1e-4 on logits after two layers and the vocab product.
SCAN_TOL = 1e-5
FP32_TOL = 1e-4
BF16_TOL = 2e-2


def _ref_cfg(compute_dtype="float32", **kw):
    return dataclasses.replace(
        ref_get_config("falcon_mamba_7b").reduced(),
        vocab_size=ByteTokenizer.vocab_size, compute_dtype=compute_dtype,
        **kw)


def _port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="float32"):
    ref_cfg = _ref_cfg(compute_dtype)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, _port_cfg(ref_cfg), params


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _scan_inputs(B, S, D, N, seed):
    """The reference kernel test's distributions: x, b, c normal, dt =
    0.1 softplus(normal), A = -|normal|."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, D)
    dt = (0.1 * np.log1p(np.exp(f(B, S, D)))).astype(np.float32)
    a = -np.abs(f(D, N))
    return x, dt, a, f(B, S, N), f(B, S, N)


@pytest.mark.parametrize("B,S,D,N", [(1, 128, 128, 16), (2, 256, 256, 8)])
def test_plain_scan_matches_pallas_kernel(B, S, D, N):
    """At the reference kernel test's shapes (they tile, so the reference
    runs its Pallas kernel, in interpret mode here)."""
    ins = _scan_inputs(B, S, D, N, seed=S + N)
    want = jax_mamba_scan(*map(jnp.asarray, ins))
    got = mamba_scan(*map(torch.from_numpy, ins))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("B,S,D,N", [(2, 79, 96, 16), (1, 33, 40, 8)])
def test_plain_scan_matches_reference_oracle_on_ragged_shapes(B, S, D, N):
    """S and D that do not tile (the reference's wrapper takes its oracle
    there; the port's kernel masks them in place)."""
    ins = _scan_inputs(B, S, D, N, seed=S)
    want = jax_mamba_scan_ref(*map(jnp.asarray, ins))
    _close(mamba_scan(*map(torch.from_numpy, ins)), want, SCAN_TOL)
    # strided B and C views, as the model hands them over, and bf16 x
    x, dt, a, b, c = map(torch.from_numpy, ins)
    bc = torch.cat([torch.zeros(B, S, 5), b, c], dim=-1)
    _close(mamba_scan_ref(x.bfloat16(), dt, a, bc[..., 5:5 + N],
                          bc[..., 5 + N:]),
           jax_mamba_scan_ref(jnp.asarray(ins[0], jnp.bfloat16),
                              *map(jnp.asarray, ins[1:])), SCAN_TOL)


def test_scan_wrapper_raises_under_grad_on_the_card_path(monkeypatch):
    """The kernel has no backward: on the CUDA path, inputs that require
    grad under grad mode raise rather than lose their gradient; under
    no_grad the call goes on to its checks. On the CPU the plain version
    runs and is differentiable."""
    x, dt, a, b, c = map(torch.from_numpy, _scan_inputs(1, 4, 8, 8, 0))
    x.requires_grad_()
    mamba_scan(x, dt, a, b, c).sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    n = mamba_scan.launches
    with pytest.raises(RuntimeError, match="no backward"):
        mamba_scan(x, dt, a, b, c)
    with torch.no_grad():
        with pytest.raises(ValueError, match="N in"):
            mamba_scan(x, dt, a[:, :5], b[..., :5], c[..., :5])
        with pytest.raises(ValueError, match="unsupported shapes"):
            mamba_scan(x, dt[:, :3], a, b, c)
    assert mamba_scan.launches == n


def _layer0(tree):
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("route", ["kernel", "chunked", "plain"])
def test_mamba_full_routes_match_reference(route):
    """One block, layer 0 of the reduced model: the kernel flag (plain
    version here, Pallas in interpret mode in the reference), the chunked
    scan (chunk 4 of S=8) and the plain scan."""
    ref_cfg, ref_params, cfg, params = _setup()
    chunk = 4 if route == "chunked" else 0
    pj = jax.tree.map(lambda a: a[0], ref_params["blocks"]["mamba"])
    pt = _layer0(params["blocks"]["mamba"])
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    want = jssm.mamba_full(pj, jnp.asarray(x), ref_cfg,
                           use_pallas=route == "kernel", chunk=chunk)
    xt = torch.from_numpy(x).requires_grad_(route != "kernel")
    got = tssm.mamba_full(pt, xt, cfg, use_kernels=route == "kernel",
                          chunk=chunk)
    _close(got, want, FP32_TOL)
    if route != "kernel":     # the training routes are differentiable
        got.sum().backward()
        assert float(xt.grad.abs().max()) > 0


@pytest.mark.parametrize("route", ["chunked", "plain"])
def test_mamba_full_training_routes_grads_match_jax(route):
    """The two training routes scan in log depth, as the reference's do:
    outputs and the gradients of a weighted sum with respect to the input
    and every parameter of the block, against ``jax.grad`` of the
    reference's route on the same numbers, within 1e-4 relative (chunk 4
    of S=12, so the carry crosses two chunk edges)."""
    ref_cfg, ref_params, cfg, params = _setup()
    chunk = 4 if route == "chunked" else 0
    pj = jax.tree.map(lambda a: a[0], ref_params["blocks"]["mamba"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def loss_j(p, xx):
        y = jssm.mamba_full(p, xx, ref_cfg, chunk=chunk)
        return jnp.sum(y * w), y
    (_, want), (gp_j, gx_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(pj, jnp.asarray(x))

    pt = tree_map(lambda t: t.clone().requires_grad_(),
                  _layer0(params["blocks"]["mamba"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = tssm.mamba_full(pt, xt, cfg, chunk=chunk)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got, want, FP32_TOL)

    def rel(a, b):
        b = np.asarray(b, np.float64)
        return np.linalg.norm(a.detach().numpy() - b) / max(
            np.linalg.norm(b), 1e-30)
    assert rel(xt.grad, gx_j) < 1e-4
    flat_t = _flat(pt)
    for k, g in _flat(gp_j).items():
        assert flat_t[k].grad is not None, k
        assert rel(flat_t[k].grad, g) < 1e-4, k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def test_mamba_decode_matches_reference_and_keeps_fp32_state():
    ref_cfg, ref_params, cfg, params = _setup("bfloat16")
    pj = jax.tree.map(lambda a: a[0], ref_params["blocks"]["mamba"])
    pt = _layer0(params["blocks"]["mamba"])
    cj = jax.tree.map(lambda a: a[0], jssm.init_mamba_cache(ref_cfg, 2))
    cache = init_cache(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert {k: v.dtype for k, v in cache.items()} == {
        "h": torch.float32, "conv": torch.float32}
    ct = _layer0(cache)
    rng = np.random.default_rng(5)
    for _ in range(5):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        yj, cj = jssm.mamba_decode(pj, jnp.asarray(x, jnp.bfloat16), cj,
                                   ref_cfg)
        yt, ct = tssm.mamba_decode(pt, torch.from_numpy(x).bfloat16(), ct,
                                   cfg)
        _close(yt, yj, BF16_TOL)
    _close(ct["h"], cj["h"], BF16_TOL)
    _close(ct["conv"], cj["conv"], BF16_TOL)
    # the layer views wrote through to the stacked cache
    assert torch.equal(cache["h"][0], ct["h"])


def test_init_params_matches_reference_tree():
    """Keys, shapes and dtypes of ``init_params`` against the reference's
    tree, and the reference's deterministic leaves (A, dt bias, D-skip)."""
    ref_cfg, ref_params, cfg, _ = _setup()
    params = init_params(3, cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (_, t), (_, a) in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    m, mj = params["blocks"]["mamba"], ref_params["blocks"]["mamba"]
    for t, a in ((m["a_log"], mj["a_log"]), (m["d_skip"], mj["d_skip"]),
                 (m["conv_b"], mj["conv_b"]),
                 (m["dt_proj"]["b"], mj["dt_proj"]["b"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-7)
    assert abs(float(m["conv_w"].std()) - 0.1) < 5e-3
    assert abs(float(m["in_proj"]["w"].std()) - 0.02) < 1e-3


def test_forward_and_decode_match_reference_fp32():
    """Logits of a full forward (the kernel route, its plain version here)
    and of step-by-step decode from a zero state, against the reference's
    forward. The reference's own test holds ssm decode to 3e-2; fp32
    differs only in summation order, so 1e-4 here."""
    ref_cfg, ref_params, cfg, params = _setup()
    toks = np.random.default_rng(1).integers(
        3, cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jax_forward(ref_params, ref_cfg,
                          {"tokens": jnp.asarray(toks)}, use_pallas=True)
    with torch.no_grad():
        got, aux = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert aux == 0.0
    _close(got, want, FP32_TOL)
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
        _close(lt, lj, FP32_TOL)
        _close(lt, want[:, t], FP32_TOL)
    with pytest.raises(ValueError, match="no prefill cache"):
        forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                return_cache=True)


def test_bf16_forward_matches_reference():
    ref_cfg, ref_params, cfg, params = _setup("bfloat16")
    toks = np.random.default_rng(3).integers(
        3, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jax_forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


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
    """One GRPO micro-batch with KL on the reduced model: the metrics and
    every parameter's gradient against the reference's jitted
    ``_grad_microbatch`` (plain scan both sides) within 1e-4 relative;
    every mamba parameter gets a nonzero gradient."""
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
    for a, b in zip(got, jax.tree.leaves(g_ref)):
        b = np.asarray(b, np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert a.shape == b.shape and rel < 1e-4
    for k, g in grads["blocks"]["mamba"].items():
        leaves = g.values() if isinstance(g, dict) else [g]
        assert all(float(t.abs().max()) > 0 for t in leaves), k


def test_trainer_fit_on_ssm_without_jax():
    """GRPO with the KL stage on the reduced Falcon-Mamba, fixed rollout
    backend, in a process that never imports JAX."""
    code = (
        "import sys\n"
        "from repro_torch.api import Trainer, TrainerConfig\n"
        "res = Trainer(TrainerConfig(arch='falcon_mamba_7b', device='cpu',"
        " num_steps=2, prompts_per_step=2, group_size=2, max_new_tokens=4,"
        " kl_coef=0.05)).fit()\n"
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


def test_continuous_engine_refuses_ssm_as_the_reference_does():
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.api import Trainer, TrainerConfig
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg, _, cfg, _ = _setup()
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(cfg, device="cpu")
    assert "continuous batching supports" in str(got.value)
    assert "arch_type='ssm'" in str(got.value)
    assert str(got.value).split("(got")[1] == str(want.value).split("(got")[1]
    tr = Trainer(TrainerConfig(arch="falcon_mamba_7b", device="cpu",
                               num_steps=1, prompts_per_step=1, group_size=2,
                               max_new_tokens=2, supervise=False,
                               rollout_backend="continuous"))
    # the engine is built lazily by the first generate call, whose error
    # fails the run, as in the reference
    with pytest.raises(RuntimeError,
                       match="ValueError.*continuous batching supports"):
        tr.fit()
