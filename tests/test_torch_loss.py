"""The port's RL loss kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX kernel in interpret mode (and ``jax.grad`` through the reference's
custom VJP) on the same inputs, made with numpy. ``tests/test_torch_cuda.py``
holds the CUDA kernels against the plain versions on the card.
Tolerances: 2e-5 in fp32 and 2e-2 in bf16 on values, gradients within 1e-4
relative in fp32 (the reference's own bars).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rl_loss import fused_rl_loss as ref_fused_rl_loss
from repro.kernels.grpo_logprob.grpo_logprob import grpo_logprob_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_rl_loss import (fused_rl_loss,
                                               fused_rl_loss_bwd,
                                               fused_rl_loss_bwd_ref,
                                               fused_rl_loss_bwd_tolerance,
                                               fused_rl_loss_fwd,
                                               fused_rl_loss_fwd_ref,
                                               fused_rl_loss_oracle)
from repro_torch.kernels.grpo_logprob import grpo_logprob, grpo_logprob_ref
from repro_torch.rl.loss import (clipped_policy_loss, fused_actor_loss,
                                 kl_penalty, token_logprobs, value_loss)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dtype="float32"):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(x)).to(tdt)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1.0))


@pytest.mark.parametrize("V", [259, 2048 + 5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grpo_logprob_plain_matches_jax_kernel(V, dtype):
    rng = np.random.default_rng(V)
    B, S = 3, 8
    x = (4 * rng.standard_normal((B, S, V))).astype(np.float32)
    t = rng.integers(0, V, (B, S))
    xj, xt = _pair(x, dtype)
    lp_j, ent_j = grpo_logprob_kernel(xj.reshape(-1, V),
                                      jnp.asarray(t.reshape(-1), jnp.int32),
                                      interpret=True)
    tol = DTYPES[dtype][2]
    lp, ent = token_logprobs(xt, torch.from_numpy(t))
    assert lp.shape == ent.shape == (B, S) and lp.dtype == torch.float32
    for out, ref in ((lp.reshape(-1), lp_j), (ent.reshape(-1), ent_j)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol,
                                   rtol=tol)
    lp2, ent2 = grpo_logprob_ref(xt.reshape(-1, V),
                                 torch.from_numpy(t.reshape(-1)))
    assert torch.equal(lp2, lp.reshape(-1)) and torch.equal(
        ent2, ent.reshape(-1))


def _fused_inputs(N, V, tie=False):
    rng = np.random.default_rng(N * 1000 + V)
    logits = (5 * rng.standard_normal((N, V))).astype(np.float32)
    tgt = rng.integers(0, V, N)
    old = (0.1 * rng.standard_normal(N) - 2.0).astype(np.float32)
    ref = (0.1 * rng.standard_normal(N) - 2.0).astype(np.float32)
    adv = rng.standard_normal(N).astype(np.float32)
    if tie:
        # rows where ratio*A == clip(ratio)*A with the ratio outside the
        # clip interval (A = 0): the tie rule picks the unclipped branch,
        # so dA = -g_pl*ratio there, not -g_pl*clip(ratio)
        logp = logits - np.log(np.exp(logits - logits.max(1, keepdims=True))
                               .sum(1, keepdims=True)) \
            - logits.max(1, keepdims=True)
        lp = logp[np.arange(N), tgt]
        old[::2] = lp[::2] - 0.5
        adv[::2] = 0.0
        adv[1::4] = 0.0          # and ties inside the interval
        old[1::4] = lp[1::4]
    return logits, tgt, old, ref, adv


@pytest.mark.parametrize("N,V,tie", [(16, 256, False), (13, 300, False),
                                     (12, 259, True)])
def test_fused_rl_loss_values_and_grads_match_reference(N, V, tie):
    logits, tgt, old, ref, adv = _fused_inputs(N, V, tie)
    cts = [np.random.default_rng(i).standard_normal(N).astype(np.float32)
           for i in range(5)]

    def ref_fn(lg, o, r, a):
        return ref_fused_rl_loss(lg, jnp.asarray(tgt, jnp.int32), o, r, a,
                                 use_pallas=True, block_n=8, block_v=128)

    ins_j = [jnp.asarray(a) for a in (logits, old, ref, adv)]
    outs_j, vjp = jax.vjp(ref_fn, *ins_j)
    grads_j = vjp(tuple(jnp.asarray(c) for c in cts))

    ins_t = [torch.from_numpy(a).requires_grad_() for a in
             (logits, old, ref, adv)]
    t_t = torch.from_numpy(tgt)
    n0, n1 = fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches
    outs_t = fused_rl_loss(ins_t[0], t_t, *ins_t[1:])
    for o_t, o_j in zip(outs_t, outs_j):
        assert o_t.shape == (N,) and o_t.dtype == torch.float32
        np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                                   atol=2e-5, rtol=2e-5)
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs_t, cts))
    grads_t = torch.autograd.grad(total, ins_t)
    for name, g_t, g_j in zip(("dlogits", "dold", "dref", "dadv"), grads_t,
                              grads_j):
        assert _rel(g_t.numpy(), g_j) < 1e-4, name
    # the CPU tensors took the plain versions: nothing was launched
    assert (fused_rl_loss_fwd.launches, fused_rl_loss_bwd.launches) == \
        (n0, n1)

    if tie:
        return   # autograd through torch.minimum splits a tie's gradient
    # and the unfused oracle (autograd through a log-softmax) agrees
    ins_o = [torch.from_numpy(a).requires_grad_() for a in
             (logits, old, ref, adv)]
    outs_o = fused_rl_loss_oracle(ins_o[0], t_t, *ins_o[1:])
    total_o = sum((o * torch.from_numpy(c)).sum()
                  for o, c in zip(outs_o, cts))
    for g_t, g_o in zip(grads_t, torch.autograd.grad(total_o, ins_o)):
        assert _rel(g_t.numpy(), g_o.numpy()) < 1e-4


def test_fused_rl_loss_bf16_and_batched_shape():
    """bf16 logits: values at the bf16 bar, dlogits in bf16; (B, S, V)
    logits reshape through, and targets get no gradient."""
    rng = np.random.default_rng(5)
    B, S, V = 2, 9, 260
    x = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    tgt = torch.from_numpy(rng.integers(0, V, (B, S)))
    zeros, ones = torch.zeros((B, S)), torch.ones((B, S))
    xj, xt = _pair(x, "bfloat16")
    xt.requires_grad_()
    outs = fused_rl_loss(xt, tgt, zeros, zeros, ones)
    refs = ref_fused_rl_loss(xj, jnp.asarray(tgt.numpy(), jnp.int32),
                             jnp.zeros((B, S)), jnp.zeros((B, S)),
                             jnp.ones((B, S)), use_pallas=True, block_n=8,
                             block_v=128)
    for o, r in zip(outs, refs):
        assert o.shape == (B, S)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=2e-2, rtol=2e-2)
    dx, = torch.autograd.grad(outs[3].sum(), xt)
    assert dx.dtype == torch.bfloat16 and dx.shape == (B, S, V)


def test_fused_rl_loss_backward_is_once_differentiable():
    """The backward kernel records no graph, so differentiating dx again
    raises instead of returning a gradient that silently lacks a term."""
    logits, tgt, old, ref, adv = (torch.from_numpy(np.asarray(a)) for a in
                                  _fused_inputs(4, 259))
    x = logits.requires_grad_()
    pl = fused_rl_loss(x, tgt, old, ref, adv)[3]
    dx, = torch.autograd.grad((pl * pl).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
def test_dx_tolerance_passes_another_route_and_fails_wrong_columns(dtype,
                                                                   rtol):
    """The limit the backward kernel is held to: dx computed in float64
    and rounded once passes it; a dx with every column below 2e-2 set to 0
    (most of a wide vocab's row), or off by 3*rtol, fails it."""
    rng = np.random.default_rng(11)
    N, V = 6, 4099
    x = torch.from_numpy(4 * rng.standard_normal((N, V))).to(dtype)
    t = torch.from_numpy(rng.integers(0, V, N))
    lp, ent, *_, lse = fused_rl_loss_fwd_ref(x, t, *torch.zeros((3, N)))
    dlp, g_ent = torch.from_numpy(rng.standard_normal((2, N))).float()
    stats = (lse, lse - ent, dlp, g_ent)
    want = fused_rl_loss_bwd_ref(x, t, *stats)
    limit = fused_rl_loss_bwd_tolerance(x, t, *stats, want, rtol)

    x64, xbar64 = x.double(), (lse - ent).double()[:, None]
    p = torch.exp(x64 - lse.double()[:, None])
    f64 = -p * (dlp.double()[:, None] + g_ent.double()[:, None]
                * (x64 - xbar64))
    f64[torch.arange(N), t] += dlp.double()
    other = f64.to(dtype)
    assert bool(((other.float() - want.float()).abs() <= limit).all())
    small = want.float().abs() < 2e-2
    assert small.float().mean() > 0.9
    for wrong in (torch.where(small, torch.zeros_like(want), want),
                  (want.float() * (1 + 3 * rtol)).to(dtype)):
        assert bool(((wrong.float() - want.float()).abs() > limit).any())


def test_fused_actor_loss_matches_unfused_composition():
    """Loss and stats of the fused actor loss against the unfused
    primitives (token_logprobs + clipped surrogate + k3 KL)."""
    rng = np.random.default_rng(3)
    B, S, V = 3, 7, 259
    logits = torch.from_numpy((2 * rng.standard_normal((B, S, V)))
                              .astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, V, (B, S)))
    old = torch.from_numpy((-5.5 + 0.3 * rng.standard_normal((B, S)))
                           .astype(np.float32))
    refl = old + 0.1
    adv = torch.from_numpy(rng.standard_normal(B).astype(np.float32))
    mask = torch.from_numpy((rng.random((B, S)) > 0.3).astype(np.float32))
    loss, stats = fused_actor_loss(logits, tgt, old, adv, mask,
                                   ref_logprob=refl, kl_coef=0.1,
                                   entropy_coef=0.01)
    lp, ent = token_logprobs(logits, tgt)
    pl, st = clipped_policy_loss(lp, old, adv, mask)
    kl = kl_penalty(lp, refl, mask)
    ent_mean = (ent * mask).sum() / mask.sum()
    want = pl + 0.1 * kl - 0.01 * ent_mean
    torch.testing.assert_close(loss, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(stats["policy_loss"], pl, atol=2e-5,
                               rtol=2e-5)
    for k in ("ratio_mean", "clip_frac"):
        torch.testing.assert_close(stats[k], st[k], atol=2e-5, rtol=2e-5)
    v = value_loss(lp, lp + 0.5, lp, mask)
    torch.testing.assert_close(v, torch.tensor(0.125), atol=1e-6,
                               rtol=1e-5)


def _as_if_on_card(monkeypatch):
    """Send CPU tensors down the wrappers' CUDA path."""
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)


def test_kernels_without_backward_raise_under_grad(monkeypatch):
    """flash_attention and grpo_logprob have no backward kernel: on the CUDA
    path, inputs that require grad under grad mode raise instead of losing
    their gradient; under no_grad the call goes on to the input checks."""
    _as_if_on_card(monkeypatch)
    q = torch.zeros((1, 8, 2, 32), requires_grad=True)
    x = torch.zeros((4, 259), requires_grad=True)
    t = torch.zeros(4, dtype=torch.long)
    n_f, n_g = flash_attention.launches, grpo_logprob.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="no backward"):
        grpo_logprob(x, t)
    with torch.no_grad():
        with pytest.raises(ValueError, match="one CUDA device"):
            flash_attention(q, q, q)
        with pytest.raises(ValueError, match="one CUDA device"):
            grpo_logprob(x, t)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q.detach(), q.detach(), q.detach())
    assert (flash_attention.launches, grpo_logprob.launches) == (n_f, n_g)
