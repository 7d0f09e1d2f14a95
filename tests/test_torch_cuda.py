"""The port on the card: each CUDA kernel against its plain PyTorch version,
the fused loss's autograd Function, the serving engine on CUDA against a
CPU forward, and the trainer on the card. Every test takes the
``cuda_device`` fixture and skips where there is no card. The file imports
neither JAX nor the reference, so on a machine with a card and no JAX it
runs alone: ``PYTHONPATH=src python -m pytest --noconftest
tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_rl_loss import (fused_rl_loss,
                                               fused_rl_loss_bwd,
                                               fused_rl_loss_bwd_ref,
                                               fused_rl_loss_bwd_tolerance,
                                               fused_rl_loss_fwd,
                                               fused_rl_loss_fwd_ref,
                                               fused_rl_loss_oracle)
from repro_torch.kernels.grpo_logprob import grpo_logprob, grpo_logprob_ref

# fp32: summation order differs on the card; bf16: one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fused_rl_loss backward: relative to each element of dx (one rounding)
DX_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 32),
    (2, 128, 4, 4, 128), (2, 100, 4, 2, 64), (4, 1000, 28, 4, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 64])
def test_flash_kernel_matches_plain(cuda_device, B, S, H, KV, hd, dtype,
                                    window):
    gen = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q = _randn(gen, (B, S, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    n = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    ref = flash_attention_ref(q, k, v, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 1024, 4, 2, 64), (1, 2048, 8, 8, 32), (3, 512, 4, 1, 128),
    (3, 100, 4, 2, 64), (4, 4099, 28, 4, 128), (2, 5, 16, 1, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda_device, B, S, H, KV, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    fill = np.random.default_rng(S).integers(1, S + 1, size=B)
    fill[0] = 0                          # no valid key: uniform average
    valid = torch.from_numpy(np.arange(S)[None, :] < fill[:, None]).to(
        cuda_device)
    n = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    ref = decode_attention_ref(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)     # hd 48
    ones = torch.ones((1, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported shapes"):
        decode_attention(q[:, :1], q, q, ones)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_engine_on_card_matches_cpu_forward(cuda_device):
    """Serve a reduced model on the card (both kernels run), then score the
    sampled tokens with a CPU forward over the same weights (fp32)."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device=cuda_device)
    eng = ContinuousBatchingEngine(cfg, num_slots=2, max_len=64,
                                   max_new_tokens=6, eos_id=-1,
                                   dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(0)
    seqs = [eng.make_sequence(rng.integers(3, 259, n)) for n in (5, 17, 9)]
    n_d, n_f = decode_attention.launches, flash_attention.launches
    fin, _ = eng.generate(params, seqs)
    assert decode_attention.launches > n_d and flash_attention.launches > n_f
    assert len(fin) == 3 and eng.pool.pages_in_use == 0
    cpu = _to_cpu(params)
    for q in fin:
        toks = torch.tensor(q.tokens)[None]
        with torch.no_grad():
            logits, _ = forward(cpu, cfg, {"tokens": toks})
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        want = [logp[t - 1, q.tokens[t]].item()
                for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want,
                                   atol=1e-4, rtol=1e-4)


# The vocab-streaming kernels at the trainer's shapes: a micro-batch of
# 4 rows x 79 tokens, 4096 rows, full Qwen2.5 vocab; V=259 (byte vocab:
# bf16 rows start at 518-byte offsets, off the 16-byte grid) and 2053.
VOCAB_SHAPES = [(7, 259), (5, 2053), (316, 152064), (4096, 152064)]


def _loss_inputs(gen, N, V, dtype, device):
    x = (4 * torch.randn((N, V), generator=gen, device=device)).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device=device)
    old = torch.randn(N, generator=gen, device=device) * 0.3 - 5.0
    ref = old + 0.1 * torch.randn(N, generator=gen, device=device)
    adv = torch.randn(N, generator=gen, device=device)
    return x, t, old, ref, adv


def _assert_close_rel(out, ref, tol):
    """|out - ref| <= tol + tol*|ref| elementwise."""
    out, ref = out.float(), ref.float()
    bad = (out - ref).abs() > tol + tol * ref.abs()
    assert not bool(bad.any()), float((out - ref).abs().max())


@pytest.mark.parametrize("N,V", VOCAB_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_vocab_kernels_match_plain(cuda_device, N, V, dtype):
    """grpo_logprob and fused_rl_loss forward: the (N,) fp32 outputs within
    1e-4 + 1e-4*|ref| in both input dtypes (bf16 converts to fp32 exactly
    on load); backward dx within 1e-4 (fp32) or 1e-2 (bf16, one rounding)
    of each element, plus 1e-5 of its terms where they cancel
    (``fused_rl_loss_bwd_tolerance``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(N + V)
    x, t, old, ref, adv = _loss_inputs(gen, N, V, dtype, cuda_device)
    n = (grpo_logprob.launches, fused_rl_loss_fwd.launches,
         fused_rl_loss_bwd.launches)
    lp, ent = grpo_logprob(x, t)
    outs = fused_rl_loss_fwd(x, t, old, ref, adv)
    dlp = torch.randn(N, generator=gen, device=cuda_device)
    g_ent = torch.randn(N, generator=gen, device=cuda_device)
    dx = fused_rl_loss_bwd(x, t, outs[5], outs[5] - outs[1], dlp, g_ent)
    torch.cuda.synchronize()
    assert (grpo_logprob.launches, fused_rl_loss_fwd.launches,
            fused_rl_loss_bwd.launches) == tuple(c + 1 for c in n)
    for o, r in zip((lp, ent), grpo_logprob_ref(x, t)):
        _assert_close_rel(o, r, 1e-4)
    for o, r in zip(outs, fused_rl_loss_fwd_ref(x, t, old, ref, adv)):
        _assert_close_rel(o, r, 1e-4)
    assert dx.dtype == dtype and dx.shape == x.shape
    stats = (outs[5], outs[5] - outs[1], dlp, g_ent)
    want = fused_rl_loss_bwd_ref(x, t, *stats)
    limit = fused_rl_loss_bwd_tolerance(x, t, *stats, want, DX_RTOL[dtype])
    err = (dx.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


@pytest.mark.parametrize("N,V", [(13, 259), (9, 2053)])
def test_fused_rl_loss_function_backward_on_card(cuda_device, N, V):
    """The autograd Function's gradients (kernel backward for dlogits) vs
    autograd through the unfused oracle, fp32, within 1e-4 relative."""
    gen = torch.Generator(device=cuda_device).manual_seed(V)
    x, t, old, ref, adv = _loss_inputs(gen, N, V, torch.float32,
                                       cuda_device)
    cts = [torch.randn(N, generator=gen, device=cuda_device)
           for _ in range(5)]
    grads = []
    for fn in (fused_rl_loss, fused_rl_loss_oracle):
        ins = [a.clone().requires_grad_() for a in (x, old, ref, adv)]
        outs = fn(ins[0], t, *ins[1:])
        total = sum((o * c).sum() for o, c in zip(outs, cts))
        grads.append(torch.autograd.grad(total, ins))
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) < 1e-4


def test_flash_raises_under_grad_on_card(cuda_device):
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape


def test_grpo_grads_on_card_match_cpu(cuda_device):
    """One GRPO micro-batch of a reduced model, fp32 compute: the card's
    gradients (plain attention route, fused-loss kernels) match the CPU's
    within 1e-4 relative, and the attention weights get their gradient."""
    from repro_torch.engines import pack_rows
    from repro_torch.models import init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    rows = {"response": [rng.integers(3, 259, 20) for _ in range(4)],
            "logprob": [np.full(20, -5.5, np.float32)] * 4,
            "response_mask": [np.r_[np.zeros(5), np.ones(15)]] * 4,
            "advantage": [1.0, -1.0, 0.5, -0.5],
            "ref_logprob": [np.full(20, -5.4, np.float32)] * 4}
    rl = GRPOConfig(kl_coef=0.1)
    n = fused_rl_loss_bwd.launches
    g_cpu, m_cpu = grpo_grad_step(params, cfg, rl,
                                  pack_rows(rows, 24, "cpu"))
    g_gpu, m_gpu = grpo_grad_step(_to(params, cuda_device), cfg, rl,
                                  pack_rows(rows, 24, cuda_device))
    assert fused_rl_loss_bwd.launches == n + 1
    for k in m_cpu:
        assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-4 * (
            1 + abs(float(m_cpu[k])))
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) < 1e-4
    for w in ("wq", "wk", "wv"):
        assert float(g_gpu["blocks"]["attn"][w]["w"].abs().max()) > 0


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_trainer_on_card_launches_every_kernel(cuda_device):
    """A reduced GRPO run with KL on the continuous backend: every kernel
    of the training path launches, staleness stays in bound."""
    from repro_torch.api import Trainer, TrainerConfig
    counters = (flash_attention, decode_attention, grpo_logprob,
                fused_rl_loss_fwd, fused_rl_loss_bwd)
    before = [c.launches for c in counters]
    res = Trainer(TrainerConfig(num_steps=2, prompts_per_step=2,
                                group_size=2, max_new_tokens=4, seq_len=24,
                                kl_coef=0.05,
                                rollout_backend="continuous")).fit()
    assert res.samples_trained == 8 and max(res.staleness_seen) <= 2
    assert all(c.launches > b for c, b in zip(counters, before))
