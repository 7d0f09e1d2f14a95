"""The plain reference against plainer computations: attention by loops,
AdamW by its formula, and the port's own forward at a small size of each
configuration of ``BENCHMARK.json`` (the two are written apart; they
must agree)."""
import math

import numpy as np
import pytest
import torch

from perfbench.core.spec import ROOT, read_json
from perfbench.core.weights import make, tree_items
from perfbench.reference import dense, grpo, lm
from perfbench.reference.precision import Precision
from perfbench.tests import tiny

CONFIGS = [c["name"] for c in read_json(ROOT / "BENCHMARK.json")["configs"]]


def _cfg(config):
    return tiny.cell(config, "grpo_math").config["port"]


def test_attention_against_loops():
    g = torch.Generator().manual_seed(0)
    B, S, H, KV, hd = 2, 5, 4, 2, 3
    q = torch.randn(B, S, H, hd, generator=g)
    k = torch.randn(B, S, KV, hd, generator=g)
    v = torch.randn(B, S, KV, hd, generator=g)
    out = dense.attention(q, k, v)
    for b in range(B):
        for h in range(H):
            kv = h // (H // KV)
            for i in range(S):
                s = [float(q[b, i, h] @ k[b, j, kv]) / math.sqrt(hd)
                     for j in range(i + 1)]
                w = np.exp(np.asarray(s) - max(s))
                w /= w.sum()
                want = sum(w[j] * v[b, j, kv].numpy() for j in range(i + 1))
                assert np.allclose(out[b, i, h].numpy(), want, atol=1e-5)


def test_rotary_keeps_norms_and_rotates_pairs():
    x = torch.randn(1, 4, 2, 8)
    y = dense.rotary(x, 10000.0)
    assert torch.allclose(x.norm(dim=-1), y.norm(dim=-1), atol=1e-5)
    assert torch.equal(y[:, 0], x[:, 0])          # position 0: no turn


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_agrees_with_the_port(config):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import forward
    c = _cfg(config)
    params = make(lm.layout(c), 5, "cpu")
    toks = torch.randint(0, c["vocab_size"], (2, 24),
                         generator=torch.Generator().manual_seed(3))
    ref = lm.forward(params, toks, c, Precision("bf16"))
    got, _ = forward(params, ModelConfig(**c), {"tokens": toks},
                     use_kernels=False)
    assert ref.shape == got.shape
    assert (ref - got.float()).abs().max() < 0.05 * ref.abs().max()


@pytest.mark.parametrize("config", CONFIGS)
def test_fp8_control_departs_more_than_bf16(config):
    c = _cfg(config)
    params = make(lm.layout(c), 6, "cpu")
    toks = torch.randint(0, c["vocab_size"], (1, 16),
                         generator=torch.Generator().manual_seed(4))
    p64 = {k: v for k, v in params.items()}
    exact = lm.forward(p64, toks, c, _F32())
    b16 = (lm.forward(params, toks, c, Precision("bf16")) - exact).abs()
    f8 = (lm.forward(params, toks, c, Precision("fp8")) - exact).abs()
    assert f8.max() > 2 * b16.max()


class _F32(Precision):
    def __init__(self):
        self.name, self.act = "f32", torch.float32

    def mm(self, x, w):
        return torch.matmul(x.float(), w.float())


def test_adamw_against_the_formula():
    g = torch.Generator().manual_seed(7)
    p = {"a": torch.randn(3, 2, generator=g), "b": torch.randn(4,
                                                               generator=g)}
    gr = {"a": torch.randn(3, 2, generator=g), "b": torch.randn(4,
                                                                generator=g)}
    opt = {"betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.01,
           "grad_clip": 1.0, "warmup_steps": 2, "lr": 1e-3}
    state = {"m": {}, "v": {}, "count": 0}
    clipped, new = grpo.adamw(p, gr, state, opt)
    gn = math.sqrt(sum(float((t ** 2).sum()) for t in gr.values()))
    sc = min(1.0, 1.0 / gn)
    for k in p:
        gk = gr[k] * sc
        m, v = 0.1 * gk, 0.05 * gk * gk
        step = (m / 0.1) / ((v / 0.05).sqrt() + 1e-8)
        want = p[k] - 0.5e-3 * (step + 0.01 * p[k])
        assert torch.allclose(new[(k,)], want, atol=1e-7)
        assert clipped[(k,)] == pytest.approx(float(gk.norm()), rel=1e-6)


def test_adamw_agrees_with_the_port():
    from repro_torch.training.optimizer import OptimizerConfig, adamw_update
    from repro_torch.training.optimizer import init_opt_state
    g = torch.Generator().manual_seed(8)
    p = {"w": torch.randn(5, 3, generator=g)}
    opt = {"betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.01,
           "grad_clip": 1.0, "warmup_steps": 2, "lr": 1e-3}
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, schedule="constant")
    ps, st = p, init_opt_state(p)
    rstate = {"m": {}, "v": {}, "count": 0}
    rp = p
    for _ in range(3):
        gr = {"w": torch.randn(5, 3, generator=g)}
        ps, st, _ = adamw_update(ps, gr, st, ocfg)
        _, new = grpo.adamw(rp, gr, rstate, opt)
        rp = {"w": new[("w",)]}
    assert torch.allclose(ps["w"], rp["w"], atol=1e-7)


def test_weights_are_seeded_by_leaf():
    c = _cfg("qwen2_5_7b_l3")
    a = dict(tree_items(make(lm.layout(c), 2**40 + 1, "cpu")))
    b = dict(tree_items(make(lm.layout(c), 2**40 + 1, "cpu")))
    d = dict(tree_items(make(lm.layout(c), 2**40 + 2, "cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("embed", "table")], d[("embed", "table")])
