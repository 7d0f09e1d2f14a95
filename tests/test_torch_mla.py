"""The port's MLA families against the reference on the same numbers:
``models/mla.py`` (the param tree, ``mla_full`` with a window and offset
positions, the absorbed ``mla_decode`` stepwise on a ring and off it),
the model's forward, prefill cache and ``forward_hidden``, the absorbed
decode held to the port's own naive forward, one GRPO gradient step, the
fixed engine, ``Trainer.fit``, the planner's profiler and the launchers.

Params come from the reference (``models/convert.py``). Configs: a
reduced ``minicpm3_4b`` (dense, 4 heads, kv_lora 64, rope/nope/v 32,
byte vocab) as ``reduced()`` leaves it, with ``q_lora_rank = 0`` (the
``w_q`` route), and again with ``q_lora_rank = 48`` (``w_dq``/``w_uq``,
the route both full configs take); a reduced ``deepseek_v2_236b`` (moe,
top 2 of 4 SwiGLU experts, one shared, ``first_dense_layers = 1``) with
and without ``q_lora``. Bars: 2e-5 in fp32 for modules, 1e-4 in fp32
through the whole model, 2e-2 in bf16; gradients within 1e-4 relative in
fp32.

Where a test holds a decode to a forward on DeepSeek it routes every
token to every expert (``top_k = num_experts``): capacity follows the
tokens of a call, so a decode call of a few tokens and a forward drop
other picks (``tests/test_torch_moe.py``)."""
import dataclasses
import functools
import json
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
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import mla as jmla
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import mla as tmla
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.transformer import forward_hidden
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step

SRC = Path(__file__).resolve().parents[1] / "src"
FFN_TOL = 2e-5
FP32_TOL = 1e-4
BF16_TOL = 2e-2
GRAD_RTOL = 1e-4
TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
Q_LORA = 48

# name -> (reference config, changes to its reduced())
CONFIGS = {"minicpm3": ("minicpm3_4b", {}),
           "minicpm3_qlora": ("minicpm3_4b", {"q_lora_rank": Q_LORA}),
           "deepseek": ("deepseek_v2_236b", {}),
           "deepseek_qlora": ("deepseek_v2_236b", {"q_lora_rank": Q_LORA})}
QLORA = ["minicpm3_qlora", "deepseek_qlora"]


def _port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _setup(name, compute_dtype="float32", every_expert=False):
    arch, kw = CONFIGS[name]
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  vocab_size=ByteTokenizer.vocab_size,
                                  compute_dtype=compute_dtype, **kw)
    if every_expert:
        ref_cfg = dataclasses.replace(ref_cfg, top_k=ref_cfg.num_experts)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, _port_cfg(ref_cfg), params


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _attn_params(ref_params, stack="blocks"):
    """Layer 0's MLA params of ``stack``: (reference's, port's)."""
    pj = jax.tree.map(lambda a: a[0], ref_params[stack]["attn"])
    return pj, params_from_reference(jax.tree.map(np.asarray, pj),
                                     device="cpu")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]


# -- the param tree and the bridge --------------------------------------------

@pytest.mark.parametrize("name", ["minicpm3", "minicpm3_qlora",
                                  "deepseek_qlora"])
def test_init_params_matches_reference_tree(name):
    """Keys, shapes and dtypes against the reference's tree (``w_q``, or
    ``w_dq``/``w_uq`` with q_lora; DeepSeek's ``dense_blocks``), the init
    scales (normal 0.02, unit norm scales), and the bridge both ways, bit
    for bit: the reference's tree through the port and back, and the
    port's through the reference's numpy and back."""
    ref_cfg, ref_params, cfg, _ = _setup(name)
    params = init_params(3, cfg, device="cpu")
    flat_ref, flat = _leaves(ref_params), _leaves(params)
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (_, t), (_, a) in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    attn = params["blocks"]["attn"]
    q_keys = {"w_dq", "w_uq"} if cfg.q_lora_rank else {"w_q"}
    assert set(attn) == {"w_dkv", "w_krope", "w_uk", "w_uv", "wo"} | q_keys
    L = cfg.num_layers - cfg.first_dense_layers
    assert tuple(attn["w_uk"]["w"].shape) == (
        L, cfg.kv_lora_rank, cfg.num_heads * cfg.qk_nope_head_dim)
    for key, p in attn.items():
        assert abs(float(p["w"].std()) - 0.02) < 2e-3, key
    assert torch.equal(params["blocks"]["ln1"]["scale"],
                       torch.ones_like(params["blocks"]["ln1"]["scale"]))
    # reference -> port -> reference, bit for bit
    ref_np = jax.tree.map(np.asarray, ref_params)
    back = params_to_reference(params_from_reference(ref_np, device="cpu"))
    for (pa, a), (pb, b) in zip(_leaves(ref_np), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # port -> reference -> port, bit for bit; the reference runs on it
    ref_view = params_to_reference(params)
    again = params_from_reference(ref_view, device="cpu")
    for (pa, a), (pb, b) in zip(flat, _leaves(again)):
        assert pa == pb and torch.equal(a, b)
    toks = jnp.asarray(np.full((1, 4), 7, np.int32))
    assert np.isfinite(np.asarray(jax_forward(ref_view, ref_cfg,
                                              {"tokens": toks})[0])).all()


# -- the module ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["minicpm3", "minicpm3_qlora"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_mla_full_matches_reference(name, compute_dtype, window):
    """One block's MLA over 14 tokens at positions offset per row (the
    mask stays causal in the sequence, as the reference's), with and
    without a band of 8."""
    ref_cfg, ref_params, cfg, _ = _setup(name)
    pj, pt = _attn_params(ref_params)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    pos = (np.arange(14)[None] + np.array([[3], [17]])).astype(np.int32)
    dt = getattr(jnp, compute_dtype)
    want = jmla.mla_full(pj, jnp.asarray(x, dt), ref_cfg, jnp.asarray(pos),
                         window=window)
    xt = torch.from_numpy(x).to(getattr(torch, compute_dtype))
    pt_pos = torch.from_numpy(pos).long()
    with torch.no_grad():
        got = tmla.mla_full(pt, xt, cfg, pt_pos, window=window)
        again, kv = tmla.mla_full_kv(pt, xt, cfg, pt_pos, window=window)
    tol = FFN_TOL if compute_dtype == "float32" else BF16_TOL
    assert got.dtype == getattr(torch, compute_dtype)
    _close(got, want, tol)
    assert torch.equal(again, got)
    # the prefill cache's rows: the latents the attention projected
    assert set(kv) == {"c_kv", "k_rope"}
    assert tuple(kv["c_kv"].shape) == (2, 14, cfg.kv_lora_rank)
    assert tuple(kv["k_rope"].shape) == (2, 14, cfg.qk_rope_head_dim)


@pytest.mark.parametrize("name", ["minicpm3", "minicpm3_qlora"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [False, True])
def test_mla_decode_stepwise_matches_reference(name, compute_dtype, ring):
    """Three slots decode 11 steps at ragged positions into one layer's
    latent cache: 6 slots on a ring (it wraps) or 9 without (the last
    steps clamp to the final slot). Each step's output, and at the end the
    cache's contents, against the reference's."""
    ref_cfg, ref_params, cfg, _ = _setup(name)
    pj, pt = _attn_params(ref_params)
    dt_j, dt_t = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    S, B = (6, 3) if ring else (9, 3)
    cj = jax.tree.map(lambda a: a[0],
                      jmla.init_mla_cache(ref_cfg, B, S, dt_j, layers=1))
    ct = jax.tree.map(lambda t: t[0],
                      tmla.init_mla_cache(cfg, B, S, dt_t, layers=1))
    rng = np.random.default_rng(12)
    tol = FFN_TOL if compute_dtype == "float32" else BF16_TOL
    for t in range(11):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, max(t - 2, 0), t + 4], np.int32)
        yj, cj = jmla.mla_decode(pj, jnp.asarray(x, dt_j), cj,
                                 jnp.asarray(pos), ref_cfg, ring=ring)
        with torch.no_grad():
            yt, ct2 = tmla.mla_decode(pt, torch.from_numpy(x).to(dt_t), ct,
                                      torch.from_numpy(pos).long(), cfg,
                                      ring=ring)
        assert ct2 is ct                     # written in place
        _close(yt, yj, tol)
    for key in ("c_kv", "k_rope"):
        assert ct[key].dtype == dt_t
        _close(ct[key], cj[key], tol)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_aux_and_prefill_cache_match_reference(name, compute_dtype):
    """Logits, the aux loss and the prefill cache ({"kv": {"c_kv",
    "k_rope"}}, DeepSeek's dense layer apart as ``dense_kv``). bf16
    DeepSeek routes every token to every expert: a rounding here and there
    can swap a near-tied second expert (``tests/test_torch_moe.py``)."""
    every = name.startswith("deepseek") and compute_dtype == "bfloat16"
    ref_cfg, ref_params, cfg, params = _setup(name, compute_dtype, every)
    toks = np.random.default_rng(5).integers(3, 259, (2, 16)).astype(
        np.int32)
    lj, aj, cj = jax_forward(ref_params, ref_cfg,
                             {"tokens": jnp.asarray(toks)}, use_pallas=True,
                             return_cache=True)
    with torch.no_grad():
        lt, at, ct = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                             return_cache=True)
    tol = TOL[compute_dtype]
    _close(lt, lj, tol)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-4)
    want_keys = ["dense_kv", "kv"] if name.startswith("deepseek") else ["kv"]
    assert sorted(ct) == sorted(cj) == want_keys
    for key in ct:
        assert sorted(ct[key]) == sorted(cj[key]) == ["c_kv", "k_rope"]
        for lat in ("c_kv", "k_rope"):
            assert tuple(ct[key][lat].shape) == cj[key][lat].shape
            _close(ct[key][lat], cj[key][lat], tol)


@pytest.mark.parametrize("name", ["minicpm3", "minicpm3_qlora",
                                  "deepseek_qlora"])
def test_forward_hidden_matches_reference(name):
    ref_cfg, ref_params, cfg, params = _setup(name)
    toks = np.random.default_rng(6).integers(3, 259, (2, 12)).astype(
        np.int32)
    want = jax_forward_hidden(ref_params, ref_cfg, jnp.asarray(toks))
    with torch.no_grad():
        got = forward_hidden(params, cfg, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 12, cfg.d_model)
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("name", ["minicpm3", "deepseek_qlora"])
def test_stepwise_decode_matches_reference(name):
    """Four slots, 10 ragged steps over one latent cache of all the
    layers (DeepSeek's dense layer first): logits and cache against the
    reference's decode, which drops the same picks (C = 1 at 4 slots)."""
    ref_cfg, ref_params, cfg, params = _setup(name)
    B, T = 4, 10
    toks = np.random.default_rng(7).integers(3, 259, (B, T))
    cj = jax_init_cache(ref_cfg, B, T, dtype=jnp.float32)
    ct = init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    assert sorted(ct) == ["c_kv", "k_rope"]
    assert tuple(ct["c_kv"].shape) == (cfg.num_layers, B, T,
                                       cfg.kv_lora_rank)
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
    for lat in ("c_kv", "k_rope"):
        _close(ct[lat], cj[lat], FP32_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_absorbed_decode_equals_naive_forward_teacher_forced(name):
    """The port's absorbed decode against its own naive forward over the
    same tokens (DeepSeek routes every token to every expert, where
    nothing drops), fp32 cache, within 1e-4; and a prefill cache, DeepSeek's
    ``dense_kv`` and ``kv`` stacked in layer order, seeds a decode that
    continues the forward, on a ring as well as off it."""
    ref_cfg, _, cfg, params = _setup(name, every_expert=True)
    B, T, P = 2, 12, 7
    toks = torch.from_numpy(np.random.default_rng(8).integers(
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
        stacked = {lat: torch.cat([pre[k][lat] for k in ("dense_kv", "kv")
                                   if k in pre])
                   for lat in ("c_kv", "k_rope")}
        for ring in (False, True):
            c2 = init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
            for lat in ("c_kv", "k_rope"):
                c2[lat][:, :, :P] = stacked[lat]
            for t in range(P, T):
                lt, c2 = decode_step(params, cfg, c2, toks[:, t],
                                     torch.full((B,), t), ring=ring)
                _close(lt, want[:, t].numpy(), FP32_TOL)
    _close(full, want[:, :P].numpy(), FP32_TOL)


# -- training -----------------------------------------------------------------

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


MLA_KEYS = ("w_dkv", "w_krope", "w_uk", "w_uv", "wo", "w_dq", "w_uq")


@pytest.mark.parametrize("name", QLORA)
def test_grpo_grad_step_matches_reference(name):
    """One GRPO micro-batch with KL: the metrics and every parameter's
    gradient against ``jax.grad`` through the reference's
    ``_grad_microbatch``; every MLA weight of every stack gets a
    gradient."""
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
    for stack in ("dense_blocks", "blocks"):
        if stack in grads:
            for k in MLA_KEYS:
                assert float(grads[stack]["attn"][k]["w"].abs().max()) > 0, \
                    (stack, k)


def test_deepseek_bf16_grads_are_bit_identical_across_calls():
    """Two bf16 gradient calls on one micro-batch: the same bits (MLA adds
    only products, elementwise work and a softmax)."""
    _, _, cfg, params = _setup("deepseek_qlora", "bfloat16")
    batch = pack_rows(_rows(4, seed=2), 20, device="cpu")
    rl = GRPOConfig(kl_coef=0.1)
    g1, m1 = grpo_grad_step(params, cfg, rl, batch)
    g2, m2 = grpo_grad_step(params, cfg, rl, batch)
    for a, b in zip(jax.tree.leaves(params_to_reference(g1)),
                    jax.tree.leaves(params_to_reference(g2))):
        np.testing.assert_array_equal(a, b)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)


# -- engines, trainer, planner, launchers ---------------------------------------

@pytest.mark.parametrize("name", ["minicpm3_qlora", "deepseek_qlora"])
def test_fixed_engine_logprobs_match_reference_decode(name):
    """The fixed engine (``rl.sampling.generate``, a bf16 latent cache as
    the reference's) on 4 prompts (a power of two, so no padding rows):
    each step's logprob against the reference's decode steps, with its
    own bf16 cache, fed the same tokens: DeepSeek's 4-token decode calls
    drop the same picks on both sides."""
    from repro_torch.rl import generate
    ref_cfg, ref_params, cfg, params = _setup(name)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 259, n).astype(np.int32) for n in (3, 7, 5, 6)]
    rows = generate(params, cfg, prompts, 0, max_new_tokens=5,
                    temperature=1.0, eos_id=-1, device="cpu")
    toks = np.stack([r["tokens"] for r in rows]).astype(np.int32)
    B, total = toks.shape
    cache = jax_init_cache(ref_cfg, B, total)
    assert cache["c_kv"].dtype == jnp.bfloat16
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg))
    for t in range(total - 1):
        logits, cache = step(ref_params, cache=cache,
                             token=jnp.asarray(toks[:, t]),
                             pos=jnp.full((B,), t, jnp.int32))
        logp = jax.nn.log_softmax(np.asarray(logits, np.float32), -1)
        want = logp[np.arange(B), toks[:, t + 1]]
        got = np.array([r["logprobs"][t + 1] for r in rows])
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_continuous_engine_refuses_minicpm3_as_the_reference_does():
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg, _, cfg, _ = _setup("minicpm3_qlora")
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(cfg, device="cpu")
    assert "attention='mla'" in str(got.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_trainer_fit_baseline_without_jax(arch):
    """GRPO with the KL stage, baseline mode, fixed rollout backend, on
    the reduced config with q_lora, in a process that never imports
    JAX."""
    code = (
        "import dataclasses, sys\n"
        "from repro_torch.api import Trainer, TrainerConfig\n"
        "from repro_torch.configs import get_config\n"
        f"cfg = dataclasses.replace(get_config('{arch}').reduced(),"
        f" q_lora_rank={Q_LORA}, vocab_size=259)\n"
        f"res = Trainer(TrainerConfig(arch='{arch}', device='cpu',"
        " mode='baseline', num_steps=2, prompts_per_step=2, group_size=2,"
        " max_new_tokens=4, seq_len=24, kl_coef=0.05), model_cfg=cfg).fit()\n"
        "assert res.samples_trained == 8, res.samples_trained\n"
        "assert len(res.metrics) == 2, res.metrics\n"
        "import math\n"
        "assert all(math.isfinite(m[k]) for m in res.metrics"
        " for k in ('loss', 'grad_norm')), res.metrics\n"
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


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_profile_reduced_blocks_on_mla(arch):
    from repro_torch.configs import get_config
    from repro_torch.core.planner.profiling import profile_reduced_blocks
    prof = profile_reduced_blocks(get_config(arch), device="cpu")
    assert prof["reduced_cfg"].attention == "mla"
    assert prof["reduced_decode_s"] > 0 and prof["reduced_train_s"] > 0


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_mla_on_cpu(arch, launcher, capsys):
    from repro_torch.launch import serve, train
    if launcher == "serve":
        rc = serve.main(["--device", "cpu", "--arch", arch,
                         "--engine", "fixed", "--requests", "3",
                         "--max-new-tokens", "4"])
    else:
        rc = train.main(["--device", "cpu", "--arch", arch,
                         "--steps", "1", "--prompts-per-step", "2",
                         "--group-size", "2", "--max-new-tokens", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == arch and out["device"] == "cpu"
