"""The port's vlm family (InternVL2) against the reference on the same
numbers: the dense trunk behind stubbed vision patch embeddings, which
take positions 0..T-1 and push the text to T. ``forward`` and
``forward_hidden`` with ``vision_embeds``, a vision-prefixed prefill
followed by decode at the offset positions, one GRPO gradient step with
``vision_embeds``, ``Trainer.fit``, the planner's profiler and the
launchers.

Params come from the reference (``models/convert.py``) on a reduced
``internvl2_26b`` (d_model 256, 4 heads over 1 KV head, hd 64, 16 vision
tokens, byte vocab). Bars: 1e-4 in fp32, 2e-2 in bf16; gradients within
1e-4 relative in fp32. The reference's rollout and trainer feed no vision
inputs, and the port's do not either: there the family runs as its text
trunk."""
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
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.transformer import forward_hidden
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="float32"):
    ref_cfg = dataclasses.replace(
        ref_get_config("internvl2_26b").reduced(),
        vocab_size=ByteTokenizer.vocab_size, compute_dtype=compute_dtype)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, ModelConfig(**dataclasses.asdict(ref_cfg)), \
        params


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    # the projector's output width is d_model (``launch/specs.py``)
    vis = rng.standard_normal((B, cfg.vision_tokens,
                               cfg.d_model)).astype(np.float32)
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    return vis, toks


def test_init_params_matches_reference_tree():
    ref_cfg, ref_params, cfg, _ = _setup()
    assert cfg.arch_type == "vlm" and cfg.num_heads > cfg.num_kv_heads
    params = init_params(3, cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (_, t), (_, a) in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32


@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_forward_with_vision_embeds_matches_reference(compute_dtype):
    """Logits over the T vision and S text positions and the prefill
    cache (the kernels' plain versions here, the Pallas kernels in
    interpret mode there); without ``vision_embeds`` the text trunk."""
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype)
    vis, toks = _inputs(cfg, 2, 12, seed=1)
    tol = TOL[compute_dtype]
    lj, aj, cj = jax_forward(ref_params, ref_cfg,
                             {"tokens": jnp.asarray(toks),
                              "vision_embeds": jnp.asarray(vis)},
                             use_pallas=True, return_cache=True)
    with torch.no_grad():
        lt, at, ct = forward(params, cfg,
                             {"tokens": torch.from_numpy(toks),
                              "vision_embeds": torch.from_numpy(vis)},
                             return_cache=True)
        plain, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert tuple(lt.shape) == (2, cfg.vision_tokens + 12, cfg.vocab_size)
    assert at == 0.0 and float(aj) == 0.0
    _close(lt, lj, tol)
    for kv in ("k", "v"):
        assert tuple(ct["kv"][kv].shape) == cj["kv"][kv].shape
        _close(ct["kv"][kv], cj["kv"][kv], tol)
    want, _ = jax_forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})
    _close(plain, want, tol)
    assert float((plain - lt[:, cfg.vision_tokens:]).abs().max()) > 1e-3


def test_forward_hidden_with_vision_matches_reference():
    ref_cfg, ref_params, cfg, params = _setup()
    vis, toks = _inputs(cfg, 2, 10, seed=2)
    want = jax_forward_hidden(ref_params, ref_cfg, jnp.asarray(toks),
                              extra_embeds=jnp.asarray(vis))
    with torch.no_grad():
        got = forward_hidden(params, cfg, torch.from_numpy(toks),
                             extra_embeds=torch.from_numpy(vis))
    assert tuple(got.shape) == (2, cfg.vision_tokens + 10, cfg.d_model)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_prefill_then_decode_at_offset_positions(compute_dtype):
    """Vision + a 6-token prompt prefilled into a cache of T + 14 rows,
    then 8 tokens decoded at positions T + 6 + t: each step's logits
    against the reference's decode from its own prefill, and against one
    forward over vision + prompt + the decoded tokens (teacher-forced)."""
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype)
    T, P, n = cfg.vision_tokens, 6, 8
    vis, toks = _inputs(cfg, 2, P + n, seed=3)
    tol = TOL[compute_dtype]
    cache_dt = (torch.float32, jnp.float32) if compute_dtype == "float32" \
        else (torch.bfloat16, jnp.bfloat16)
    batch = {"tokens": toks[:, :P], "vision_embeds": vis}
    _, _, pj = jax_forward(ref_params, ref_cfg,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           return_cache=True)
    cj = jax_init_cache(ref_cfg, 2, T + P + n, dtype=cache_dt[1])
    cj = {kv: cj[kv].at[:, :, :T + P].set(pj["kv"][kv].astype(cache_dt[1]))
          for kv in ("k", "v")}
    with torch.no_grad():
        _, _, pt = forward(params, cfg, {k: torch.from_numpy(v)
                                         for k, v in batch.items()},
                           return_cache=True)
        full, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks),
                                        "vision_embeds":
                                            torch.from_numpy(vis)})
    ct = init_cache(cfg, 2, T + P + n, dtype=cache_dt[0], device="cpu")
    for kv in ("k", "v"):
        ct[kv][:, :, :T + P] = pt["kv"][kv]
    for t in range(P, P + n):
        pos = np.full(2, T + t, np.int32)
        lj, cj = jax_decode_step(ref_params, ref_cfg, cj,
                                 jnp.asarray(toks[:, t]), jnp.asarray(pos))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct,
                                 torch.from_numpy(toks[:, t]),
                                 torch.from_numpy(pos).long())
        _close(lt, lj, tol)
        _close(lt, full[:, T + t].float().numpy(), tol)


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


def test_grpo_grad_step_with_vision_matches_reference():
    """One GRPO micro-batch with KL and ``vision_embeds`` in the batch:
    ``grpo_loss_fn`` passes them to ``forward`` and keeps the last S
    positions' logits, as the reference's does; metrics and every
    gradient against ``jax.grad``."""
    ref_cfg, ref_params, cfg, params = _setup()
    rows = _rows(4, seed=1)
    vis = np.random.default_rng(9).standard_normal(
        (4, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    rl = dict(kl_coef=0.1, entropy_coef=0.01)
    ref_batch = {**ref_pack_rows(rows, 20), "vision_embeds": jnp.asarray(vis)}
    g_ref, m_ref = _grad_microbatch(
        ref_params, ref_cfg, RefGRPOConfig(use_pallas_logprob=True, **rl),
        ref_batch)
    batch = {**pack_rows(rows, 20, device="cpu"),
             "vision_embeds": torch.from_numpy(vis)}
    grads, metrics = grpo_grad_step(params, cfg, GRPOConfig(**rl), batch)
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
    # the vision prefix moved the loss
    _, m_text = grpo_grad_step(params, cfg, GRPOConfig(**rl),
                               pack_rows(rows, 20, device="cpu"))
    assert float(m_text["loss"]) != float(metrics["loss"])


def test_continuous_engine_refuses_vlm_as_the_reference_does():
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    ref_cfg, _, cfg, _ = _setup()
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(cfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_fixed_engine_serves_vlm_text_teacher_forced():
    """The fixed engine (``rl.sampling.generate``) runs the vlm's text
    trunk, as the reference's does; its logprobs against one reference
    forward over each finished row."""
    from repro_torch.rl import generate
    ref_cfg, ref_params, cfg, params = _setup()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 259, n).astype(np.int32) for n in (3, 7, 5)]
    rows = generate(params, cfg, prompts, 0, max_new_tokens=5,
                    temperature=1.0, eos_id=-1, device="cpu")
    for r in rows:
        toks = np.asarray(r["tokens"], np.int32)[None]
        logits, _ = jax_forward(ref_params, ref_cfg,
                                {"tokens": jnp.asarray(toks)})
        logp = jax.nn.log_softmax(np.asarray(logits, np.float32)[0], -1)
        want = [float(logp[t - 1, toks[0, t]])
                for t in range(r["prompt_len"], toks.shape[1])]
        # the fixed engine's KV cache is bf16, as the reference's
        np.testing.assert_allclose(r["logprobs"][r["prompt_len"]:], want,
                                   atol=TOL["bfloat16"], rtol=0)


def test_trainer_fit_baseline_on_vlm():
    import math
    from repro_torch.api import Trainer, TrainerConfig
    _, _, cfg, _ = _setup()
    res = Trainer(TrainerConfig(
        arch="internvl2_26b", mode="baseline", rollout_backend="fixed",
        num_steps=2, prompts_per_step=2, group_size=2, max_new_tokens=4,
        seq_len=24, kl_coef=0.05, device="cpu"), model_cfg=cfg).fit()
    assert res.samples_trained == 8 and len(res.metrics) == 2
    for m in res.metrics:
        assert all(math.isfinite(m[k]) for k in ("loss", "grad_norm"))


def test_profile_reduced_blocks_on_vlm():
    from repro_torch.configs import get_config
    from repro_torch.core.planner.profiling import profile_reduced_blocks
    prof = profile_reduced_blocks(get_config("internvl2_26b"), device="cpu")
    assert prof["reduced_cfg"].arch_type == "vlm"
    assert prof["reduced_decode_s"] > 0 and prof["reduced_train_s"] > 0


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_run_internvl2_on_cpu(launcher, capsys):
    from repro_torch.launch import serve, train
    if launcher == "serve":
        rc = serve.main(["--device", "cpu", "--arch", "internvl2_26b",
                         "--engine", "fixed", "--requests", "3",
                         "--max-new-tokens", "4"])
    else:
        rc = train.main(["--device", "cpu", "--arch", "internvl2_26b",
                         "--steps", "1", "--prompts-per-step", "2",
                         "--group-size", "2", "--max-new-tokens", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "internvl2_26b" and out["device"] == "cpu"
