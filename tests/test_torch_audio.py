"""The port's audio family (Whisper-style encoder-decoder,
``models/encdec.py``) against the reference on the same numbers: the
param tree and its bit-exact round trip, ``encode``, ``decode_train`` and
``forward`` on both routes, the cross cache and ``decode_step`` past the
learned positions' wrap, one GRPO step with ``frames`` (gradients against
``jax.grad``, then AdamW), the reference logprobs of an audio
micro-batch, and the refusal of every generation engine.

Params come from the reference (``models/convert.py``) on a reduced
``whisper_tiny`` (2 + 2 layers, d_model 256, 4 heads over 4 KV heads, hd
64, 32 frames, byte vocab). Bars: 2e-5 in fp32, 2e-2 in bf16; gradients
within 1e-4 relative in fp32."""
import dataclasses
import functools

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
from repro.models import encdec as jencdec
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.rl.grpo import GRPOConfig as RefGRPOConfig
from repro.rl.grpo import grpo_train_step as ref_grpo_train_step
from repro.rl.loss import token_logprobs as ref_token_logprobs
from repro.training import OptimizerConfig as RefOptimizerConfig
from repro.training import TrainState as RefTrainState
from repro_torch.configs.base import ModelConfig
from repro_torch.engines import pack_rows
from repro_torch.models import (decode_step, encdec, forward, init_cache,
                                init_params)
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.rl import grpo_train_step, token_logprobs
from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
from repro_torch.training import OptimizerConfig, TrainState

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_RTOL = 1e-4
WRAP = 6            # a small max_target_positions: the decode wraps at 6


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="float32", max_target_positions=None,
           param_dtype="float32"):
    ref_cfg = dataclasses.replace(
        ref_get_config("whisper_tiny").reduced(),
        vocab_size=ByteTokenizer.vocab_size, compute_dtype=compute_dtype,
        param_dtype=param_dtype)
    if max_target_positions:
        ref_cfg = dataclasses.replace(
            ref_cfg, max_target_positions=max_target_positions)
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
    frames = rng.standard_normal((B, cfg.encoder_frames,
                                  cfg.d_model)).astype(np.float32)
    toks = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, toks


def _paths(tree):
    return [p for p, _ in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]]


def test_init_params_matches_reference_tree():
    ref_cfg, ref_params, cfg, _ = _setup()
    assert cfg.arch_type == "audio" and cfg.encoder_layers == 2
    params = init_params(3, cfg, device="cpu")
    assert _paths(params) == _paths(ref_params)
    flat_ref = jax.tree.leaves(ref_params)
    flat = jax.tree.leaves(params,
                           is_leaf=lambda t: isinstance(t, torch.Tensor))
    for t, a in zip(flat, flat_ref):
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    assert tuple(params["dec_blocks"]["cross"]["wq"]["w"].shape) == \
        (cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    assert abs(float(params["enc_pos"].std()) - 0.02) < 1e-3
    assert torch.equal(params["dec_blocks"]["ln_x"]["bias"],
                       torch.zeros_like(params["dec_blocks"]["ln_x"]["bias"]))
    again = init_params(3, cfg, device="cpu")
    assert torch.equal(again["dec_pos"], params["dec_pos"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_encoder_decoder_tree_bit_exactly(dtype):
    _, ref_params, _, _ = _setup(param_dtype=dtype)
    ref = jax.tree.map(np.asarray, ref_params)
    port = params_from_reference(ref, device="cpu")
    assert _paths(port) == _paths(ref)
    back = params_to_reference(port)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.dtype.name == dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_encode_matches_reference(compute_dtype):
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype)
    frames, _ = _inputs(cfg, 2, 4, seed=1)
    want = jencdec.encode(ref_params, ref_cfg, jnp.asarray(frames))
    with torch.no_grad():
        got = encdec.encode(params, cfg, torch.from_numpy(frames))
    assert tuple(got.shape) == (2, cfg.encoder_frames, cfg.d_model)
    _close(got, want, TOL[compute_dtype])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_decode_train_matches_reference(compute_dtype, use_kernels):
    """Teacher-forced decoder over the same memory: the causal
    self-attention through the flash kernel's plain version or ``sdpa``,
    the cross-attention through ``sdpa``."""
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype)
    frames, toks = _inputs(cfg, 2, 10, seed=2)
    mem = jencdec.encode(ref_params, ref_cfg, jnp.asarray(frames))
    lj, aj, cj = jencdec.decode_train(ref_params, ref_cfg, mem,
                                      jnp.asarray(toks))
    mem_t = torch.from_numpy(np.asarray(mem.astype(jnp.float32)))
    with torch.no_grad():
        lt, at, ct = encdec.decode_train(
            params, cfg, mem_t.to(getattr(torch, compute_dtype)),
            torch.from_numpy(toks).long(), use_kernels=use_kernels)
    assert at == 0.0 and float(aj) == 0.0 and ct is None and cj is None
    _close(lt, lj, TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_forward_with_frames_matches_reference(compute_dtype):
    """``forward`` on both routes (the Pallas kernels in interpret mode in
    the reference); ``return_cache`` gives None, as the reference's does;
    the frames move the logits."""
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype)
    frames, toks = _inputs(cfg, 2, 12, seed=3)
    lj, aj, cj = jax_forward(ref_params, ref_cfg,
                             {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)},
                             use_pallas=True, return_cache=True)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "frames": torch.from_numpy(frames)}
    with torch.no_grad():
        lt, at, ct = forward(params, cfg, batch, return_cache=True)
        plain, _ = forward(params, cfg, batch, use_kernels=False)
        other, _ = forward(params, cfg, {**batch, "frames": batch["frames"]
                                         * 0.5})
    assert cj is None and ct is None and at == 0.0
    assert tuple(lt.shape) == (2, 12, cfg.vocab_size)
    _close(lt, lj, TOL[compute_dtype])
    _close(plain, lj, TOL[compute_dtype])
    assert float((other - lt).abs().max()) > 1e-2


@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_decode_step_past_the_position_wrap_matches_reference(compute_dtype):
    """``init_dec_cache`` + ``precompute_cross_kv`` + ``decode_step`` at
    positions 0..9 with ``max_target_positions`` 6, so the learned
    positions wrap at 6 while the rotary positions go on: each step's
    logits against the reference's, the cross cache against the
    reference's, and (fp32, fp32 caches) each step against one forward
    over all the tokens."""
    ref_cfg, ref_params, cfg, params = _setup(compute_dtype, WRAP)
    B, n = 2, 10
    frames, toks = _inputs(cfg, B, n, seed=4)
    tol = TOL[compute_dtype]
    cache_dt = (torch.float32, jnp.float32) if compute_dtype == "float32" \
        else (torch.bfloat16, jnp.bfloat16)
    mem_j = jencdec.encode(ref_params, ref_cfg, jnp.asarray(frames))
    cj = jencdec.precompute_cross_kv(
        ref_params, ref_cfg, mem_j,
        jax_init_cache(ref_cfg, B, n, dtype=cache_dt[1]))
    with torch.no_grad():
        mem_t = encdec.encode(params, cfg, torch.from_numpy(frames))
        ct = init_cache(cfg, B, n, dtype=cache_dt[0], device="cpu")
        assert encdec.precompute_cross_kv(params, cfg, mem_t, ct) is ct
        full, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)
                                        .long(),
                                        "frames": torch.from_numpy(frames)})
    assert tuple(ct["cross_k"].shape) == cj["cross_k"].shape
    _close(ct["cross_k"], cj["cross_k"], tol)
    _close(ct["cross_v"], cj["cross_v"], tol)
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg))
    for t in range(n):
        pos = np.full(B, t, np.int32)
        lj, cj = step(ref_params, cache=cj, token=jnp.asarray(toks[:, t]),
                      pos=jnp.asarray(pos))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct,
                                 torch.from_numpy(toks[:, t]).long(),
                                 torch.from_numpy(pos).long())
        _close(lt, lj, tol)
        if compute_dtype == "float32":
            _close(lt, full[:, t].numpy(), 1e-4)
    _close(ct["self"]["k"], cj["self"]["k"], tol)


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


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def test_grpo_grad_step_with_frames_matches_jax_grad():
    """One GRPO micro-batch with KL and ``frames`` in the batch: the loss
    passes them to ``forward``; metrics and every gradient (the encoder's
    included) against ``jax.grad``."""
    ref_cfg, ref_params, cfg, params = _setup()
    rows, frames = _rows(4, seed=1), _frames(cfg, 4, 9)
    rl = dict(kl_coef=0.1, entropy_coef=0.01)
    ref_batch = {**ref_pack_rows(rows, 20), "frames": jnp.asarray(frames)}
    g_ref, m_ref = _grad_microbatch(
        ref_params, ref_cfg, RefGRPOConfig(use_pallas_logprob=True, **rl),
        ref_batch)
    batch = {**pack_rows(rows, 20, device="cpu"),
             "frames": torch.from_numpy(frames)}
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
    assert float(grads["enc_blocks"]["attn"]["wq"]["w"].abs().max()) > 0


def test_grpo_train_step_with_frames_matches_reference():
    """One GRPO update with AdamW in fp32 from the same params and batch:
    the metrics (``grad_norm`` among them) within 1e-5 relative of the
    reference's ``grpo_train_step``, the new params within 1e-5 relative
    as one tree and 1e-4 leaf by leaf, and the step applied."""
    ref_cfg, ref_params, cfg, params = _setup()
    rows, frames = _rows(4, seed=2), _frames(cfg, 4, 10)
    opt = dict(lr=1e-3, warmup_steps=2)
    ref_batch = {**ref_pack_rows(rows, 20), "frames": jnp.asarray(frames)}
    new_ref, m_ref = ref_grpo_train_step(
        RefTrainState.create(ref_params), ref_cfg,
        RefGRPOConfig(kl_coef=0.05), RefOptimizerConfig(**opt), ref_batch)
    batch = {**pack_rows(rows, 20, device="cpu"),
             "frames": torch.from_numpy(frames)}
    new, m = grpo_train_step(TrainState.create(params), cfg,
                             GRPOConfig(kl_coef=0.05),
                             OptimizerConfig(**opt), batch)
    assert new.step == int(new_ref.step) == 1
    assert set(m) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    num = den = 0.0
    for a, b in zip(jax.tree.leaves(params_to_reference(new.params)),
                    jax.tree.leaves(new_ref.params)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
        num, den = num + np.sum((a - b) ** 2), den + np.sum(b * b)
    assert np.sqrt(num) <= 1e-5 * np.sqrt(den)
    moved = params_to_reference(new.params)["enc_pos"] - \
        np.asarray(ref_params["enc_pos"])
    assert np.abs(moved).max() > 0


def test_reference_logprobs_of_an_audio_micro_batch():
    """What a reference stage computes for audio rows: the kernel-route
    forward with ``frames``, then ``token_logprobs`` (``grpo_logprob``'s
    plain version here, the Pallas kernel in interpret mode there)."""
    ref_cfg, ref_params, cfg, params = _setup()
    frames, toks = _inputs(cfg, 3, 14, seed=5)
    lj, _ = jax_forward(ref_params, ref_cfg,
                        {"tokens": jnp.asarray(toks),
                         "frames": jnp.asarray(frames)}, use_pallas=True)
    lpj, entj = ref_token_logprobs(lj[:, :-1], jnp.asarray(toks[:, 1:]),
                                   use_pallas=True)
    with torch.no_grad():
        lt, _ = forward(params, cfg, {"tokens": torch.from_numpy(toks)
                                      .long(),
                                      "frames": torch.from_numpy(frames)})
        lpt, entt = token_logprobs(lt[:, :-1],
                                   torch.from_numpy(toks[:, 1:]).long())
    _close(lpt, lpj, 1e-4)
    _close(entt, entj, 1e-4)


def test_generation_engines_refuse_audio():
    """The reference generates from prompt tokens alone; the port's fixed
    engine and rollout engine refuse audio with a ``ValueError`` that
    says so, and the continuous engine refuses it with the reference's
    own message."""
    from repro.engines.continuous_batching import \
        ContinuousBatchingEngine as RefEngine
    from repro_torch.engines import RolloutEngine
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.rl import generate
    ref_cfg, _, cfg, params = _setup()
    for call in (
            lambda: generate(params, cfg, [np.array([1, 5, 6])], 0,
                             device="cpu"),
            lambda: RolloutEngine(cfg, ref_rows=2, ref_len=16,
                                  device="cpu")):
        with pytest.raises(ValueError, match="prompt tokens alone"):
            call()
    with pytest.raises(ValueError) as want:
        RefEngine(ref_cfg)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(cfg, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_refuse_audio(launcher):
    from repro_torch.launch import serve, train
    with pytest.raises(ValueError, match="prompt tokens alone"):
        if launcher == "serve":
            serve.main(["--device", "cpu", "--arch", "whisper_tiny",
                        "--requests", "1"])
        else:
            train.main(["--device", "cpu", "--arch", "whisper_tiny",
                        "--steps", "1"])


def test_decoder_only_trunk_refuses_audio():
    from repro_torch.models import transformer
    _, _, cfg, _ = _setup()
    with pytest.raises(ValueError, match="models/encdec.py"):
        transformer.init_cache(cfg, 1, 8, device="cpu")
