"""The port's dense model against the reference on the same params and
tokens: forward logits, the prefill K/V cache, and step-by-step decode
logits (both cache modes), with the reference's attention in its Pallas
kernels (interpret mode) and the port's through its kernels' plain
versions. Tolerance: 1e-4 with fp32 compute, 2e-2 in bf16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_config
from repro.data.tokenizer import ByteTokenizer
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models.convert import params_from_reference

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
def _reduced(name, **kw):
    return lambda: dataclasses.replace(
        get_config(name).reduced(), vocab_size=ByteTokenizer.vocab_size,
        **kw)


# every dense GQA config, cut with ``reduced()``; StableLM-2-12B keeps its
# head dim of 160 (``reduced()`` sets 64), the width that needs the
# kernels' hd-160 routes
CFGS = {
    "tiny": lambda: tiny_cfg(),
    "qwen2_5_7b_reduced": _reduced("qwen2_5_7b"),
    "qwen2_5_32b_reduced": _reduced("qwen2_5_32b"),
    "qwen1_5_32b_reduced": _reduced("qwen1_5_32b"),
    "minicpm_2b_reduced": _reduced("minicpm_2b"),
    "stablelm_12b_reduced": _reduced("stablelm_12b", head_dim=160),
}


def port_cfg(ref_cfg):
    """The port's own config object with the reference config's values."""
    return ModelConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _setup(name, compute_dtype):
    ref_cfg = dataclasses.replace(CFGS[name](), compute_dtype=compute_dtype)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, port_cfg(ref_cfg), params


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("compute_dtype", list(TOL))
def test_forward_and_prefill_cache_match_reference(name, compute_dtype):
    ref_cfg, ref_params, cfg, params = _setup(name, compute_dtype)
    tokens = np.random.default_rng(1).integers(
        3, cfg.vocab_size, (2, 24)).astype(np.int32)
    lj, _, cj = jax_forward(ref_params, ref_cfg,
                            {"tokens": jnp.asarray(tokens)},
                            use_pallas=True, return_cache=True)
    with torch.no_grad():
        lt, aux, ct = forward(params, cfg,
                              {"tokens": torch.from_numpy(tokens).long()},
                              return_cache=True)
    tol = TOL[compute_dtype]
    assert lt.shape == lj.shape and aux == 0.0
    _close(lt, lj, tol)
    for key in ("k", "v"):
        assert tuple(ct["kv"][key].shape) == cj["kv"][key].shape
        _close(ct["kv"][key], cj["kv"][key], tol)


@pytest.mark.parametrize("name,compute_dtype,ring", [
    ("tiny", "float32", False),
    ("tiny", "bfloat16", False),
    ("qwen2_5_7b_reduced", "float32", False),
    ("qwen2_5_7b_reduced", "bfloat16", False),
    ("tiny", "float32", True),       # ring cache shorter than the sequence
    ("stablelm_12b_reduced", "float32", False),
    ("stablelm_12b_reduced", "bfloat16", False),
    ("qwen2_5_32b_reduced", "float32", False),
    ("minicpm_2b_reduced", "float32", False),
])
def test_stepwise_decode_matches_reference(name, compute_dtype, ring):
    ref_cfg, ref_params, cfg, params = _setup(name, compute_dtype)
    B, T = 2, 12
    S = 8 if ring else T
    tokens = np.random.default_rng(2).integers(3, cfg.vocab_size, (B, T))
    cache_dtype = "float32" if compute_dtype == "float32" else "bfloat16"
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg,
                                     ring=ring, use_pallas=True))
    cj = jax_init_cache(ref_cfg, B, S, dtype=getattr(jnp, cache_dtype))
    ct = init_cache(cfg, B, S, dtype=getattr(torch, cache_dtype),
                    device="cpu")
    tol = TOL[compute_dtype]
    for t in range(T):
        # ragged positions: row 1 starts one step later
        pos = np.array([t, max(t - 1, 0)])
        tok = tokens[:, t]
        lj, cj = step(ref_params, cache=cj,
                      token=jnp.asarray(tok, jnp.int32),
                      pos=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            lt, ct = decode_step(params, cfg, ct, torch.from_numpy(tok),
                                 torch.from_numpy(pos), ring=ring)
        _close(lt, lj, tol)
    _close(ct["k"], cj["k"], tol)


def test_init_params_matches_reference_tree_and_scales():
    ref_cfg, ref_params, cfg, _ = _setup("qwen2_5_7b_reduced", "float32")
    params = init_params(3, cfg, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for path, a in flat_ref:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
    w = params["blocks"]["ffn"]["up"]["w"]
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert torch.equal(params["blocks"]["attn"]["wq"]["b"],
                       torch.zeros_like(params["blocks"]["attn"]["wq"]["b"]))
    again = init_params(3, cfg, device="cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


def test_cross_attention_paths_match_reference():
    """attend_full over projected memory (cross_kv, no mask) and the
    read-only attend_decode over it (write=False), fp32."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    ref_cfg, ref_params, cfg, params = _setup("tiny", "float32")
    pj = jax.tree.map(lambda a: a[0], ref_params["blocks"]["attn"])
    pt = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in params["blocks"]["attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    kvj = jattn.project_cross_kv(pj, jnp.asarray(mem), ref_cfg)
    kvt = tattn.project_cross_kv(pt, torch.from_numpy(mem), cfg)
    for a, b in zip(kvt, kvj):
        _close(a, b, 1e-5)
    with torch.no_grad():
        out_t = tattn.attend_full(pt, torch.from_numpy(x), cfg, cross_kv=kvt)
        dec_t, _ = tattn.attend_decode(
            pt, torch.from_numpy(x[:, :1]), {"k": kvt[0], "v": kvt[1]},
            torch.zeros(2, dtype=torch.long), cfg, write=False)
    out_j = jattn.attend_full(pj, jnp.asarray(x), ref_cfg, cross_kv=kvj)
    dec_j, _ = jattn.attend_decode(pj, jnp.asarray(x[:, :1]),
                                   {"k": kvj[0], "v": kvj[1]},
                                   jnp.zeros(2, jnp.int32), ref_cfg,
                                   write=False, use_pallas=True)
    _close(out_t, out_j, 1e-4)
    _close(dec_t, dec_j, 1e-4)
