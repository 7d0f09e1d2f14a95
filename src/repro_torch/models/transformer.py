"""Decoder-only LM assembly — the dense family.

Layer stacks keep the reference's layout: one tree of tensors with a
leading layer axis (``params["blocks"]["attn"]["wq"]["w"]`` is
``(L, d, H*hd)``), walked here by a Python loop where the reference used
``jax.lax.scan``. ``forward_lm`` returns ``(logits, aux, cache_or_None)``
with aux 0 (no MoE yet).

The moe, ssm, hybrid and vlm families, and MLA attention, are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, dtype_of, embed, init_dense,
                                       init_embedding, init_mlp, init_norm,
                                       mlp, norm, unembed)


def _require_dense(cfg):
    if cfg.arch_type != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} attention="
            f"{cfg.attention!r} is not ported yet (ROADMAP §1, item "
            "'the other model families'); the port runs dense GQA models")


def _layer(tree, i):
    """Layer ``i`` of a stacked param/cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def init_lm(gen, cfg):
    """Parameters of a dense decoder, drawn on ``gen``'s device at the
    reference's init scales (normal 0.02, zero biases, unit norm scales)."""
    _require_dense(cfg)
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    L = (cfg.num_layers,)
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
              "final_norm": init_norm(cfg.norm, cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                       dtype=dt)
    params["blocks"] = {
        "ln1": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=L),
        "attn": attn.init_attention(gen, cfg, dt, layers=L),
        "ln2": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=L),
        "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        layers=L),
    }
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _attn_block_full(p, x, cfg, *, window, positions, use_flash):
    h = norm(p["ln1"], x)
    y, k, v = attn.attend_full_kv(p["attn"], h, cfg, positions,
                                  window=window, use_flash=use_flash)
    x = x + y
    h = norm(p["ln2"], x)
    return x + mlp(p["ffn"], h, cfg.activation, x.dtype), k, v


def forward_lm(params, cfg, tokens, *, window=0, return_cache=False,
               positions=None, use_flash=True):
    """tokens: (B, S) int. Returns (logits (B, S, V), aux, cache_or_None);
    the cache is {"kv": {"k", "v"}} of (L, B, S, KVH, hd). use_flash=False
    takes the plain, differentiable attention route (training)."""
    _require_dense(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v = _attn_block_full(_layer(params["blocks"], i), x, cfg,
                                   window=window, positions=positions,
                                   use_flash=use_flash)
        if return_cache:
            ks.append(k)
            vs.append(v)

    x = norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cd)
    else:
        logits = dense(params["lm_head"], x, cd)
    cache = None
    if return_cache:
        cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return logits, 0.0, cache


# ---------------------------------------------------------------------------
# Decode (one token vs cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, length, dtype=torch.bfloat16, device=None):
    """Cache tensors for decode shapes; ``length`` = KV window kept."""
    _require_dense(cfg)
    return attn.init_kv_cache(cfg, batch, length, dtype, device=device)


def decode_lm(params, cfg, cache, token, pos, *, ring=False):
    """token: (B,) int; pos: (B,) absolute positions.
    Returns (logits (B, V), cache); the cache is updated in place."""
    _require_dense(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], token[:, None], cd)  # (B,1,d)
    for i in range(cfg.num_layers):
        p = _layer(params["blocks"], i)
        h = norm(p["ln1"], x)
        y, _ = attn.attend_decode(p["attn"], h, _layer(cache, i), pos, cfg,
                                  ring=ring)
        x = x + y
        h = norm(p["ln2"], x)
        x = x + mlp(p["ffn"], h, cfg.activation, x.dtype)

    x = norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cd)
    else:
        logits = dense(params["lm_head"], x, cd)
    return logits[:, 0], cache
