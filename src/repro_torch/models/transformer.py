"""Decoder-only LM assembly — the dense, moe, vlm, ssm and hybrid families,
with GQA or MLA attention.

Layer stacks keep the reference's layout: one tree of tensors with a
leading layer axis (``params["blocks"]["attn"]["wq"]["w"]`` is
``(L, d, H*hd)``; an ssm block is ``{"ln", "mamba": {...}}``), walked here
by a Python loop where the reference used ``jax.lax.scan``. A moe model's
``blocks`` hold ``models/moe.py``'s experts as their ``ffn``, after
``cfg.first_dense_layers`` plain blocks stacked apart as
``dense_blocks``; its KV cache stacks all ``num_layers`` layers. The vlm
family is the dense trunk behind ``extra_embeds`` (stubbed vision patch
embeddings) prepended to the embedded tokens, which then start at
position T. A trunk with ``cfg.attention == "mla"`` runs
``models/mla.py`` in place of GQA: its blocks' ``attn`` hold the latent
projections, and its cache (prefill and decode) holds the latents
{"c_kv", "k_rope"} in place of {"k", "v"}. The hybrid (Griffin) family stacks whole (recurrent,
recurrent, attention) tiles: ``params["tiles"]["{i}_{kind}"]`` has a
leading tile axis, and the layers left over after the last whole tile are
a list, ``params["rem"]``. Its attention blocks are local
(``cfg.local_window``) and decode over a ring cache.
``forward_lm`` returns ``(logits, aux, cache_or_None)``: aux is the moe
load-balance loss summed over layers (0.0 for the other families);
``forward_hidden`` returns the trunk's final-norm hidden states that
``forward_lm`` unembeds (the PPO value head reads them).

The audio family (an encoder-decoder) is ``models/encdec.py``; the
model facade routes it there, and this module refuses it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense, dtype_of, embed, init_dense,
                                       init_embedding, init_mlp, init_norm,
                                       mlp, norm, unembed)


def _require_trunk(cfg):
    if not (cfg.arch_type in ("ssm", "hybrid")
            or (cfg.arch_type in ("dense", "moe", "vlm")
                and cfg.attention in ("gqa", "mla"))):
        raise ValueError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} attention="
            f"{cfg.attention!r} has no decoder-only trunk; this module runs "
            "dense, moe and vlm models with GQA or MLA attention, ssm and "
            "hybrid models (the audio family is models/encdec.py, reached "
            "through the models facade)")


def _layer(tree, i):
    """Layer ``i`` of a stacked param/cache tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _cache_layer(cache, i):
    """Layer ``i`` of a decode cache; a paged cache's table, rows and mask
    are the round's, not a layer's, so every layer gets them whole."""
    if "page_table" not in cache:
        return _layer(cache, i)
    return {**cache, "k": cache["k"][i], "v": cache["v"][i]}


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _init_block(gen, cfg, kind, layers, ffn_kind="dense"):
    """An attention block ({"ln1", "attn", "ln2", "ffn"}) or a recurrent
    one ({"ln1", "rec", "ln2", "ffn"}), stacked over ``layers``; the
    attention is MLA's latent projections under ``cfg.attention == "mla"``;
    the ffn is an MLP, or experts for ``ffn_kind="moe"``."""
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    if kind == "recurrent":
        mix = rglru_mod.init_rglru_block(gen, cfg, dt, layers=layers)
    elif cfg.attention == "mla":
        mix = mla_mod.init_mla(gen, cfg, dt, layers=layers)
    else:
        mix = attn.init_attention(gen, cfg, dt, layers=layers)
    ffn = (moe_mod.init_moe(gen, cfg, dt, layers=layers)
           if ffn_kind == "moe"
           else init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                         layers=layers))
    return {"ln1": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=layers),
            "rec" if kind == "recurrent" else "attn": mix,
            "ln2": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=layers),
            "ffn": ffn}


def init_lm(gen, cfg):
    """Parameters of a dense, moe, vlm, ssm or hybrid decoder, drawn on
    ``gen``'s device at the reference's init scales (normal 0.02, zero
    biases, unit norm scales; the mamba and RG-LRU blocks' own,
    ``models/ssm.py`` and ``models/rglru.py``)."""
    _require_trunk(cfg)
    dt, dev = dtype_of(cfg.param_dtype), gen.device
    L = (cfg.num_layers,)
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
              "final_norm": init_norm(cfg.norm, cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                       dtype=dt)
    if cfg.arch_type == "ssm":
        params["blocks"] = {
            "ln": init_norm(cfg.norm, cfg.d_model, dt, dev, layers=L),
            "mamba": ssm_mod.init_mamba(gen, cfg, dt, layers=L)}
    elif cfg.arch_type == "hybrid":
        layout = _hybrid_layout(cfg)
        n_tiles = sum(1 for layer in layout if layer.i == 0
                      and layer.tile is not None)
        if n_tiles:
            params["tiles"] = {f"{layer.i}_{layer.kind}": _init_block(
                gen, cfg, layer.kind, (n_tiles,))
                for layer in layout if layer.tile == 0}
        rem = [layer.kind for layer in layout if layer.tile is None]
        if rem:
            params["rem"] = [_init_block(gen, cfg, kind, ()) for kind in rem]
    elif cfg.arch_type == "moe":
        nd = cfg.first_dense_layers
        if nd:
            params["dense_blocks"] = _init_block(gen, cfg, "attention", (nd,))
        params["blocks"] = _init_block(gen, cfg, "attention",
                                       (cfg.num_layers - nd,), "moe")
    else:
        params["blocks"] = _init_block(gen, cfg, "attention", L)
    return params


def _attn_stacks(params, cfg):
    """(ffn kind, stacked blocks, their depth, cache key) of a dense, moe
    or vlm trunk in layer order: a moe model's ``first_dense_layers`` come
    first."""
    if cfg.arch_type != "moe":
        return [("dense", params["blocks"], cfg.num_layers, "kv")]
    nd = cfg.first_dense_layers
    stacks = [("moe", params["blocks"], cfg.num_layers - nd, "kv")]
    if nd:
        stacks.insert(0, ("dense", params["dense_blocks"], nd, "dense_kv"))
    return stacks


class HybridLayer(NamedTuple):
    kind: str            # "recurrent" or "attention"
    tile: Optional[int]  # its tile, or None for a remainder layer
    i: int               # its place in the pattern (and in ``rem``)
    j: int               # its index among the layers of its kind (cache)


def _hybrid_layout(cfg):
    """The hybrid's layers in order, as in the reference: whole tiles of
    ``cfg.rglru_block_pattern``, then the pattern's first
    ``num_layers % len(pattern)`` kinds as remainder layers."""
    pat = cfg.rglru_block_pattern
    n_tiles, rem = divmod(cfg.num_layers, len(pat))
    places = [(t, i) for t in range(n_tiles) for i in range(len(pat))]
    places += [(None, i) for i in range(rem)]
    seen = {"recurrent": 0, "attention": 0}
    layout = []
    for t, i in places:
        layout.append(HybridLayer(pat[i], t, i, seen[pat[i]]))
        seen[pat[i]] += 1
    return layout


def _hybrid_layers(params, cfg):
    """(layout entry, block params) of each hybrid layer in order; tile
    layers are views into the stacked tree."""
    for layer in _hybrid_layout(cfg):
        if layer.tile is None:
            yield layer, params["rem"][layer.i]
        else:
            yield layer, _layer(
                params["tiles"][f"{layer.i}_{layer.kind}"], layer.tile)


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg, ffn_kind):
    """The block's feed-forward: (y, the moe load-balance loss or 0.0)."""
    if ffn_kind == "moe":
        return moe_mod.moe_ffn(p, h, cfg)
    return mlp(p, h, cfg.activation, h.dtype), 0.0


def _attn_block_full(p, x, cfg, *, window, positions, use_kernels,
                     ffn_kind="dense"):
    """(x out, the moe aux loss or 0.0, the block's cache rows: {"k", "v"}
    or MLA's {"c_kv", "k_rope"}). MLA runs no kernel on any route."""
    h = norm(p["ln1"], x)
    if cfg.attention == "mla":
        y, kv = mla_mod.mla_full_kv(p["attn"], h, cfg, positions,
                                    window=window)
    else:
        y, k, v = attn.attend_full_kv(p["attn"], h, cfg, positions,
                                      window=window, use_kernels=use_kernels)
        kv = {"k": k, "v": v}
    x = x + y
    y, aux = _ffn(p["ffn"], norm(p["ln2"], x), cfg, ffn_kind)
    return x + y, aux, kv


def _rec_block_full(p, x, cfg, *, use_kernels):
    x = x + rglru_mod.rglru_full(p["rec"], norm(p["ln1"], x), cfg,
                                 use_kernels=use_kernels)
    return x + mlp(p["ffn"], norm(p["ln2"], x), cfg.activation, x.dtype)


def forward_lm(params, cfg, tokens, *, extra_embeds=None, window=0,
               return_cache=False, positions=None, use_kernels=True):
    """tokens: (B, S) int; extra_embeds: (B, T, d) prepended (the vlm's
    vision stub). Returns (logits (B, T + S, V), aux, cache_or_None); the
    cache is {"kv": {"k", "v"}} of (L, B, T + S, KVH, hd), or under MLA
    {"kv": {"c_kv" (L, B, S, r), "k_rope" (L, B, S, dr)}}, and a moe model
    with ``first_dense_layers`` keeps those layers' apart as
    {"dense_kv": ...}, as the reference does. use_kernels=False takes the
    plain, differentiable attention and scan routes (training). The ssm
    family builds no prefill cache, as in the reference: its decode state
    comes from stepping through the prompt. The hybrid's attention runs at
    ``cfg.local_window`` whatever ``window`` is, and its cache is the
    reference's {"att_kv": {"k", "v"}} of the tiles' attention layers
    (None without a whole tile)."""
    if return_cache and cfg.arch_type == "ssm":
        raise ValueError(f"{cfg.name}: the ssm family has no prefill cache; "
                         "feed the prompt through decode_step")
    x, aux, cache = _forward_trunk(
        params, cfg, tokens, extra_embeds=extra_embeds, window=window,
        positions=positions, use_kernels=use_kernels, return_kv=return_cache)
    cd = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cd)
    else:
        logits = dense(params["lm_head"], x, cd)
    return logits, aux, cache


def forward_hidden(params, cfg, tokens, *, extra_embeds=None,
                   use_kernels=True, positions=None, window=0):
    """Final-norm hidden states (B, T + S, d), the trunk of ``forward_lm``
    without the unembed: what the PPO value head reads. ``use_kernels``
    picks the route as in ``forward_lm``."""
    return _forward_trunk(params, cfg, tokens, extra_embeds=extra_embeds,
                          window=window, positions=positions,
                          use_kernels=use_kernels, return_kv=False)[0]


def _stacked(kvs):
    """Per-layer cache rows {name: (B, S, ...)} stacked over layers."""
    return {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]} \
        if kvs else None


def _forward_trunk(params, cfg, tokens, *, extra_embeds=None, window,
                   positions, use_kernels, return_kv):
    """The forward up to and including ``final_norm``: (hidden (B, S, d),
    aux, the prefill cache of ``forward_lm`` or None)."""
    _require_trunk(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], tokens, cd)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cd), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    aux, cache = 0.0, {}
    if cfg.arch_type == "hybrid":
        kvs = []
        for layer, p in _hybrid_layers(params, cfg):
            if layer.kind == "recurrent":
                x = _rec_block_full(p, x, cfg, use_kernels=use_kernels)
                continue
            x, _, kv = _attn_block_full(p, x, cfg, window=cfg.local_window,
                                        positions=positions,
                                        use_kernels=use_kernels)
            if return_kv and layer.tile is not None:
                kvs.append(kv)
        cache["att_kv"] = _stacked(kvs)
    elif cfg.arch_type == "ssm":
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            x = x + ssm_mod.mamba_full(p["mamba"], norm(p["ln"], x), cfg,
                                       use_kernels=use_kernels,
                                       chunk=cfg.ssm_chunk)
    else:
        for ffn_kind, blocks, n, key in _attn_stacks(params, cfg):
            kvs = []
            for i in range(n):
                x, a, kv = _attn_block_full(
                    _layer(blocks, i), x, cfg, window=window,
                    positions=positions, use_kernels=use_kernels,
                    ffn_kind=ffn_kind)
                aux = aux + a
                if return_kv:
                    kvs.append(kv)
            cache[key] = _stacked(kvs)
    return norm(params["final_norm"], x), aux, (cache if return_kv else None)


# ---------------------------------------------------------------------------
# Decode (one token vs cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch, length, dtype=torch.bfloat16, device=None):
    """Cache tensors for decode shapes; ``length`` = KV window kept (a vlm
    prefix's T positions included). A moe model's cache stacks all its
    layers, the dense ones first. The ssm and RG-LRU states have no
    sequence axis and stay fp32 whatever ``dtype``, as in the reference.
    The hybrid keeps {"rec": its recurrent layers' states, "att": a ring
    of min(length, cfg.local_window) keys per attention layer}; an MLA
    trunk the latents {"c_kv", "k_rope"} of all its layers."""
    _require_trunk(cfg)
    if cfg.arch_type == "ssm":
        return ssm_mod.init_mamba_cache(cfg, batch, device=device)
    if cfg.arch_type == "hybrid":
        kinds = [layer.kind for layer in _hybrid_layout(cfg)]
        n_att = kinds.count("attention")
        return {"rec": rglru_mod.init_rglru_cache(cfg, batch,
                                                  len(kinds) - n_att,
                                                  device=device),
                "att": attn.init_kv_cache(cfg, batch,
                                          min(length, cfg.local_window),
                                          dtype, layers=n_att,
                                          device=device)}
    if cfg.attention == "mla":
        return mla_mod.init_mla_cache(cfg, batch, length, dtype,
                                      device=device)
    return attn.init_kv_cache(cfg, batch, length, dtype, device=device)


def decode_lm(params, cfg, cache, token, pos, *, ring=False, mesh=None):
    """token: (B,) int; pos: (B,) absolute positions.
    Returns (logits (B, V), cache); the cache is updated in place. A GQA
    trunk's cache may be paged: ``attention.paged_cache`` over the page
    pools of every layer (L, num_pages, page_size, KVH, hd).

    ``mesh`` routes the GQA attention of the dense, moe and vlm trunks
    through ``distributed/flash_decode``'s sharded combine (no
    ``decode_attention`` launch), as the reference's does; MLA, the ssm
    and the hybrid ignore it, as the reference's do."""
    _require_trunk(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embed(params["embed"], token[:, None], cd)  # (B,1,d)
    if cfg.arch_type == "hybrid":
        for layer, p in _hybrid_layers(params, cfg):
            if layer.kind == "recurrent":
                y, _ = rglru_mod.rglru_decode(
                    p["rec"], norm(p["ln1"], x),
                    _layer(cache["rec"], layer.j), cfg)
            else:       # the reference's hybrid decode always rings
                y, _ = attn.attend_decode(
                    p["attn"], norm(p["ln1"], x),
                    _layer(cache["att"], layer.j), pos, cfg, ring=True)
            x = x + y
            x = x + mlp(p["ffn"], norm(p["ln2"], x), cfg.activation, cd)
    elif cfg.arch_type == "ssm":
        for i in range(cfg.num_layers):
            p = _layer(params["blocks"], i)
            y, _ = ssm_mod.mamba_decode(p["mamba"], norm(p["ln"], x),
                                        _layer(cache, i), cfg)
            x = x + y
    else:           # layer i of the stacks reads and writes cache layer i
        layers = [(ffn_kind, _layer(blocks, j))
                  for ffn_kind, blocks, n, _ in _attn_stacks(params, cfg)
                  for j in range(n)]
        for i, (ffn_kind, p) in enumerate(layers):
            h = norm(p["ln1"], x)
            if cfg.attention == "mla":
                y, _ = mla_mod.mla_decode(p["attn"], h, _layer(cache, i),
                                          pos, cfg, ring=ring)
            else:
                y, _ = attn.attend_decode(p["attn"], h,
                                          _cache_layer(cache, i), pos, cfg,
                                          ring=ring, mesh=mesh)
            x = x + y
            y, _ = _ffn(p["ffn"], norm(p["ln2"], x), cfg, ffn_kind)
            x = x + y

    x = norm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x, cd)
    else:
        logits = dense(params["lm_head"], x, cd)
    return logits[:, 0], cache
