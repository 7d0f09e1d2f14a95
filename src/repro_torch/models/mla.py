"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

K and V are compressed into a per-token latent ``c_kv`` (``kv_lora_rank``)
plus one rotated key ``k_rope`` shared by every head; the cache keeps only
those two, ``{"c_kv": (L, B, S, r), "k_rope": (L, B, S, dr)}``.

Training and prefill (``mla_full``) expand the latent into per-head keys
and values. Decode (``mla_decode``) is absorbed, as in the reference:
``W_uk`` is folded into the query and ``W_uv`` applied after attention,
so a step reads ``O(S·r)`` of cache and never expands K or V. The
reference computes both with einsums and no Pallas kernel, so the port's
are plain PyTorch on every route. Each product runs in the compute dtype
and is rounded there, at the reference's points: the two score terms
apart before they are added, then fp32 and the scale; the softmax weights
back to the compute dtype before they weight the values.

DeepSeek-V2's published attention adds three things the reference lacks,
each off unless its config field turns it on: RMSNorms on the q and kv
latents (``cfg.mla_latent_norm``; params ``q_norm``, ``kv_norm``), so a
cache row is ``[RMSNorm(W_dkv x), rope(W_krope x)]``; YaRN frequencies on
the rope dims (``cfg.yarn_factor`` > 1); and the softmax scale times
``mscale(factor, mscale_all_dim)^2``.

The continuous engine keeps the latents in a page pool, one
``r + dr``-wide row per token and layer (``paged_latent_cache``); its
decode rounds write each new row into its page and gather one layer's
rows through the page table at a time.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.attention import NEG_INF, causal_mask, write_slots
from repro_torch.models.layers import (apply_rotary, dense, init_dense,
                                       init_norm, norm, rotary_freqs)


def init_mla(gen, cfg, dtype=torch.float32, layers=()):
    """``w_dkv`` (d, r), ``w_krope`` (d, dr), ``w_uk`` (r, H·dn), ``w_uv``
    (r, H·dv), ``wo`` (H·dv, d), and the query: ``w_dq`` (d, q_lora_rank)
    then ``w_uq`` (q_lora_rank, H·(dn + dr)) when ``q_lora_rank`` > 0,
    else ``w_q`` (d, H·(dn + dr)); ``layers`` prepends stacked axes."""
    d, nh = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, layers=layers)
    p = {"w_dkv": init_dense(gen, d, r, **kw),
         "w_krope": init_dense(gen, d, dr, **kw),
         "w_uk": init_dense(gen, r, nh * dn, **kw),
         "w_uv": init_dense(gen, r, nh * dv, **kw),
         "wo": init_dense(gen, nh * dv, d, **kw)}
    q_dim = nh * (dn + dr)
    if qr:
        p["w_dq"] = init_dense(gen, d, qr, **kw)
        p["w_uq"] = init_dense(gen, qr, q_dim, **kw)
    else:
        p["w_q"] = init_dense(gen, d, q_dim, **kw)
    if cfg.mla_latent_norm:
        dev = gen.device
        p["kv_norm"] = init_norm("rmsnorm", r, dtype, dev, layers=layers)
        if qr:
            p["q_norm"] = init_norm("rmsnorm", qr, dtype, dev, layers=layers)
    return p


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: ``0.1 * mscale * ln(factor) + 1`` (1 for a
    factor of at most 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(dim: int, theta: float, factor: float, original: int,
               beta_fast: float, beta_slow: float) -> np.ndarray:
    """DeepSeek-V2's YaRN table over ``dim // 2`` rotary pairs (numpy
    fp32): pair i keeps its frequency below the correction range, takes
    it over ``factor`` above it, and blends linearly inside it. The range
    is the dims where the original positions turn ``beta_fast`` and
    ``beta_slow`` times (floor and ceil, clipped to [0, dim - 1])."""
    def turns_dim(n):
        return dim * math.log(original / (n * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(turns_dim(beta_fast)), 0)
    high = min(math.ceil(turns_dim(beta_slow)), dim - 1)
    freq = rotary_freqs(dim, theta)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low)
                   / max(high - low, 1e-3), 0, 1).astype(np.float32)
    return (freq / np.float32(factor) * ramp
            + freq * (np.float32(1) - ramp)).astype(np.float32)


def _rope(x, positions, cfg):
    """Split-half rotary of the rope dims, YaRN's where configured (cos
    and sin unscaled: DeepSeek-V2's mscale equals its mscale_all_dim)."""
    if cfg.yarn_factor <= 1:
        return apply_rotary(x, positions, cfg.rope_theta)
    return apply_rotary(x, positions, cfg.rope_theta, yarn_freqs(
        x.shape[-1], cfg.rope_theta, cfg.yarn_factor,
        cfg.yarn_original_positions, cfg.yarn_beta_fast, cfg.yarn_beta_slow))


def _queries(p, x, cfg, positions):
    """(q_nope (..., H, dn), q_rope (..., H, dr) rotated)."""
    dr, dn = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    if "w_dq" in p:
        cq = dense(p["w_dq"], x, x.dtype)
        if "q_norm" in p:
            cq = norm(p["q_norm"], cq)
        q = dense(p["w_uq"], cq, x.dtype)
    else:
        q = dense(p["w_q"], x, x.dtype)
    q = q.reshape(*x.shape[:-1], cfg.num_heads, dn + dr)
    return q[..., :dn], _rope(q[..., dn:], positions, cfg)


def _latents(p, x, cfg, positions):
    """The cache's rows for ``x``: (c_kv (..., r), normed where
    configured; k_rope (..., dr), the shared rope key rotated as one
    head)."""
    c_kv = dense(p["w_dkv"], x, x.dtype)
    if "kv_norm" in p:
        c_kv = norm(p["kv_norm"], c_kv)
    k_rope = dense(p["w_krope"], x, x.dtype)[..., None, :]
    return c_kv, _rope(k_rope, positions, cfg)[..., 0, :]


def _scale(cfg):
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) \
        if cfg.yarn_mscale_all_dim else 1.0
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def mla_full_kv(p, x, cfg, positions=None, *, window=0):
    """``mla_full`` that also returns the latents it projected,
    ``{"c_kv": (B, S, r), "k_rope": (B, S, dr)}``, so the prefill cache
    reuses them instead of projecting again."""
    B, S, _ = x.shape
    nh, dn, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    cd = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)
    k_nope = dense(p["w_uk"], c_kv, cd).reshape(B, S, nh, dn)
    v = dense(p["w_uv"], c_kv, cd).reshape(B, S, nh, dv)

    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope))
    scores = scores.float() * _scale(cfg)
    mask = causal_mask(S, S, window=window, device=x.device)
    w = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1).to(cd)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    y = dense(p["wo"], out.reshape(B, S, nh * dv), cd)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_full(p, x, cfg, positions=None, *, window=0):
    """Training / prefill MLA over a full sequence (naive expansion):
    x (B, S, d) -> (B, S, d); ``window`` > 0 bounds the causal band."""
    return mla_full_kv(p, x, cfg, positions, window=window)[0]


def init_mla_cache(cfg, batch, length, dtype=torch.bfloat16, layers=None,
                   device=None):
    """The latent cache stacked over layers: c_kv (L, B, S, r) and k_rope
    (L, B, S, dr)."""
    L = cfg.num_layers if layers is None else layers
    return {"c_kv": torch.zeros((L, batch, length, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((L, batch, length, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def paged_latent_cache(pool, page_table, pos):
    """A decode cache that ``mla_decode`` reads through a page table: pool
    the latent page pool (..., num_pages, page_size, r + dr), one layer's
    or every layer's (``c_kv`` then ``k_rope`` in a row); page_table
    (B, P), row b's key j at row j % page_size of page
    ``page_table[b, j // page_size]``; pos (B,). What every layer shares
    is made here once: ``rows``, the pool row that takes each batch row's
    new latent, and ``valid``, the keys at or before ``pos``. A row's pages
    must hold ``pos``."""
    ps = pool.shape[-2]
    B, P = page_table.shape
    page = page_table[torch.arange(B, device=pos.device), pos // ps]
    kpos = torch.arange(P * ps, device=pos.device)[None, :]
    return {"latent": pool, "page_table": page_table,
            "rows": page * ps + pos % ps, "valid": kpos <= pos[:, None]}


def mla_decode(p, x, layer_cache, pos, cfg, *, ring=False):
    """One-token absorbed decode. x: (B, 1, d); layer_cache: {"c_kv" (B, S,
    r), "k_rope" (B, S, dr)}, or one layer of a ``paged_latent_cache``;
    pos: (B,) absolute positions. ring=True writes slot ``pos % S`` and
    reads the ``min(pos + 1, S)`` filled slots; otherwise slot
    ``min(pos, S - 1)`` and keys ``<= pos``. The new row is written into
    ``layer_cache`` in place (the reference rebuilt the arrays): a paged
    cache's at its pool row ``rows``, after which this layer's rows are
    gathered through the table (a paged cache takes no ``ring``). Returns
    (out (B, 1, d), layer_cache)."""
    B = x.shape[0]
    nh, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    cd = x.dtype
    q_nope, q_rope = _queries(p, x, cfg, pos[:, None])     # (B, 1, H, ·)
    c_new, kr_new = _latents(p, x, cfg, pos[:, None])

    if "page_table" in layer_cache:
        if ring:
            raise ValueError("mla_decode: a paged cache takes no ring")
        pool = layer_cache["latent"]                       # (P, ps, r + dr)
        width = pool.shape[-1]
        pool.view(-1, width)[layer_cache["rows"]] = torch.cat(
            [c_new[:, 0], kr_new[:, 0]], -1).to(pool.dtype)
        lat = pool[layer_cache["page_table"]].reshape(B, -1, width).to(cd)
        ckc, krc = lat[..., :r], lat[..., r:]
        valid = layer_cache["valid"]
    else:
        ck, kr = layer_cache["c_kv"], layer_cache["k_rope"]
        S = ck.shape[1]
        # torch raises on an out-of-range index where JAX clamps: clamp
        # explicitly, as the reference does
        slot = pos % S if ring else torch.clamp(pos, max=S - 1)
        write_slots(ck, slot, c_new[:, 0].to(ck.dtype))
        write_slots(kr, slot, kr_new[:, 0].to(kr.dtype))
        ckc, krc = ck.to(cd), kr.to(cd)
        kpos = torch.arange(S, device=x.device)[None, :]
        n_filled = torch.clamp(pos + 1, max=S)[:, None]
        valid = (kpos < n_filled) if ring else (kpos <= pos[:, None])

    # absorb: q_lat[h] = q_nope[h] @ W_uk[h]^T, a query in latent space
    w_uk = p["w_uk"]["w"].reshape(r, nh, dn).to(cd)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)   # (B, 1, H, r)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckc)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, krc))
    scores = scores.float() * _scale(cfg)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cd)

    o_lat = torch.einsum("bhqk,bkr->bqhr", w, ckc)          # (B, 1, H, r)
    w_uv = p["w_uv"]["w"].reshape(r, nh, dv).to(cd)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    out = dense(p["wo"], out.reshape(B, 1, nh * dv), cd)
    return out, layer_cache
