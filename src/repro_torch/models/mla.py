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
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, causal_mask, write_slots
from repro_torch.models.layers import apply_rotary, dense, init_dense


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
    return p


def _queries(p, x, cfg, positions):
    """(q_nope (..., H, dn), q_rope (..., H, dr) rotated)."""
    dr, dn = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim
    if "w_dq" in p:
        q = dense(p["w_uq"], dense(p["w_dq"], x, x.dtype), x.dtype)
    else:
        q = dense(p["w_q"], x, x.dtype)
    q = q.reshape(*x.shape[:-1], cfg.num_heads, dn + dr)
    q_rope = apply_rotary(q[..., dn:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope


def _latents(p, x, cfg, positions):
    """The cache's rows for ``x``: (c_kv (..., r), k_rope (..., dr)), the
    shared rope key rotated as one head."""
    c_kv = dense(p["w_dkv"], x, x.dtype)
    k_rope = dense(p["w_krope"], x, x.dtype)[..., None, :]
    return c_kv, apply_rotary(k_rope, positions, cfg.rope_theta)[..., 0, :]


def _scale(cfg):
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


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


def mla_decode(p, x, layer_cache, pos, cfg, *, ring=False):
    """One-token absorbed decode. x: (B, 1, d); layer_cache: {"c_kv" (B, S,
    r), "k_rope" (B, S, dr)}; pos: (B,) absolute positions. ring=True
    writes slot ``pos % S`` and reads the ``min(pos + 1, S)`` filled
    slots; otherwise slot ``min(pos, S - 1)`` and keys ``<= pos``. The new
    row is written into ``layer_cache`` in place (the reference rebuilt
    the arrays). Returns (out (B, 1, d), layer_cache)."""
    B = x.shape[0]
    nh, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    cd = x.dtype
    q_nope, q_rope = _queries(p, x, cfg, pos[:, None])     # (B, 1, H, ·)
    c_new, kr_new = _latents(p, x, cfg, pos[:, None])

    ck, kr = layer_cache["c_kv"], layer_cache["k_rope"]
    S = ck.shape[1]
    # torch raises on an out-of-range index where JAX clamps: clamp
    # explicitly, as the reference does
    slot = pos % S if ring else torch.clamp(pos, max=S - 1)
    write_slots(ck, slot, c_new[:, 0].to(ck.dtype))
    write_slots(kr, slot, kr_new[:, 0].to(kr.dtype))
    ckc = ck.to(cd)

    # absorb: q_lat[h] = q_nope[h] @ W_uk[h]^T, a query in latent space
    w_uk = p["w_uk"]["w"].reshape(r, nh, dn).to(cd)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)   # (B, 1, H, r)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckc)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, kr.to(cd)))
    scores = scores.float() * _scale(cfg)

    kpos = torch.arange(S, device=x.device)[None, :]
    n_filled = torch.clamp(pos + 1, max=S)[:, None]
    valid = (kpos < n_filled) if ring else (kpos <= pos[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(cd)

    o_lat = torch.einsum("bhqk,bkr->bqhr", w, ckc)          # (B, 1, H, r)
    w_uv = p["w_uv"]["w"].reshape(r, nh, dv).to(cd)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    out = dense(p["wo"], out.reshape(B, 1, nh * dv), cd)
    return out, layer_cache
