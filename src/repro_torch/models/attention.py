"""GQA/MHA attention with KV cache, causal and sliding-window masks.

Three entry points, as in the reference:
  * ``attend_full``   — training / prefill over a whole sequence.
  * ``attend_decode`` — one new token against a filled KV cache.
  * ``init_kv_cache`` — stacked-over-layers cache tensors.

Causal self-attention goes through ``kernels/flash_attention`` unless the
caller passes ``use_flash=False``, and decode attention through
``kernels/decode_attention``: on CUDA tensors those launch the hand-written
kernels, on CPU tensors they run the kernels' plain versions. The flash
kernel has no backward (nor has the reference's Pallas kernel), so the
training forward takes ``use_flash=False``: ``sdpa`` with a causal mask
(softmax weights cast to the compute dtype before ``p@v``), the
reference's plain path (``rl/grpo.py:54`` calls ``forward`` without
``use_pallas``). ``sdpa`` also serves cross- and non-causal attention.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rotary, dense, init_dense

# Finite on purpose: idle decode slots and fully masked rows then get a
# uniform softmax instead of NaN.
NEG_INF = -1e30


def init_attention(gen, cfg, dtype=torch.float32, layers=()):
    nh, nkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, layers=layers)
    return {
        "wq": init_dense(gen, d, nh * hd, bias=cfg.qkv_bias, **kw),
        "wk": init_dense(gen, d, nkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": init_dense(gen, d, nkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": init_dense(gen, nh * hd, d, **kw),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def sdpa(q, k, v, mask):
    """q: (B,Sq,H,hd) k/v: (B,Sk,H,hd) mask: broadcastable (B,1,Sq,Sk)."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd ** -0.5
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def causal_mask(sq, sk, window=0, device=None):
    """(1,1,sq,sk) causal mask; ``window``>0 adds a sliding-window band."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None]


def attend_full_kv(p, x, cfg, positions=None, *, window=0, cross_kv=None,
                   causal=True, use_flash=True):
    """``attend_full`` that also returns the rotated K and projected V it
    used, so the prefill cache reuses them instead of projecting again."""
    B, S, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = x.dtype
    q = _split_heads(dense(p["wq"], x, cd), nh, hd)
    if cross_kv is None:
        k = _split_heads(dense(p["wk"], x, cd), nkv, hd)
        v = _split_heads(dense(p["wv"], x, cd), nkv, hd)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rotary(q, positions, cfg.rope_theta)
        k = apply_rotary(k, positions, cfg.rope_theta)
    else:
        k, v = cross_kv

    if use_flash and cross_kv is None and causal:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              window=window)
    else:
        kk = _repeat_kv(k, nh // k.shape[2])
        vv = _repeat_kv(v, nh // v.shape[2])
        if cross_kv is not None or not causal:
            mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                              device=x.device)
        else:
            mask = causal_mask(S, S, window=window, device=x.device)
        out = sdpa(q, kk, vv, mask)
    return dense(p["wo"], out.reshape(B, S, nh * hd), cd), k, v


def attend_full(p, x, cfg, positions=None, *, window=0, cross_kv=None,
                causal=True, use_flash=True):
    """Full-sequence attention (train / prefill / encoder / cross).

    cross_kv: optional (k_src, v_src) already-projected encoder memory for
    cross-attention (no mask). use_flash=False takes the plain,
    differentiable route for causal self-attention.
    """
    return attend_full_kv(p, x, cfg, positions, window=window,
                          cross_kv=cross_kv, causal=causal,
                          use_flash=use_flash)[0]


def project_cross_kv(p, memory, cfg):
    """Precompute encoder K/V once for all decode steps."""
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = _split_heads(dense(p["wk"], memory, memory.dtype), nkv, hd)
    v = _split_heads(dense(p["wv"], memory, memory.dtype), nkv, hd)
    return k, v


def init_kv_cache(cfg, batch, length, dtype=torch.bfloat16, layers=None,
                  device=None):
    """Stacked-over-layers GQA cache, (L, B, S, KVH, hd) each."""
    L = cfg.num_layers if layers is None else layers
    shape = (L, batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_decode(p, x, layer_cache, pos, cfg, *, ring=False, write=True):
    """One-token decode.

    x: (B, 1, d); layer_cache: {"k","v"} of (B, S_cache, nkv, hd);
    pos: (B,) current absolute position of the new token.
    ring=True → sliding-window ring buffer (cache slot = pos % S_cache).
    write=False → read-only attention over the full provided cache (used for
    cross-attention with precomputed encoder K/V); no rotary on q either.

    The new K/V row is written into ``layer_cache`` in place (the reference
    rebuilt the arrays). Returns (out (B,1,d), layer_cache).
    """
    B = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = x.dtype
    q = _split_heads(dense(p["wq"], x, cd), nh, hd)

    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    S = k_cache.shape[1]

    if write:
        q = apply_rotary(q, pos[:, None], cfg.rope_theta)
        k_new = _split_heads(dense(p["wk"], x, cd), nkv, hd)
        v_new = _split_heads(dense(p["wv"], x, cd), nkv, hd)
        k_new = apply_rotary(k_new, pos[:, None], cfg.rope_theta)

        # torch raises on an out-of-range index where JAX clamps: clamp
        # explicitly, as the reference does.
        slot = pos % S if ring else torch.clamp(pos, max=S - 1)
        bidx = torch.arange(B, device=x.device)
        k_cache[bidx, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[bidx, slot] = v_new[:, 0].to(v_cache.dtype)

        kpos = torch.arange(S, device=x.device)[None, :]
        n_filled = torch.clamp(pos + 1, max=S)[:, None]
        valid = (kpos < n_filled) if ring else (kpos <= pos[:, None])
    else:
        valid = torch.ones((B, S), dtype=torch.bool, device=x.device)

    out = decode_attention(q.contiguous(), k_cache.to(cd).contiguous(),
                           v_cache.to(cd).contiguous(), valid)
    out = dense(p["wo"], out.reshape(B, 1, nh * hd), cd)
    return out, layer_cache
