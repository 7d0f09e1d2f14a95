"""GQA/MHA attention with KV cache, causal and sliding-window masks.

Three entry points, as in the reference:
  * ``attend_full``   — training / prefill over a whole sequence.
  * ``attend_decode`` — one new token against a filled KV cache.
  * ``init_kv_cache`` — stacked-over-layers cache tensors.

Causal self-attention goes through ``kernels/flash_attention`` unless the
caller passes ``use_kernels=False``, and decode attention through
``kernels/decode_attention`` unless the caller passes a ``mesh``: on CUDA
tensors those launch the hand-written kernels, on CPU tensors they run
the kernels' plain versions. The flash
kernel has no backward (nor has the reference's Pallas kernel), so the
training forward takes ``use_kernels=False``: ``sdpa`` with a causal mask
(softmax weights cast to the compute dtype before ``p@v``), the
reference's plain path (``rl/grpo.py:54`` calls ``forward`` without
``use_pallas``). ``sdpa`` also serves cross- and non-causal attention.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _routes
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
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
                   causal=True, use_kernels=True):
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

    if use_kernels and cross_kv is None and causal:
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
                causal=True, use_kernels=True):
    """Full-sequence attention (train / prefill / encoder / cross).

    cross_kv: optional (k_src, v_src) already-projected encoder memory for
    cross-attention (no mask). use_kernels=False takes the plain,
    differentiable route for causal self-attention.
    """
    return attend_full_kv(p, x, cfg, positions, window=window,
                          cross_kv=cross_kv, causal=causal,
                          use_kernels=use_kernels)[0]


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


def write_slots(cache, slot, new):
    """``cache[b, slot[b]] = new[b]`` for every row ``b`` of a (B, S, ...)
    cache, in place. A DTensor cache is written on each rank's shard
    (``kernels/_routes.write_slots``): DTensor cannot write an indexed
    dim in place where it is split, and the batch dim is split."""
    if isinstance(cache, DTensor):
        return _routes.write_slots(cache, slot, new)
    cache[torch.arange(cache.shape[0], device=cache.device), slot] = new


def paged_cache(k_pool, v_pool, page_table, pos):
    """A decode cache that ``attend_decode`` reads through a page table:
    k/v_pool the page pools (..., num_pages, page_size, nkv, hd), one
    layer's or every layer's; page_table (B, P), row b's key j at row
    j % page_size of page ``page_table[b, j // page_size]``
    (S_cache = P * page_size); pos (B,). What every layer shares is made
    here once: ``rows``, the pool row (page * page_size + offset) that takes
    each batch row's new K/V, and ``valid``, the keys at or before ``pos``.
    A row's pages must hold ``pos``."""
    ps = k_pool.shape[-3]
    B, P = page_table.shape
    page = page_table[torch.arange(B, device=pos.device), pos // ps]
    kpos = torch.arange(P * ps, device=pos.device)[None, :]
    return {"k": k_pool, "v": v_pool, "page_table": page_table,
            "rows": page * ps + pos % ps, "valid": kpos <= pos[:, None]}


def attend_decode(p, x, layer_cache, pos, cfg, *, ring=False, write=True,
                  mesh=None):
    """One-token decode.

    x: (B, 1, d); layer_cache: {"k","v"} of (B, S_cache, nkv, hd), or one
    layer of a ``paged_cache`` (the continuous engine's decode round);
    pos: (B,) current absolute position of the new token.
    ring=True → sliding-window ring buffer (cache slot = pos % S_cache).
    write=False → read-only attention over the full provided cache (used for
    cross-attention with precomputed encoder K/V); no rotary on q either.
    mesh → the attention goes through ``distributed/flash_decode``'s
    sharded partial-softmax combine (cache seq dim sharded over the mesh's
    "model" axis) and launches no ``decode_attention``, as the reference
    routes it.

    The new K/V row is written into ``layer_cache`` in place (the reference
    rebuilt the arrays): a paged cache's at its pool row ``rows``, where
    the attention then reads every key through the table
    (``paged_decode_attention``), no per-row view gathered. A paged cache
    is in the compute dtype and takes neither ``ring``, ``mesh`` nor
    ``write=False``. Returns (out (B,1,d), layer_cache).
    """
    B = x.shape[0]
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = x.dtype
    q = _split_heads(dense(p["wq"], x, cd), nh, hd)

    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    S = k_cache.shape[1]
    paged = "page_table" in layer_cache
    if paged and (ring or mesh is not None or not write):
        raise ValueError("attend_decode: a paged cache takes neither ring, "
                         "mesh nor write=False")

    if write:
        q = apply_rotary(q, pos[:, None], cfg.rope_theta)
        k_new = _split_heads(dense(p["wk"], x, cd), nkv, hd)
        v_new = _split_heads(dense(p["wv"], x, cd), nkv, hd)
        k_new = apply_rotary(k_new, pos[:, None], cfg.rope_theta)

        if paged:
            rows = layer_cache["rows"]
            k_cache.view(-1, nkv, hd)[rows] = k_new[:, 0]
            v_cache.view(-1, nkv, hd)[rows] = v_new[:, 0]
            valid = layer_cache["valid"]
        else:
            # torch raises on an out-of-range index where JAX clamps:
            # clamp explicitly, as the reference does.
            slot = pos % S if ring else torch.clamp(pos, max=S - 1)
            write_slots(k_cache, slot, k_new[:, 0].to(k_cache.dtype))
            write_slots(v_cache, slot, v_new[:, 0].to(v_cache.dtype))
            kpos = torch.arange(S, device=x.device)[None, :]
            n_filled = torch.clamp(pos + 1, max=S)[:, None]
            valid = (kpos < n_filled) if ring else (kpos <= pos[:, None])
    else:
        valid = torch.ones((B, S), dtype=torch.bool, device=x.device)

    if paged:
        out = paged_decode_attention(q.contiguous(), k_cache, v_cache,
                                     layer_cache["page_table"], valid)
    elif mesh is not None:
        from repro_torch.distributed.flash_decode import \
            sharded_decode_attention
        out = sharded_decode_attention(q, k_cache.to(cd), v_cache.to(cd),
                                       valid, mesh=mesh)
    else:
        out = decode_attention(q.contiguous(), k_cache.to(cd).contiguous(),
                               v_cache.to(cd).contiguous(), valid)
    out = dense(p["wo"], out.reshape(B, 1, nh * hd), cd)
    return out, layer_cache
