"""Plain decoder-only GQA transformer (the Qwen2 block).

Per layer: RMSNorm; q, k, v projections with biases; split-half rotary
on q and k; causal softmax attention, each group of query heads sharing
one key/value head; the output projection; a residual add; RMSNorm; a
SwiGLU MLP; a residual add. Then a final RMSNorm and an untied (or tied)
head. The residual stream is held in the compute dtype, norms, rotary
and softmax run in float32, as the configuration states.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6


def layout(c: dict):
    """[(path, shape, init)] of the parameter tree the benchmark makes; the
    paths are the port's keys, layers stacked on a leading axis."""
    d, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], \
        c["head_dim"]
    F_, V, L = c["d_ff"], c["vocab_size"], c["num_layers"]
    w = ("normal", 0.0, 0.02)
    scale = ("normal", 1.0, 0.02)
    out = [(("embed", "table"), (V, d), w),
           (("final_norm", "scale"), (d,), scale)]
    if not c.get("tie_embeddings", False):
        out.append((("lm_head", "w"), (d, V), w))
    out.append((("blocks", "ln1", "scale"), (L, d), scale))
    for name, n_out in (("wq", H * hd), ("wk", KV * hd), ("wv", KV * hd)):
        out.append((("blocks", "attn", name, "w"), (L, d, n_out), w))
        if c.get("qkv_bias", False):
            out.append((("blocks", "attn", name, "b"), (L, n_out), w))
    out.append((("blocks", "attn", "wo", "w"), (L, H * hd, d), w))
    out.append((("blocks", "ln2", "scale"), (L, d), scale))
    for name, shape in (("up", (L, d, F_)), ("gate", (L, d, F_)),
                        ("down", (L, F_, d))):
        out.append((("blocks", "ffn", name, "w"), shape, w))
    return out


def rms_norm(x, scale):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)
    return (y * scale.float()).to(x.dtype)


def rotary(x, theta):
    """x (B, S, heads, hd) at positions 0..S-1, split-half rotation."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v):
    """Causal softmax attention in float32; q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).float()
    v = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def forward(params, tokens, c: dict, prec):
    """Logits (B, S, V) in float32 for tokens (B, S)."""
    cd = prec.act
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    theta = float(c.get("rope_theta", 10000.0))
    B, S = tokens.shape
    x = params["embed"]["table"][tokens].to(cd)
    blk = params["blocks"]
    att = blk["attn"]
    for i in range(c["num_layers"]):
        h = rms_norm(x, blk["ln1"]["scale"][i])

        def proj(name, n):
            y = prec.mm(h, att[name]["w"][i])
            if "b" in att[name]:
                y = y + att[name]["b"][i].to(cd)
            return y.reshape(B, S, n, hd)

        q = rotary(proj("wq", H), theta)
        k = rotary(proj("wk", KV), theta)
        v = proj("wv", KV)
        o = attention(q, k, v).reshape(B, S, H * hd)
        x = x + prec.mm(o, att["wo"]["w"][i])
        h = rms_norm(x, blk["ln2"]["scale"][i])
        ffn = blk["ffn"]
        g = F.silu(prec.mm(h, ffn["gate"]["w"][i]))
        x = x + prec.mm(prec.mm(h, ffn["up"]["w"][i]) * g,
                        ffn["down"]["w"][i])
    x = rms_norm(x, params["final_norm"]["scale"])
    head = params["embed"]["table"].T if c.get("tie_embeddings", False) \
        else params["lm_head"]["w"]
    return prec.mm(x, head).float()
