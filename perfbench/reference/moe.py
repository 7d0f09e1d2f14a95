"""Plain DeepSeek-V2 block (MLA attention, shared and routed experts), at
one chip's share of its expert layers.

Per layer: RMSNorm; multi-head latent attention; a residual add;
RMSNorm; a feed-forward; a residual add. The first
``first_dense_layers`` layers' feed-forward is a SwiGLU MLP, the rest's
the shared experts plus the routed experts this chip holds. Then a final
RMSNorm and an untied head.

Attention, as DeepSeek-V2 publishes it, computed whole (no cache, no
absorption): ``q = W_uq RMSNorm(W_dq x)``, split into a no-rope part and
a rope part; the latent ``c = RMSNorm(W_dkv x)`` expands into per-head
keys ``W_uk c`` and values ``W_uv c``; one rope key ``W_krope x`` is
shared by every head; causal softmax over ``q_nope . k_nope + q_rope .
k_rope`` times ``(dn + dr)^-0.5 * m^2``, m YaRN's attention factor
``0.1 * mscale_all_dim * ln(factor) + 1``; the rope dims rotate by YaRN's
frequencies (below the correction range as published, above it over
``factor``, blended linearly in between; the range from beta_fast and
beta_slow at the original positions).

Routing, as published: the gate's product in float32, softmax over all
experts, the top ``moe_device_limit`` of ``moe_ep_degree`` groups by
their largest score, the top ``top_k`` experts within them (ties to the
lower index), weights not renormalised (unless ``moe_norm_topk``) and
times ``moe_routed_scale``. No pick is dropped.

Departures from the published model, each the chip's share or the
benchmark's: only the experts ``moe_held_first`` .. ``+ moe_held_experts``
are held, and a pick of any other expert adds nothing (what the other
chips would add is left out, in the program and here alike); the rope
dims rotate split-half, where the checkpoint pairs them interleaved (with
random weights a fixed permutation of ``w_uq``'s and ``w_krope``'s rope
columns); the weights are random.

The residual stream is held in the compute dtype; weight products run in
bfloat16 through ``prec.mm`` (the router's in float32); norms, rotary,
the attention's scores, softmax and weighted sum, and the routed
experts' weighted sum run in float32. It imports nothing of the port.

``forward`` can also be routed as given: ``picks`` names, for the first
positions of a sequence and each MoE layer, the held experts a token
went to (each expert's index among those held; the count held for an
expert held elsewhere), and the layer then computes those experts, each
weighted by this gate's own score for it (the published weights are not
renormalised, so a pick's weight needs no other pick); ``own`` collects
the picks this gate makes, in the same form. Routed as the program
routed, the comparison sees the program's arithmetic apart from its
routing, which a rounding can flip at a near tie; ``own`` against the
given picks measures the routing itself.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.dense import rms_norm


def _sizes(c: dict):
    return (c["d_model"], c["num_heads"], c["kv_lora_rank"],
            c["q_lora_rank"], c["qk_rope_head_dim"], c["qk_nope_head_dim"],
            c["v_head_dim"])


def held(c: dict) -> range:
    """The routed experts one chip holds."""
    n = c.get("moe_held_experts", 0) or c["num_experts"]
    first = c.get("moe_held_first", 0)
    return range(first, first + n)


def layout(c: dict):
    """[(path, shape, init)] of the parameter tree the benchmark makes; the
    paths are the port's keys, layers stacked on a leading axis, the
    dense layers apart as ``dense_blocks``."""
    d, H, r, qr, dr, dn, dv = _sizes(c)
    V, L = c["vocab_size"], c["num_layers"]
    nd = c["first_dense_layers"]
    E, Eh, dff = c["num_experts"], len(held(c)), c["moe_d_ff"]
    sf = c["num_shared_experts"] * dff
    w = ("normal", 0.0, 0.02)
    scale = ("normal", 1.0, 0.02)
    out = [(("embed", "table"), (V, d), w),
           (("final_norm", "scale"), (d,), scale),
           (("lm_head", "w"), (d, V), w)]
    for stack, n in (("dense_blocks", nd), ("blocks", L - nd)):
        if not n:
            continue
        out += [((stack, "ln1", "scale"), (n, d), scale),
                ((stack, "ln2", "scale"), (n, d), scale)]
        attn = [("w_dq", (d, qr)), ("w_uq", (qr, H * (dn + dr))),
                ("w_dkv", (d, r)), ("w_krope", (d, dr)),
                ("w_uk", (r, H * dn)), ("w_uv", (r, H * dv)),
                ("wo", (H * dv, d))]
        out += [((stack, "attn", k, "w"), (n, *s), w) for k, s in attn]
        if c.get("mla_latent_norm", False):
            out += [((stack, "attn", "q_norm", "scale"), (n, qr), scale),
                    ((stack, "attn", "kv_norm", "scale"), (n, r), scale)]
        if stack == "dense_blocks":
            F_ = c["d_ff"]
            out += [((stack, "ffn", "up", "w"), (n, d, F_), w),
                    ((stack, "ffn", "gate", "w"), (n, d, F_), w),
                    ((stack, "ffn", "down", "w"), (n, F_, d), w)]
            continue
        out += [((stack, "ffn", "router", "w"), (n, d, E), w),
                ((stack, "ffn", "experts", "up"), (n, Eh, d, dff), w),
                ((stack, "ffn", "experts", "gate"), (n, Eh, d, dff), w),
                ((stack, "ffn", "experts", "down"), (n, Eh, dff, d), w)]
        if sf:
            out += [((stack, "ffn", "shared", "up", "w"), (n, d, sf), w),
                    ((stack, "ffn", "shared", "gate", "w"), (n, d, sf), w),
                    ((stack, "ffn", "shared", "down", "w"), (n, sf, d), w)]
    return out


def yarn_inv_freq(c: dict, dim: int) -> torch.Tensor:
    """The rope dims' frequencies (dim / 2,), float32: plain at a factor
    of 1, else YaRN's as DeepSeek-V2 publishes them."""
    theta = float(c.get("rope_theta", 10000.0))
    freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    factor = float(c.get("yarn_factor", 1.0))
    if factor <= 1:
        return freq
    orig = c.get("yarn_original_positions", 4096)

    def dim_of(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(dim_of(c.get("yarn_beta_fast", 32.0))), 0)
    high = min(math.ceil(dim_of(c.get("yarn_beta_slow", 1.0))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return freq / factor * ramp + freq * (1 - ramp)


def attention_factor(c: dict) -> float:
    """m^2 of the softmax scale (1 without YaRN's mscale_all_dim)."""
    factor = float(c.get("yarn_factor", 1.0))
    m_all = float(c.get("yarn_mscale_all_dim", 0.0))
    if factor <= 1 or not m_all:
        return 1.0
    m = 0.1 * m_all * math.log(factor) + 1.0
    return m * m


def rotary(x, inv_freq):
    """x (B, S, heads, dr) at positions 0..S-1, split-half rotation."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv_freq.to(x.device)[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mla(a, h, c: dict, prec, i: int):
    """Layer ``i``'s latent attention over h (B, S, d), causal."""
    d, H, r, qr, dr, dn, dv = _sizes(c)
    B, S, _ = h.shape
    inv = yarn_inv_freq(c, dr)
    cq = prec.mm(h, a["w_dq"]["w"][i])
    if "q_norm" in a:
        cq = rms_norm(cq, a["q_norm"]["scale"][i])
    q = prec.mm(cq, a["w_uq"]["w"][i]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], rotary(q[..., dn:], inv)
    lat = prec.mm(h, a["w_dkv"]["w"][i])
    if "kv_norm" in a:
        lat = rms_norm(lat, a["kv_norm"]["scale"][i])
    k_rope = rotary(prec.mm(h, a["w_krope"]["w"][i])[:, :, None, :], inv)
    k_nope = prec.mm(lat, a["w_uk"]["w"][i]).reshape(B, S, H, dn)
    v = prec.mm(lat, a["w_uv"]["w"][i]).reshape(B, S, H, dv)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                        k_rope[:, :, 0].float()))
    s = s * ((dn + dr) ** -0.5 * attention_factor(c))
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(h.dtype)
    return prec.mm(o.reshape(B, S, H * dv), a["wo"]["w"][i])


def swiglu(x, up, gate, down, prec):
    return prec.mm(prec.mm(x, up) * F.silu(prec.mm(x, gate)), down)


def route(logits, c: dict):
    """(weights (N, k) float32, expert ids (N, k)) of the gate's float32
    logits (N, E)."""
    N, E = logits.shape
    scores = torch.softmax(logits, dim=-1)
    G, keep = c.get("moe_ep_degree", 1), c.get("moe_device_limit", 0)
    if keep and E % G == 0 and keep < G:
        best = scores.view(N, G, E // G).amax(-1)
        groups = torch.sort(best, dim=-1, descending=True,
                            stable=True).indices[:, :keep]
        mask = torch.zeros(N, G, dtype=torch.bool, device=logits.device)
        mask.scatter_(1, groups, True)
        scores = scores.masked_fill(~mask.repeat_interleave(E // G, 1), 0.0)
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :c["top_k"]], ids[:, :c["top_k"]]
    if c.get("moe_norm_topk", True):
        vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    return vals * float(c.get("moe_routed_scale", 1.0)), ids


def held_picks(ids, c: dict):
    """Expert ids (N, k) as indices among the held experts, the count held
    for an expert held elsewhere."""
    h = held(c)
    local = ids - h.start
    return torch.where((local >= 0) & (local < len(h)), local, len(h))


def experts(f, h, c: dict, prec, i: int, picks=None, own=None):
    """Layer ``i``'s shared experts plus the held experts' part of the
    routed ones over h (B, S, d); with ``picks`` (n, k) the first n
    tokens go to those held experts (one sequence); ``own`` gets this
    gate's picks."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    logits = torch.matmul(x.float(), f["router"]["w"][i].float())
    weights, ids = route(logits, c)
    key = held_picks(ids, c)
    if own is not None:
        own.append(key)
    if picks is not None:
        if c.get("moe_norm_topk", True):
            raise ValueError("routing as given needs unnormalised weights")
        key = torch.cat([picks.to(key), key[picks.shape[0]:]])
        score = torch.softmax(logits, dim=-1).gather(
            1, (key + held(c).start).clamp(max=c["num_experts"] - 1))
        weights = score * float(c.get("moe_routed_scale", 1.0))
    y = torch.zeros(B * S, d, dtype=torch.float32, device=h.device)
    ex = f["experts"]
    for j in range(len(held(c))):
        picked = key == j                                      # (N, k)
        rows = picked.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        out = swiglu(x[rows], ex["up"][i, j], ex["gate"][i, j],
                     ex["down"][i, j], prec)
        w = (weights * picked)[rows].sum(-1, keepdim=True)
        y[rows] += out.float() * w
    y = y.to(h.dtype)
    if "shared" in f:
        sh = f["shared"]
        y = y + swiglu(x, sh["up"]["w"][i], sh["gate"]["w"][i],
                       sh["down"]["w"][i], prec)
    return y.reshape(B, S, d)


def forward(params, tokens, c: dict, prec, picks=None, own=None):
    """Logits (B, S, V) in float32 for tokens (B, S); ``picks`` (n, MoE
    layers, k) routes a sequence's first n positions as given, ``own``
    collects this gate's picks (a list of (B * S, k) a MoE layer)."""
    nd = c["first_dense_layers"]
    x = params["embed"]["table"][tokens].to(prec.act)
    for layer in range(c["num_layers"]):
        stack, i = ("dense_blocks", layer) if layer < nd \
            else ("blocks", layer - nd)
        blk = params[stack]
        x = x + mla(blk["attn"], rms_norm(x, blk["ln1"]["scale"][i]), c,
                    prec, i)
        h = rms_norm(x, blk["ln2"]["scale"][i])
        if stack == "dense_blocks":
            f = blk["ffn"]
            x = x + swiglu(h, f["up"]["w"][i], f["gate"]["w"][i],
                           f["down"]["w"][i], prec)
        else:
            x = x + experts(blk["ffn"], h, c, prec, i,
                            None if picks is None else picks[:, i], own)
    x = rms_norm(x, params["final_norm"]["scale"])
    return prec.mm(x, params["lm_head"]["w"]).float()
