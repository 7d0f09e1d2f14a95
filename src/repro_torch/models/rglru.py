"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block wraps the RG-LRU with an input projection producing (x, gate z),
a short causal temporal conv on the x branch, and an output projection
gated by gelu(z) (the tanh approximation, as ``jax.nn.gelu``).

The full-sequence path has the reference's two routes: the hand-written
``kernels/rglru_scan`` (``use_kernels``; forward only) and a log-depth
associative scan in torch ops, differentiable, for training. Decode keeps
an O(1)-size recurrent state ``(h, conv window)`` in fp32, updated in
place. Casts follow the reference: the projections run in the compute
dtype, the gates and the scan in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import act_fn, dense, init_dense, normal_init
from repro_torch.models.scan import associative_scan

_C = 8.0  # Griffin's recurrence sharpness constant
_gelu = act_fn("gelu")


def init_rglru_block(gen, cfg, dtype=torch.float32, layers=()):
    """The reference's tree and init scales; ``layers`` prepends stacked
    layer axes."""
    d, w = cfg.d_model, cfg.rnn_width
    # Lambda init so that a in [0.9, 0.999] at r=1 (Griffin appendix)
    u = torch.empty((*layers, w), device=gen.device).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u/c)
    kw = dict(dtype=dtype, layers=layers)
    return {
        "in_x": init_dense(gen, d, w, **kw),
        "in_z": init_dense(gen, d, w, **kw),
        "conv_w": normal_init(gen, (*layers, 4, w), 0.1, dtype),
        "conv_b": torch.zeros((*layers, w), dtype=dtype, device=gen.device),
        "gate_a": init_dense(gen, w, w, **kw),
        "gate_x": init_dense(gen, w, w, **kw),
        "lambda": lam.to(dtype),
        "out": init_dense(gen, w, d, **kw),
    }


def _gates(p, xc, cd):
    """(a, sqrt(1 - a^2) * i * x), both fp32."""
    r = torch.sigmoid(dense(p["gate_a"], xc, cd).float())
    i = torch.sigmoid(dense(p["gate_x"], xc, cd).float())
    log_a = -_C * F.softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, beta * i * xc.float()


def _conv(p, x):
    """Causal temporal conv, kernel 4, in x's dtype. x: (B,S,w)."""
    k, S = p["conv_w"].shape[0], x.shape[1]
    xpad = F.pad(x, (0, 0, k - 1, 0))
    w = p["conv_w"].to(x.dtype)
    out = sum(xpad[:, i:i + S, :] * w[i] for i in range(k))
    return out + p["conv_b"].to(x.dtype)


def _conv_step(p, x, buf):
    """The conv over the fp32 window ``buf`` (B,k-1,w) and one new step x
    (B,1,w): the window is joined in fp32, the product runs in x's dtype.
    Returns (out (B,1,w), the joined window (B,k,w))."""
    window = torch.cat([buf, x.to(buf.dtype)], dim=1)
    out = torch.einsum("bkd,kd->bd", window.to(x.dtype),
                       p["conv_w"].to(x.dtype))[:, None, :]
    return out + p["conv_b"].to(x.dtype), window


def rglru_full(p, x, cfg, use_kernels=False):
    """x: (B,S,d) -> (B,S,d). ``use_kernels`` takes the CUDA scan (its
    plain version on the CPU); else the associative scan."""
    cd = x.dtype
    xb = dense(p["in_x"], x, cd)
    z = dense(p["in_z"], x, cd)
    xc = _conv(p, xb)
    a, bx = _gates(p, xc, cd)
    h = rglru_scan(a, bx) if use_kernels else associative_scan(a, bx)[1]
    y = h.to(cd) * _gelu(z)
    return dense(p["out"], y, cd)


def init_rglru_cache(cfg, batch, n_layers, device=None):
    """(h, conv window) per recurrent layer, in fp32, as the reference's."""
    w = cfg.rnn_width
    return {"h": torch.zeros((n_layers, batch, w), device=device),
            "conv": torch.zeros((n_layers, batch, 3, w), device=device)}


def rglru_decode(p, x, layer_cache, cfg):
    """One step. x: (B,1,d). Writes the new state into ``layer_cache`` in
    place (the reference returned new arrays); returns (out (B,1,d),
    layer_cache)."""
    cd = x.dtype
    xb = dense(p["in_x"], x, cd)
    z = dense(p["in_z"], x, cd)
    xc, window = _conv_step(p, xb, layer_cache["conv"])
    a, bx = _gates(p, xc, cd)                                # (B,1,w)
    h = a[:, 0] * layer_cache["h"] + bx[:, 0]
    y = h[:, None, :].to(cd) * _gelu(z)
    out = dense(p["out"], y, cd)
    layer_cache["h"].copy_(h)
    layer_cache["conv"].copy_(window[:, 1:, :])
    return out, layer_cache
