"""Mamba-1 selective-scan SSM block (Falcon-Mamba).

The full-sequence path has the reference's three routes: the hand-written
``kernels/mamba_scan`` (``use_kernels``; forward only), the chunked scan
(``cfg.ssm_chunk > 0``; each chunk recomputed in the backward through
``torch.utils.checkpoint``, so peak memory is one chunk's) and the plain
scan over the whole sequence. The two training routes scan in log depth
(``models/scan.py``), as the reference's ``jax.lax.associative_scan``
does, over (B, S, d_inner, N) fp32 pairs.
Decode keeps an O(1)-size recurrent state ``(h, conv window)`` in fp32,
updated in place.

Casts follow the reference: the projections are ``dense`` in the compute
dtype, but ``dt_proj`` is an fp32 product of fp32 weights; the conv runs
in the compute dtype; the scan, ``A = -exp(a_log)`` and the D-skip are
fp32, cast back before the ``silu(z)`` gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import dense, init_dense, normal_init
from repro_torch.models.scan import associative_scan


def init_mamba(gen, cfg, dtype=torch.float32, layers=()):
    """The reference's tree and init scales; ``layers`` prepends stacked
    layer axes."""
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, kc = cfg.ssm_dt_rank, cfg.ssm_conv
    dev = gen.device
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    a = a.expand(*layers, di, ds)
    full = lambda shape, v: torch.full((*layers, *shape), v, dtype=dtype,
                                       device=dev)
    return {
        "in_proj": init_dense(gen, d, 2 * di, dtype=dtype, layers=layers),
        "conv_w": normal_init(gen, (*layers, kc, di), 0.1, dtype),
        "conv_b": full((di,), 0.0),
        "x_proj": init_dense(gen, di, dtr + 2 * ds, dtype=dtype,
                             layers=layers),
        "dt_proj": {"w": normal_init(gen, (*layers, dtr, di), 0.1, dtype),
                    "b": full((di,), -4.6)},       # softplus^-1(0.01)
        "a_log": torch.log(a).to(dtype).contiguous(),
        "d_skip": full((di,), 1.0),
        "out_proj": init_dense(gen, di, d, dtype=dtype, layers=layers),
    }


def _ssm_params(p, x_inner, cfg, cd):
    """Per-timestep dt, B, C from x_inner (..., di); B and C are views of
    the x_proj output where it is already fp32."""
    ds, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    dbc = dense(p["x_proj"], x_inner, cd)
    dt_r, b, c = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt_r.float(), p["dt_proj"]["w"].float())
                    + p["dt_proj"]["b"].float())             # (..., di)
    return dt, b.float(), c.float()


def _causal_conv(p, x, cfg):
    """Depthwise causal conv over seq, in x's dtype. x: (B,S,di)."""
    kc, S = cfg.ssm_conv, x.shape[1]
    xpad = F.pad(x, (0, 0, kc - 1, 0))
    w = p["conv_w"].to(x.dtype)                               # (kc, di)
    out = sum(xpad[:, i:i + S, :] * w[i] for i in range(kc))
    return out + p["conv_b"].to(x.dtype)


def _scan_pairs(x, dt, a, b):
    """(exp(dt A), dt x B): the recurrence's (B,S,di,ds) factors."""
    return (torch.exp(dt[..., None] * a),
            (dt * x)[..., None] * b[:, :, None, :])


def _scan_chunk(x, dt, a, b, c, h0):
    """y (B,C,di) over one chunk from state ``h0`` (B,di,ds), and the
    chunk's last state."""
    prod, h = associative_scan(*_scan_pairs(x, dt, a, b))
    h = h + prod * h0[:, None]
    return torch.einsum("bcdn,bcn->bcd", h, c), h[:, -1]


def mamba_full(p, x, cfg, use_kernels=False, chunk: int = 0):
    """x: (B,S,d) -> (B,S,d). ``use_kernels`` takes the CUDA scan (its
    plain version on the CPU); else ``chunk`` > 0 dividing S takes the
    chunked scan, whose backward recomputes one chunk at a time; else the
    plain scan over S."""
    B, S, _ = x.shape
    cd = x.dtype
    xz = dense(p["in_proj"], x, cd)
    x_in, z = xz.chunk(2, dim=-1)
    x_in = F.silu(_causal_conv(p, x_in, cfg))

    dt, b, c = _ssm_params(p, x_in, cfg, cd)     # (B,S,di), (B,S,ds) x 2
    a = -torch.exp(p["a_log"].float())                       # (di,ds)
    xf = x_in.float()

    if use_kernels:
        y = mamba_scan(xf, dt, a, b, c)
    elif chunk and S % chunk == 0 and S > chunk:
        h = torch.zeros((B, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                        device=x.device)
        ys = []
        for s0 in range(0, S, chunk):
            sl = slice(s0, s0 + chunk)
            yc, h = checkpoint(_scan_chunk, xf[:, sl], dt[:, sl], a,
                               b[:, sl], c[:, sl], h, use_reentrant=False)
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    else:
        _, h = associative_scan(*_scan_pairs(xf, dt, a, b))
        y = torch.einsum("bsdn,bsn->bsd", h, c)
    y = y + xf * p["d_skip"].float()
    y = y.to(cd) * F.silu(z)
    return dense(p["out_proj"], y, cd)


def init_mamba_cache(cfg, batch, layers=None, device=None):
    """(h, conv window) per layer, in fp32, as the reference's
    (``transformer.init_cache`` passes it no dtype)."""
    L = cfg.num_layers if layers is None else layers
    di, ds, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((L, batch, di, ds), device=device),
            "conv": torch.zeros((L, batch, kc - 1, di), device=device)}


def mamba_decode(p, x, layer_cache, cfg):
    """One-step recurrence. x: (B,1,d). Writes the new state into
    ``layer_cache`` in place (the reference returned new arrays); returns
    (out (B,1,d), layer_cache)."""
    cd = x.dtype
    xz = dense(p["in_proj"], x, cd)
    x_in, z = xz.chunk(2, dim=-1)                            # (B,1,di)

    conv_buf = layer_cache["conv"]                           # (B,kc-1,di)
    window = torch.cat([conv_buf, x_in.to(conv_buf.dtype)], dim=1)
    w = p["conv_w"].to(cd)
    x_c = torch.einsum("bkd,kd->bd", window.to(cd), w) + p["conv_b"].to(cd)
    x_c = F.silu(x_c)[:, None, :]                            # (B,1,di)

    dt, b, c = _ssm_params(p, x_c, cfg, cd)
    a = -torch.exp(p["a_log"].float())
    da = torch.exp(dt[:, 0, :, None] * a)                    # (B,di,ds)
    dbx = (dt[:, 0] * x_c[:, 0].float())[..., None] * b[:, 0, None, :]
    h = da * layer_cache["h"] + dbx                          # (B,di,ds)
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])
    y = y + x_c[:, 0].float() * p["d_skip"].float()
    y = y[:, None, :].to(cd) * F.silu(z)
    out = dense(p["out_proj"], y, cd)
    layer_cache["h"].copy_(h)
    layer_cache["conv"].copy_(window[:, 1:, :])
    return out, layer_cache
