"""Common neural-net building blocks (plain functions on tensors; params
are nested dicts of tensors with the reference's keys and shapes).

Conventions, as in the reference:
  * ``init_<layer>(gen, ...) -> params`` and ``<layer>(params, x, ...) -> y``;
    every random draw takes an explicit ``torch.Generator`` on the target
    device.
  * Params are stored in ``param_dtype`` (fp32 by default); compute runs in
    ``compute_dtype`` (bf16) — matmuls cast both operands, norms and RoPE
    run in fp32 and cast back. Dense weights are ``(d_in, d_out)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.obs.registry import DefaultCounter

_CAST_BYTES = DefaultCounter(
    "model_cast_bytes_total",
    "bytes that dense's and unembed's dtype conversions read and write")


def _cast(t, dtype):
    """``t`` in ``dtype``; a conversion that changes the dtype counts the
    bytes it reads and writes (``model_cast_bytes_total``)."""
    if t.dtype == dtype:
        return t
    _CAST_BYTES.inc(t.numel() * (t.element_size() + dtype.itemsize))
    return t.to(dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# -- initializers -----------------------------------------------------------

def normal_init(gen, shape, scale=0.02, dtype=torch.float32):
    """N(0, scale²) drawn in fp32 on ``gen``'s device, cast to ``dtype``."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return x.normal_(0.0, scale, generator=gen).to(dtype)


def zeros_init(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


# -- dense ------------------------------------------------------------------

def init_dense(gen, d_in, d_out, *, bias=False, scale=0.02,
               dtype=torch.float32, layers=()):
    """``layers`` prepends stacked layer axes (the reference vmaps init)."""
    p = {"w": normal_init(gen, (*layers, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = zeros_init((*layers, d_out), dtype, gen.device)
    return p


def dense(p, x, compute_dtype=torch.bfloat16):
    y = torch.matmul(_cast(x, compute_dtype), _cast(p["w"], compute_dtype))
    if "b" in p:
        y = y + _cast(p["b"], compute_dtype)
    return y


# -- norms --------------------------------------------------------------------

def init_norm(kind, d, dtype=torch.float32, device=None, layers=()):
    p = {"scale": torch.ones((*layers, d), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros((*layers, d), dtype=dtype, device=device)
    return p


def norm(p, x, eps=1e-6):
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# -- activations --------------------------------------------------------------

def act_fn(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# -- MLP (SwiGLU for silu, plain 2-layer for gelu) ----------------------------

def init_mlp(gen, d_model, d_ff, activation, dtype=torch.float32, layers=()):
    p = {"up": init_dense(gen, d_model, d_ff, dtype=dtype, layers=layers),
         "down": init_dense(gen, d_ff, d_model, dtype=dtype, layers=layers)}
    if activation == "silu":
        p["gate"] = init_dense(gen, d_model, d_ff, dtype=dtype, layers=layers)
    return p


def mlp(p, x, activation, compute_dtype=torch.bfloat16):
    f = act_fn(activation)
    h = dense(p["up"], x, compute_dtype)
    if "gate" in p:
        h = h * f(dense(p["gate"], x, compute_dtype))
    else:
        h = f(h)
    return dense(p["down"], h, compute_dtype)


# -- rotary -------------------------------------------------------------------

def rotary_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rotary(x, positions, theta=10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-half
    rotation in fp32, frequencies computed in numpy fp32."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rotary_freqs(hd, theta)).to(x.device)
    angles = positions[..., :, None].float() * freqs      # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen, vocab, d, dtype=torch.float32):
    return {"table": normal_init(gen, (vocab, d), 0.02, dtype)}


class _Gather(torch.autograd.Function):
    """``table[tokens]`` whose backward adds each token id's rows in the
    order they occur: a stable sort brings equal ids together, a segment
    sum adds each run front to back into the run's first position (the
    other positions' segments are empty, so zero), and the sums are added
    into a zero table. Each id gets one nonzero addend, so the order of
    those adds does not reach the bits, and nothing waits on the host.
    The plain gather's backward (``index_put_`` with accumulate) adds an
    id's rows in an order that can differ between two calls on the CPU."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        ids, order = torch.sort(tokens.reshape(-1), stable=True)
        g = grad.reshape(ids.numel(), -1)[order]
        pos = torch.arange(ids.numel(), device=ids.device)
        first = torch.searchsorted(ids, ids)
        end = torch.searchsorted(ids, ids, right=True)
        lengths = torch.where(first == pos, end - pos, 0)
        sums = torch.segment_reduce(g, "sum", lengths=lengths, unsafe=True)
        out = grad.new_zeros(ctx.rows, g.shape[1])
        return out.index_put_((ids,), sums, accumulate=True), None


def embed(p, tokens, compute_dtype=torch.bfloat16):
    # gather, then cast: the same values as casting the whole table first
    return _Gather.apply(p["table"], tokens).to(compute_dtype)


def unembed(p, x, compute_dtype=torch.bfloat16):
    return torch.matmul(_cast(x, compute_dtype),
                        _cast(p["table"], compute_dtype).T)
