"""Mixture-of-Experts FFN with top-k routing and per-expert capacity.

Dispatch is sort-based, as in the reference: the ``N·k`` (token, expert)
picks are sorted by expert, the first ``C`` picks of each expert fill its
row of an ``(E, C, d)`` buffer, and the rest are dropped (their token gets
nothing from that expert). A Switch-style load-balance loss is returned
beside the output.

Nothing here adds into one place from two sources, so the outputs and the
gradients are the same bits on every call:

* the top k come from a stable descending sort, so ties go to the lower
  expert index, as ``jax.lax.top_k`` promises (``torch.topk`` does not);
* a kept pick has a buffer row of its own, so the dispatch writes rows
  (``index_put`` without accumulate); every dropped pick writes one spare
  row past the buffer, which nothing reads;
* ``xf[token_of]`` is ``layers._Gather``, whose backward sums each token's
  ``k`` rows in a fixed order;
* the combine puts the ``N·k`` weighted rows back in token order and adds
  each token's ``k`` of them front to back; the reference's scatter-add
  adds the same terms.

``shard_experts``, where given, is applied to the (E, C, d) dispatch
buffer and to the experts' output buffer, as in the reference (a hook to
place them, e.g. sharded over an expert axis);
``distributed/expert_parallel.py`` is the explicit all-to-all path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import (_Gather, act_fn, dense, init_dense,
                                       init_mlp, mlp, normal_init)


def init_moe(gen, cfg, dtype=torch.float32, layers=()):
    """Experts ``up`` (E, d, dff) and ``down`` (E, dff, d), plus ``gate``
    (E, d, dff) under silu; a ``router`` dense (d, E); an optional
    ``shared`` MLP of ``num_shared_experts * moe_d_ff``."""
    d, E, dff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    experts = {"up": normal_init(gen, (*layers, E, d, dff), dtype=dtype),
               "down": normal_init(gen, (*layers, E, dff, d), dtype=dtype)}
    if cfg.activation == "silu":
        experts["gate"] = normal_init(gen, (*layers, E, d, dff), dtype=dtype)
    p = {"router": init_dense(gen, d, E, dtype=dtype, layers=layers),
         "experts": experts}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * cfg.moe_d_ff,
                               cfg.activation, dtype, layers=layers)
    return p


def _expert_ffn(experts, buf, activation, cd):
    """buf: (E, C, d) -> (E, C, d)."""
    f = act_fn(activation)
    h = torch.bmm(buf, experts["up"].to(cd))
    if "gate" in experts:
        h = h * f(torch.bmm(buf, experts["gate"].to(cd)))
    else:
        h = f(h)
    return torch.bmm(h, experts["down"].to(cd))


def _top_k(x, k):
    """(values, indices) of the ``k`` largest along the last axis, ties to
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _picks(expert_ids, E):
    """Picks per expert, (E,) int64: integer adds, exact in any order.
    (``torch.bincount`` on CUDA reads the largest id back to the host.)
    Out of place: DTensor cannot add DTensor ids into a plain tensor in
    place."""
    ids = expert_ids.reshape(-1)
    return torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids))


def capacity(n_tokens, cfg, capacity_factor=1.25):
    """Picks an expert keeps: the reference's formula, Python's ``round``
    (halves to even) included."""
    return int(max(1, round(n_tokens * cfg.top_k / cfg.num_experts
                            * capacity_factor)))


def _router_probs(p, xf):
    """Softmax of the router's logits (computed in ``xf``'s dtype) in
    fp32, (N, E)."""
    return torch.softmax(dense(p["router"], xf, xf.dtype).float(), dim=-1)


def moe_ffn(p, x, cfg, *, capacity_factor=1.25, shard_experts=None):
    """x: (B, S, d) -> (y, aux_loss). shard_experts: optional callable
    applied to the (E, C, d) dispatch and output buffers."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cd = x.dtype
    N = B * S
    xf = x.reshape(N, d)

    probs = _router_probs(p, xf)                           # (N, E)
    if cfg.moe_device_limit and cfg.num_experts % cfg.moe_ep_degree == 0 \
            and cfg.moe_device_limit < cfg.moe_ep_degree:
        # device-limited routing (DeepSeek-V2 §2.1.2): each token picks
        # experts from at most moe_device_limit of the moe_ep_degree groups
        G = cfg.moe_ep_degree
        epg = E // G
        _, top_groups = _top_k(probs.view(N, G, epg).amax(-1),
                               cfg.moe_device_limit)
        group_mask = torch.zeros((N, G), dtype=torch.bool, device=x.device)
        group_mask.scatter_(1, top_groups, True)
        probs = torch.where(group_mask.repeat_interleave(epg, dim=1), probs,
                            0.0)

    gate_vals, expert_ids = _top_k(probs, k)                    # (N, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # Switch-style load-balance aux loss
    me = probs.mean(0)                                          # (E,)
    ce = _picks(expert_ids, E).float() / (N * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    # ---- sort-based dispatch ---------------------------------------------
    C = capacity(N, cfg, capacity_factor)
    sorted_ids, order = torch.sort(expert_ids.reshape(-1), stable=True)
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(E, device=x.device))
    pos_in_expert = torch.arange(N * k, device=x.device) - starts[sorted_ids]
    # a kept pick's row of the flattened (E*C, d) buffer; E*C is the spare
    row = torch.where(pos_in_expert < C, sorted_ids * C + pos_in_expert,
                      E * C)
    token_of = order // k
    buf = xf.new_zeros((E * C + 1, d)).index_put(
        (row,), _Gather.apply(xf, token_of))
    buf = buf[:E * C].view(E, C, d)
    if shard_experts is not None:
        buf = shard_experts(buf)
    out_buf = _expert_ffn(p["experts"], buf, cfg.activation, cd)
    if shard_experts is not None:
        out_buf = shard_experts(out_buf)

    # ---- combine -----------------------------------------------------------
    gathered = torch.cat([out_buf.reshape(E * C, d),
                          out_buf.new_zeros((1, d))])[row]
    w = gate_vals.reshape(-1)[order][:, None].to(cd)
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(N * k, device=x.device)
    parts = (gathered * w)[unsort].view(N, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]

    if "shared" in p:
        y = y + mlp(p["shared"], xf, cfg.activation, cd)
    return y.reshape(B, S, d), aux


@dataclasses.dataclass
class MoEStats:
    """Router statistics for load-balance monitoring (paper §3.3 load
    balancing feeds on per-DP-group token counts)."""
    tokens_per_expert: torch.Tensor
    dropped_fraction: torch.Tensor


def moe_router_stats(p, x, cfg, capacity_factor=1.25) -> MoEStats:
    """Picks per expert and the share of picks over capacity, for the
    router alone (no device limit), as the reference counts them."""
    B, S, d = x.shape
    N, E, k = B * S, cfg.num_experts, cfg.top_k
    _, expert_ids = _top_k(_router_probs(p, x.reshape(N, d)), k)
    counts = _picks(expert_ids, E).float()
    C = capacity(N, cfg, capacity_factor)
    dropped = torch.clamp(counts - C, min=0.0).sum() / (N * k)
    return MoEStats(counts, dropped)
