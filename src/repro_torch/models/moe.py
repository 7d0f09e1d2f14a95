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

DeepSeek-V2's published gate and one chip's share of the layer, each
off unless its config field turns it on: the gate's product in fp32
(``moe_router_fp32``), the top-k weights left unnormalised
(``moe_norm_topk``) and scaled (``moe_routed_scale``); a layer that holds
only the experts ``cfg.held_experts`` (its ``experts`` leaves have that
many rows), routes over all of them and computes its own experts' part
of the result: a pick of an expert held elsewhere adds nothing here. With
``moe_dropless`` (serving) no pick drops: the held picks, sorted by
expert, run through one grouped product a projection
(``grouped_expert_ffn``), and the weighted rows are added in fp32, as the
published inference adds them. While an engine has a ``PickTally``
installed (``counting``), each layer adds its held picks and the rows its
products compute to the tally on the device; the engine reads it at its
own host sync.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

import torch

from repro_torch.models.layers import (_Gather, act_fn, dense, init_dense,
                                       init_mlp, mlp, normal_init)


def init_moe(gen, cfg, dtype=torch.float32, layers=()):
    """Experts ``up`` (E, d, dff) and ``down`` (E, dff, d), plus ``gate``
    (E, d, dff) under silu, E the experts held; a ``router`` dense (d,
    num_experts); an optional
    ``shared`` MLP of ``num_shared_experts * moe_d_ff``."""
    d, E, dff = cfg.d_model, len(cfg.held_experts), cfg.moe_d_ff
    experts = {"up": normal_init(gen, (*layers, E, d, dff), dtype=dtype),
               "down": normal_init(gen, (*layers, E, dff, d), dtype=dtype)}
    if cfg.activation == "silu":
        experts["gate"] = normal_init(gen, (*layers, E, d, dff), dtype=dtype)
    p = {"router": init_dense(gen, d, cfg.num_experts, dtype=dtype,
                              layers=layers),
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


def _router_probs(p, xf, cfg=None):
    """Softmax of the router's logits in fp32, (N, E): the product in
    ``xf``'s dtype, or in fp32 under ``cfg.moe_router_fp32``."""
    if cfg is not None and cfg.moe_router_fp32:
        return torch.softmax(dense(p["router"], xf, torch.float32), dim=-1)
    return torch.softmax(dense(p["router"], xf, xf.dtype).float(), dim=-1)


def route(probs, cfg):
    """(weights (N, k) fp32, expert ids (N, k), probs after the group
    limit) of router probabilities (N, E): device- or group-limited
    where configured, the top k (ties to the lower index), renormalised
    or not, times ``moe_routed_scale``."""
    N, E = probs.shape
    if cfg.moe_device_limit and cfg.num_experts % cfg.moe_ep_degree == 0 \
            and cfg.moe_device_limit < cfg.moe_ep_degree:
        # device-limited routing (DeepSeek-V2 §2.1.2): each token picks
        # experts from at most moe_device_limit of the moe_ep_degree groups
        G = cfg.moe_ep_degree
        epg = E // G
        _, top_groups = _top_k(probs.view(N, G, epg).amax(-1),
                               cfg.moe_device_limit)
        group_mask = torch.zeros((N, G), dtype=torch.bool,
                                 device=probs.device)
        group_mask.scatter_(1, top_groups, True)
        probs = torch.where(group_mask.repeat_interleave(epg, dim=1), probs,
                            0.0)
    gate_vals, expert_ids = _top_k(probs, cfg.top_k)            # (N, k)
    if cfg.moe_norm_topk:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    if cfg.moe_routed_scale != 1.0:
        gate_vals = gate_vals * cfg.moe_routed_scale
    return gate_vals, expert_ids, probs


class PickTally:
    """Device-side running counts of the expert layers run while it is
    installed (``counting``): ``counts`` = [picks of live tokens routed to
    held experts, rows the expert products computed], int64, over every
    layer and call. ``live``, where its owner sets it, is a bool tensor of
    the forward's tokens (B, S): padding and idle rows are False, and
    their picks are computed but not counted as picks. Its owner reads the
    counts at a host sync it makes anyway. Where its owner sets ``log`` to
    a list, each layer also appends its picks there, uint8 (B * S, top_k):
    the held expert's index among those held, or the count held for an
    expert held elsewhere."""

    def __init__(self, device=None):
        self.counts = torch.zeros(2, dtype=torch.int64, device=device)
        self.live = None
        self.log = None

    def add(self, key, held_sorted, token_of, rows) -> None:
        """One layer: each pick's held index (N, k), the held picks among
        the sorted picks, each sorted pick's token, the rows computed (a
        count or a device scalar)."""
        if self.live is not None:
            held_sorted = held_sorted & self.live.reshape(-1)[token_of]
        self.counts[0] += held_sorted.sum()
        self.counts[1] += rows
        if self.log is not None:
            self.log.append(key.to(torch.uint8))


_local = threading.local()


@contextmanager
def counting(tally: PickTally):
    """Install ``tally`` for the expert layers this thread runs in the
    block."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = prev


def grouped_expert_ffn(experts, xs, counts, activation, cd):
    """The experts' FFN over rows sorted by expert: xs (P, d), its first
    ``counts[0]`` rows expert 0's, the next ``counts[1]`` expert 1's, ...
    -> (P, d); rows past ``counts.sum()`` are left unspecified. On CUDA
    in bf16 each projection is one ``torch._grouped_mm`` over the counts
    as they are on the device (no host sync); elsewhere a loop over the
    experts, the plain version."""
    f = act_fn(activation)
    w = {k: t.to(cd) for k, t in experts.items()}
    if xs.is_cuda and cd == torch.bfloat16:
        offs = torch.cumsum(counts, 0).to(torch.int32)

        def mm(a, name):
            return torch._grouped_mm(a, w[name], offs=offs)
    else:
        ends = torch.cumsum(counts, 0).tolist()

        def mm(a, name):
            out = a.new_zeros((a.shape[0], w[name].shape[-1]))
            for e, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
                if hi > lo:
                    out[lo:hi] = a[lo:hi] @ w[name][e]
            return out
    h = mm(xs, "up")
    h = h * f(mm(xs, "gate")) if "gate" in w else f(h)
    return mm(h, "down")


def _held_keys(expert_ids, cfg):
    """(each pick's held expert index, or E_held for an expert held
    elsewhere; E_held)."""
    held = cfg.held_experts
    if len(held) == cfg.num_experts:
        return expert_ids, len(held)
    local = expert_ids - held.start
    return torch.where((local >= 0) & (local < len(held)), local,
                       len(held)), len(held)


def _combine(rows, order, N, k, d):
    """The sorted picks' weighted rows back in token order, each token's
    ``k`` added front to back."""
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(N * k, device=order.device)
    parts = rows[unsort].view(N, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y


def moe_ffn(p, x, cfg, *, capacity_factor=1.25, shard_experts=None):
    """x: (B, S, d) -> (y, aux_loss). shard_experts: optional callable
    applied to the (E, C, d) dispatch and output buffers (the capacity
    route)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cd = x.dtype
    N = B * S
    xf = x.reshape(N, d)

    probs = _router_probs(p, xf, cfg)                       # (N, E)
    gate_vals, expert_ids, probs = route(probs, cfg)

    # Switch-style load-balance aux loss
    me = probs.mean(0)                                          # (E,)
    ce = _picks(expert_ids, E).float() / (N * k)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    key, Eh = _held_keys(expert_ids, cfg)
    tally = getattr(_local, "tally", None)
    sorted_ids, order = torch.sort(key.reshape(-1), stable=True)
    token_of = order // k
    if cfg.moe_dropless:
        # every held pick runs; the weighted rows are added in fp32
        counts = _picks(key, Eh + 1)[:Eh]
        ys = grouped_expert_ffn(p["experts"], _Gather.apply(xf, token_of),
                                counts, cfg.activation, cd)
        w = gate_vals.reshape(-1)[order][:, None]
        rows = torch.where((sorted_ids < Eh)[:, None], ys.float() * w, 0.0)
        y = _combine(rows, order, N, k, d).to(cd)
        if tally is not None:
            tally.add(key, sorted_ids < Eh, token_of, counts.sum())
    else:
        # ---- sort-based dispatch ---------------------------------------
        C = capacity(N, cfg, capacity_factor)
        starts = torch.searchsorted(sorted_ids,
                                    torch.arange(Eh + 1, device=x.device))
        pos_in_expert = torch.arange(N * k, device=x.device) \
            - starts[sorted_ids]
        # a kept pick's row of the flattened (E*C, d) buffer; E*C is the
        # spare
        row = torch.where((pos_in_expert < C) & (sorted_ids < Eh),
                          sorted_ids * C + pos_in_expert, Eh * C)
        buf = xf.new_zeros((Eh * C + 1, d)).index_put(
            (row,), _Gather.apply(xf, token_of))
        buf = buf[:Eh * C].view(Eh, C, d)
        if shard_experts is not None:
            buf = shard_experts(buf)
        out_buf = _expert_ffn(p["experts"], buf, cfg.activation, cd)
        if shard_experts is not None:
            out_buf = shard_experts(out_buf)

        # ---- combine -------------------------------------------------------
        gathered = torch.cat([out_buf.reshape(Eh * C, d),
                              out_buf.new_zeros((1, d))])[row]
        w = gate_vals.reshape(-1)[order][:, None].to(cd)
        y = _combine(gathered * w, order, N, k, d)
        if tally is not None:
            tally.add(key, sorted_ids < Eh, token_of, Eh * C)

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
    _, expert_ids = _top_k(_router_probs(p, x.reshape(N, d), cfg), k)
    counts = _picks(expert_ids, E).float()
    C = capacity(N, cfg, capacity_factor)
    dropped = torch.clamp(counts - C, min=0.0).sum() / (N * k)
    return MoEStats(counts, dropped)
