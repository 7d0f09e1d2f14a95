"""Expert-parallel MoE with an explicit all-to-all dispatch.

``models/moe.py``'s ``moe_ffn`` keeps every expert on one device; this is
the expert-parallel path, the classic two hops made explicit:

  1. route: top-k experts per local token; destination rank =
     expert // experts_per_rank;
  2. dispatch: pack per-destination capacity buffers and ship them, with
     the local expert ids, by ``all_to_all_single`` over the ``ep`` axis;
  3. the grouped FFN over the rank's experts, through a second capacity
     dispatch (zero rows are harmless: the FFN has no biases);
  4. a second all-to-all returns the rows to their source slots, where the
     gates weight and add them.

Capacity-based with drops (Switch-style) on both hops, with the
reference's capacities (``repro/distributed/expert_parallel.py:88,103``).

The reference is one SPMD program under ``shard_map``; here each rank is a
process. The contract is the reference's, held the same way on every
rank: global ``x`` in, the same ``y`` shaped like ``x`` out.

* Each rank routes the ``dp`` slice of ``x`` at its place on the
  ``dp_axis``. Every rank of one ``ep`` group holds the same slice, so
  each receives ``ep`` identical copies of its experts' rows. Their
  second dispatch sorts stably by expert, so the copies queue in source
  order, each copy's real rows before its zero padding rows (whose
  expert id is 0): the rank at place 0 of the ``ep`` axis has the fewest
  second-hop drops. The reference returns that rank's rows (its
  ``out_specs`` leave the ``ep`` axis replicated), so each ``ep`` group
  takes that rank's result by a broadcast, and the ``dp`` slices are
  then gathered.
* Each kept pick ships the local expert id it chose. The reference
  writes the ids with a scatter in which a dropped pick also writes 0 at
  slot 0 of its destination; on the CPU the last write wins, so there a
  destination that drops a pick runs its slot-0 pick through local
  expert 0. The port does not copy that (ROADMAP §3 records the fault):
  dropped picks write nothing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import mlp
from repro_torch.models.moe import _expert_ffn, _top_k


def _sort_dispatch(values, dest, n_dest, capacity):
    """Scatter ``values`` (M, d) into (n_dest, capacity, d) buffers by
    ``dest`` (M,), each destination's rows in their order in ``values``
    (a stable sort). Returns (buffers, slot_dev, slot_pos, keep) of each
    item in its original order; a dropped item has ``slot_pos`` 0."""
    M, d = values.shape
    sorted_dest, order = torch.sort(dest, stable=True)
    starts = torch.searchsorted(
        sorted_dest, torch.arange(n_dest, device=dest.device))
    pos = torch.arange(M, device=dest.device) - starts[sorted_dest]
    keep = pos < capacity
    pos_c = torch.where(keep, pos, 0)
    # a kept item owns its row of the flat buffer; the dropped ones all
    # write one spare row past it, which nothing reads
    row = torch.where(keep, sorted_dest * capacity + pos_c,
                      n_dest * capacity)
    buf = values.new_zeros((n_dest * capacity + 1, d))
    buf[row] = values[order]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(M, device=dest.device)
    return (buf[:-1].view(n_dest, capacity, d), sorted_dest[inv],
            pos_c[inv], keep[inv])


def _all_to_all(x, group):
    """Chunk ``j`` of dim 0 to rank ``j`` of ``group``; chunk ``i`` of the
    result came from rank ``i``."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _ep_local(router_w, experts, x, cfg, *, ep, group, capacity_factor):
    """The per-rank body: route, dispatch, the local experts, return,
    combine. ``x`` (B, S, d) is this rank's data slice, ``experts`` its
    ``E / ep`` experts. Returns y like x."""
    B, S, d = x.shape
    N, k = B * S, cfg.top_k
    E_loc = cfg.num_experts // ep
    cd = x.dtype
    xf = x.reshape(N, d)

    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)
    gates, eids = _top_k(probs, k)                   # (N, k) global ids
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    dest_dev = (eids // E_loc).reshape(-1)           # (N*k,)
    local_eid = (eids % E_loc).reshape(-1)
    token_of = torch.arange(N, device=x.device).repeat_interleave(k)

    C = int(max(1, -(-N * k // ep) * capacity_factor))
    send_x, slot_dev, slot_pos, keep = _sort_dispatch(
        xf[token_of], dest_dev, ep, C)
    eid_buf = torch.zeros((ep, C), dtype=torch.int32, device=x.device)
    eid_buf[slot_dev[keep], slot_pos[keep]] = local_eid[keep].to(torch.int32)

    rx = _all_to_all(send_x, group).reshape(ep * C, d)   # rows for my
    re = _all_to_all(eid_buf, group).reshape(ep * C)     # experts

    C2 = int(max(1, -(-ep * C // E_loc)))
    ebuf, s2_dev, s2_pos, k2 = _sort_dispatch(rx, re.long(), E_loc, C2)
    out_buf = _expert_ffn(experts, ebuf.to(cd), cfg.activation, cd)
    ry = torch.where(k2[:, None], out_buf[s2_dev, s2_pos], 0.0).to(cd)
    back = _all_to_all(ry.reshape(ep, C, d), group)

    vals = torch.where(keep[:, None], back[slot_dev, slot_pos], 0.0)
    parts = (vals * gates.reshape(-1)[:, None].to(cd)).view(N, k, d)
    y = parts[:, 0]
    for j in range(1, k):           # each token's k rows, front to back
        y = y + parts[:, j]
    return y.reshape(B, S, d)


def ep_moe_ffn(p, x, cfg, *, mesh, ep_axis: str = "model",
               dp_axis: str = "data", capacity_factor: float = 2.0):
    """x: (B, S, d), the global batch on every rank; ``p``: ``init_moe``'s
    tree, global (each rank uses its ``E / ep`` experts, the router
    replicated). ``mesh``: a ``DeviceMesh`` with ``ep_axis`` and
    ``dp_axis`` dims. Returns y like x, the same on every rank. Shared
    experts run on the whole batch on every rank.

    Raises unless ``cfg.num_experts`` splits over the ``ep`` ranks and B
    over the ``dp`` ranks."""
    ep_mesh, dp_mesh = mesh[ep_axis], mesh[dp_axis]
    ep, dp = ep_mesh.size(), dp_mesh.size()
    E, B = cfg.num_experts, x.shape[0]
    if E % ep or B % dp:
        raise ValueError(f"ep_moe_ffn: {E} experts over {ep} {ep_axis!r} "
                         f"ranks and a batch of {B} over {dp} {dp_axis!r} "
                         "ranks must split evenly")
    E_loc, B_loc = E // ep, B // dp
    er, dr = ep_mesh.get_local_rank(), dp_mesh.get_local_rank()
    experts = {name: w[er * E_loc:(er + 1) * E_loc]
               for name, w in p["experts"].items()}
    ep_group = ep_mesh.get_group()
    y = _ep_local(p["router"]["w"], experts, x[dr * B_loc:(dr + 1) * B_loc],
                  cfg, ep=ep, group=ep_group,
                  capacity_factor=capacity_factor).contiguous()
    # the ep group's rank at place 0 holds the reference's result
    dist.broadcast(y, src=dist.get_global_rank(ep_group, 0), group=ep_group)
    parts = [torch.empty_like(y) for _ in range(dp)]
    dist.all_gather(parts, y, group=dp_mesh.get_group())
    y = torch.cat(parts)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg.activation, x.dtype)
    return y
