"""Distributed flash-decode: a partial-softmax combine over a device mesh.

The KV cache's *sequence* dim is sharded over the mesh's ``"model"`` axis.
Each rank computes partial attention (m, l, acc) over its keys with the
decode kernel's blockwise math, and the ranks combine with small
collectives, O(B·H·hd) on the wire and never O(S):

    m*   = max_ranks m_i                     (all_reduce MAX)
    l*   = Σ_i l_i · exp(m_i − m*)           (all_reduce SUM, with acc)
    out  = Σ_i acc_i · exp(m_i − m*) / l*

The reference runs the same math under ``shard_map`` in one SPMD program:
global arrays in, split by ``PartitionSpec``, a replicated result out.
Here every rank is its own process (``torch.distributed``), and
``sharded_decode_attention`` keeps the reference's contract on each of
them: it takes the global tensors, computes on its own slice of keys, and
returns the same (B, 1, H, hd) result on every rank.
``partial_decode_combine`` is the per-rank body on local shards, for a
caller whose cache is already sharded.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _partial_attention(q, k, v, valid):
    """Local partial softmax-attention over this shard's keys.

    q: (B,1,H,hd); k/v: (B,S_loc,KVH,hd); valid: (B,S_loc).
    Returns (m (B,H), l (B,H), acc (B,H,hd)) in fp32, unnormalized. A
    shard with no valid key gives l = 0 and acc = 0: ``p`` is masked to 0
    off the valid keys, as in the reference. Query head h reads KV head
    h // (H/KVH), as the reference's repeated K/V give it, here by
    grouping the query heads instead of repeating the keys."""
    B, _, H, hd = q.shape
    KVH = k.shape[2]
    qg = q.float().reshape(B, KVH, H // KVH, hd)
    s = torch.einsum("bngd,bknd->bngk", qg, k.float()).reshape(B, H, -1)
    mask = valid[:, None, :]
    s = s.mul(hd ** -0.5).masked_fill(~mask, NEG_INF)
    m = s.amax(-1)                                          # (B,H)
    p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
    acc = torch.einsum("bngk,bknd->bngd",
                       p.reshape(B, KVH, H // KVH, -1), v.float())
    return m, p.sum(-1), acc.reshape(B, H, hd)


def partial_decode_combine(q, k_local, v_local, valid_local, group):
    """One-token attention of ``q`` (B,1,H,hd), replicated over ``group``,
    over the keys that the ranks of ``group`` hold between them: each
    rank passes its own (B,S_loc,KVH,hd) K/V and (B,S_loc) mask. Returns
    (B,1,H,hd) in q's dtype, the same on every rank."""
    m, l, acc = _partial_attention(q, k_local, v_local, valid_local)
    m_star = m.clone()
    dist.all_reduce(m_star, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - m_star)
    # l and acc travel in one buffer: (B, H, hd + 1)
    sums = torch.cat([acc * scale[..., None], (l * scale)[..., None]], -1)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    out = sums[..., :-1] / torch.clamp(sums[..., -1:], min=1e-30)
    return out[:, None].to(q.dtype)


def sharded_decode_attention(q, k_cache, v_cache, valid, *, mesh,
                             seq_axis: str = "model"):
    """One-token attention with the cache's sequence dim sharded over the
    ``seq_axis`` dim of ``mesh`` (a ``DeviceMesh``).

    q: (B,1,H,hd); k/v_cache: (B,S,KVH,hd); valid: (B,S) bool; global
    tensors, the same on every rank. The rank at place ``r`` of the axis
    takes keys ``[r·S/n, (r+1)·S/n)``. Returns (B,1,H,hd) in q's dtype,
    replicated: the same on every rank. Raises if ``S`` does not split
    evenly over the axis's ``n`` ranks."""
    sub = mesh[seq_axis]
    n, r = sub.size(), sub.get_local_rank()
    S = k_cache.shape[1]
    if S % n:
        raise ValueError(f"sharded_decode_attention: {S} keys do not split "
                         f"over {n} ranks of the {seq_axis!r} axis")
    lo, hi = r * S // n, (r + 1) * S // n
    return partial_decode_combine(q, k_cache[:, lo:hi], v_cache[:, lo:hi],
                                  valid[:, lo:hi], sub.get_group())
