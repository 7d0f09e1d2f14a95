"""The kernel wrappers' routes for DTensors and meta tensors.

A wrapper given a DTensor runs on each rank's local shard through
``torch.distributed.tensor.experimental.local_map``: its inputs are first
redistributed to placements the kernel can take, and each rank then calls
the wrapper on its local tensors, which launches the CUDA kernel on CUDA
shards, runs the plain version on CPU shards and gives the shape function's
outputs on meta shards. Batch and head (channel) dims may stay sharded;
keys, vocab, the scans' time axis, ``hd`` and ``N`` are made whole first
(vocab-sharded logits are all-gathered), and a ``Partial`` input is
reduced. A decode cache sharded along its keys is the exception: each rank
attends over its own keys and the ranks combine their partial softmaxes
with ``distributed/flash_decode.partial_decode_combine`` (an all-reduce
MAX and an all-reduce SUM), so the cache is never gathered; that route
launches no ``decode_attention``, as the mesh route of ``attend_decode``.

``write_slots`` is the decode cache's write for a DTensor cache: each
rank writes, in place, the rows and key slots its shard holds.

A wrapper given a meta tensor returns empty meta outputs of the kernel's
shapes and dtypes, after the shape checks the kernel's wrapper makes.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import _build


def _kept(leader, dims, shape, mesh):
    """Per mesh dim, the tensor dim of ``dims`` that ``leader`` (a DTensor)
    is sharded on there, if it still splits evenly, else None."""
    left = list(shape)
    out = []
    for n, pl in zip(mesh.shape, leader.placements):
        d = pl.dim if isinstance(pl, Shard) else None
        if d in dims and left[d] % n == 0:
            left[d] //= n
            out.append(d)
        else:
            out.append(None)
    return out


def _placements(kept, dim_map=None):
    """Placements from ``_kept``'s dims, renamed through ``dim_map`` (the
    leader's dim -> this input's dim, absent: replicate)."""
    out = []
    for d in kept:
        if d is not None and dim_map is not None:
            d = dim_map.get(d)
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def _as_dtensors(args, mesh):
    """Tensors among ``args`` as DTensors on ``mesh``: a plain tensor is
    taken as replicated (as ``implicit_replication`` takes it)."""
    return tuple(
        a if isinstance(a, DTensor) or not isinstance(a, torch.Tensor)
        else DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                run_check=False) for a in args)


def _local(fn, args, kwargs, in_pl, out_pl):
    """``fn`` on the local shards of ``args`` redistributed to ``in_pl``,
    its outputs DTensors with ``out_pl`` (one output's placements, or a
    tuple of them for several)."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    args = _as_dtensors(args, mesh)
    if out_pl and isinstance(out_pl[0], Placement):
        out_pl = list(out_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
                         *args, **kwargs)


# -- attention ----------------------------------------------------------------

def _attention_shapes(name, q, k, v):
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    if (k.shape != (B, Sk, KVH, hd) or v.shape != k.shape or H % KVH
            or hd not in _build.HEAD_DIMS):
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} "
                         f"(hd in {_build.HEAD_DIMS})")


def flash_attention(wrapper, q, k, v, *, window=0):
    if not isinstance(q, DTensor):
        _attention_shapes("flash_attention", q, k, v)
        if q.shape[1] > k.shape[1]:
            raise ValueError("flash_attention: Sq > Sk")
        return torch.empty_like(q)
    # batch and heads may stay sharded: q's heads split as k's do
    kept = _kept(q, (0, 2), (q.shape[0], 1, k.shape[2], 1), q.device_mesh)
    pl = _placements(kept)
    return _local(lambda *a: wrapper(*a, window=window), (q, k, v), {},
                  (pl, pl, pl), pl)


def decode_attention(wrapper, q, k_cache, v_cache, valid):
    if not isinstance(q, DTensor) and not isinstance(k_cache, DTensor):
        _attention_shapes("decode_attention", q, k_cache, v_cache)
        if q.shape[1] != 1 or valid.shape != k_cache.shape[:2]:
            raise ValueError(f"decode_attention: unsupported shapes q="
                             f"{tuple(q.shape)} valid={tuple(valid.shape)}")
        return torch.empty_like(q)
    args = (q, k_cache, v_cache, valid)
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    q, k_cache, v_cache, valid = _as_dtensors(args, mesh)
    B, S, KVH, _ = k_cache.shape
    # a mesh dim that splits the cache's keys keeps them split (the first
    # such; keys split on another are gathered); the others keep q's
    # batch and heads split
    seq = next((j for j, pl in enumerate(k_cache.placements)
                if pl == Shard(1) and S % mesh.shape[j] == 0), None)
    kept = _kept(q, (0, 2), (B, 1, KVH, 1), mesh)
    if seq is not None:
        kept[seq] = None
    qpl = _placements(kept)
    kvpl = list(qpl)
    vpl = list(_placements(kept, {0: 0}))
    if seq is None:
        return _local(wrapper, (q, k_cache, v_cache, valid), {},
                      (qpl, qpl, qpl, tuple(vpl)), qpl)
    from repro_torch.distributed.flash_decode import partial_decode_combine
    kvpl[seq] = vpl[seq] = Shard(1)
    group = mesh.get_group(seq)
    return _local(
        lambda *a: partial_decode_combine(*a, group), (q, k_cache, v_cache,
                                                      valid), {},
        (qpl, tuple(kvpl), tuple(kvpl), tuple(vpl)), qpl)


# -- scans --------------------------------------------------------------------

def mamba_scan(wrapper, x, dt, a, b, c, *, path=0):
    if not isinstance(x, DTensor):
        B, S, D = x.shape
        N = a.shape[-1]
        if (dt.shape != x.shape or a.shape != (D, N)
                or b.shape != (B, S, N) or c.shape != (B, S, N)):
            raise ValueError(f"mamba_scan: unsupported shapes x="
                             f"{tuple(x.shape)} a={tuple(a.shape)} "
                             f"b={tuple(b.shape)}")
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    # batch and channels may stay split; the time axis and N stay whole
    kept = _kept(x, (0, 2), x.shape, x.device_mesh)
    xpl = _placements(kept)
    apl = _placements(kept, {2: 0})
    bpl = _placements(kept, {0: 0})
    return _local(lambda *t: wrapper(*t, path=path), (x, dt, a, b, c), {},
                  (xpl, xpl, apl, bpl, bpl), xpl)


def rglru_scan(wrapper, a, b, *, path=0):
    if not isinstance(a, DTensor):
        if a.dim() != 3 or b.shape != a.shape:
            raise ValueError(f"rglru_scan: unsupported shapes a="
                             f"{tuple(a.shape)} b={tuple(b.shape)}")
        return torch.empty(a.shape, dtype=torch.float32, device=a.device)
    pl = _placements(_kept(a, (0, 2), a.shape, a.device_mesh))
    return _local(lambda *t: wrapper(*t, path=path), (a, b), {}, (pl, pl),
                  pl)


# -- the vocab kernels --------------------------------------------------------

def _rows(name, logits, rows):
    N = logits.shape[0]
    if logits.dim() != 2 or any(r.shape != (N,) for r in rows):
        raise ValueError(f"{name}: unsupported shapes logits="
                         f"{tuple(logits.shape)} rows="
                         f"{[tuple(r.shape) for r in rows]}")
    return N


def _row_placements(logits):
    """Rows may stay split; the vocab is made whole (all-gathered)."""
    kept = _kept(logits, (0,), logits.shape, logits.device_mesh)
    return _placements(kept), _placements(kept, {0: 0})


def grpo_logprob(wrapper, logits, targets, *, nsplit=0):
    if not isinstance(logits, DTensor):
        N = _rows("grpo_logprob", logits, (targets,))
        return torch.empty((2, N), dtype=torch.float32,
                           device=logits.device).unbind(0)
    xpl, rpl = _row_placements(logits)
    return _local(lambda *t: wrapper(*t, nsplit=nsplit), (logits, targets),
                  {}, (xpl, rpl), (rpl, rpl))


def fused_rl_loss_fwd(wrapper, logits, *rows, clip_eps=0.2, nsplit=0):
    if not isinstance(logits, DTensor):
        N = _rows("fused_rl_loss_fwd", logits, rows)
        return torch.empty((6, N), dtype=torch.float32,
                           device=logits.device).unbind(0)
    xpl, rpl = _row_placements(logits)
    return _local(lambda *t: wrapper(*t, clip_eps=clip_eps, nsplit=nsplit),
                  (logits, *rows), {}, (xpl, *[rpl] * len(rows)), (rpl,) * 6)


def fused_rl_loss_bwd(wrapper, logits, *rows):
    if not isinstance(logits, DTensor):
        _rows("fused_rl_loss_bwd", logits, rows)
        return torch.empty_like(logits)
    xpl, rpl = _row_placements(logits)
    return _local(wrapper, (logits, *rows), {}, (xpl, *[rpl] * len(rows)),
                  xpl)


# -- the decode cache's write -------------------------------------------------

def write_slots(cache, slot, new):
    """``cache[b, slot[b]] = new[b]`` on a DTensor cache (B, S, ...), in
    place on each rank's shard: ``slot`` and ``new`` are split as the
    cache's rows and trailing dims are, and where the cache's keys are
    split (on one mesh dim) a rank writes only the slots it holds; a row
    whose slot lies elsewhere writes back the value it holds at its
    clamped slot, so no two writes meet."""
    mesh = cache.device_mesh
    cpl = cache.placements
    seq = [j for j, pl in enumerate(cpl) if pl == Shard(1)]
    if len(seq) > 1:
        raise ValueError(f"write_slots: keys split on {len(seq)} mesh dims")
    spl = tuple(pl if pl == Shard(0) else Replicate() for pl in cpl)
    npl = tuple(pl if pl == Shard(0) else
                Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > 1
                else Replicate() for pl in cpl)
    if seq:
        n = mesh.shape[seq[0]]
        off = mesh.get_local_rank(seq[0]) * -(-cache.shape[1] // n)

    def local(c, s, v):
        rows = torch.arange(c.shape[0], device=c.device)
        if seq:
            s = s - off
            inside = (s >= 0) & (s < c.shape[1])
            s = s.clamp(0, c.shape[1] - 1)
            v = torch.where(inside.view(-1, *[1] * (v.dim() - 1)), v,
                            c[rows, s])
        c[rows, s] = v
        return c
    return _local(local, (cache, slot, new), {}, (cpl, spl, npl), cpl)
