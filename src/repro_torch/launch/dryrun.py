"""Multi-pod dry run: run every (architecture x input shape x mesh) step on
meta tensors placed as DTensors over a fake process group, without
hardware, and record what each rank would hold and send.

The reference lowers and compiles each step for 512 fake XLA devices and
reads the HLO. Here one process stands for rank 0 of a ``fake`` process
group of the mesh's size (256 ranks for ``single``, 512 for ``pod``) on a
``"cpu"`` ``DeviceMesh``; the params or train state, the inputs and the
cache are meta tensors placed by the sharding rules
(``distributed/sharding.py``), and the step runs once on them under
``implicit_replication`` (the models make plain tensors, positions and
masks, which count as replicated). DTensor inserts the collectives and
runs each op on meta shards: no data moves and no card is touched. A
dispatch-level recorder sees every op on the local shards: each
collective (its output bytes a rank) and each storage made, for the peak
of live local bytes. Every layer's calls are seen, so no loop multiplier
is applied. The analytic roofline comes from the planner's cost model on
``HW()``, one H100's figures.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_5_7b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.distributed.sharding import (P, batch_pspecs, cache_pspecs,
                                              dp_axes, map_specs,
                                              placements, state_pspecs,
                                              to_named, tree_pspecs)
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.specs import input_specs, params_struct, state_struct
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.training.train_state import TrainState

# the collectives DTensor and the port send: functional (DTensor's
# redistributions) and in place (``partial_decode_combine``)
COLLECTIVES = {
    *(getattr(torch.ops._c10d_functional, n) for n in (
        "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
        "all_to_all_single", "broadcast")),
    *(getattr(torch.ops.c10d, n) for n in (
        "allreduce_", "allgather_", "_allgather_base_", "reduce_scatter_",
        "_reduce_scatter_base_", "alltoall_base_", "broadcast_"))}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


class Recorder(TorchDispatchMode):
    """Every op on local shards: collectives by name with their output
    bytes, and the live bytes of the storages made, with their peak. A
    DTensor op is handed back to DTensor (``NotImplemented``), which runs
    it as ops on its shards that come back through here, its collectives
    among them."""

    def __init__(self):
        super().__init__()
        self.ops = defaultdict(int)
        self.bytes = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._seen = set()

    def track(self, t) -> None:
        """Count ``t``'s storage as live until it is freed."""
        s = _local(t).untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        # DTensor's shape propagation runs ops on fake tensors of the
        # global shapes: not a rank's
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)
                and not isinstance(t, FakeTensor)]
        if func._overloadpacket in COLLECTIVES:
            name = func._overloadpacket.__name__
            self.ops[name] += 1
            self.bytes[name] += sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)
        return out


# -- DTensor strategies: what GSPMD does where DTensor refuses -------------

_registered = []


def register_strategies():
    """Make DTensor run what GSPMD runs, for this process: (1) a view that
    would split a sharded dim unevenly (28 query heads of 128 over a
    16-way "model" axis: ``wq``'s output dim divides, its heads do not)
    makes its input whole on that mesh dim first, as a reshape does,
    where DTensor's strict view rule raises; (2) each op of
    ``REPLICATED_OPS`` that this DTensor release has no strategy for runs
    on replicated inputs (gathered first) and gives a replicated output;
    (3) a gather (``aten.index.Tensor``) keeps its split indices' split
    (``_index``). Idempotent."""
    if _registered:
        return
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    for op in (aten.view.default, aten._unsafe_view.default):
        register_op_strategy_map(op, torch.Tensor.view,
                                 schema_info=RuntimeSchemaInfo(1),
                                 strict_view=False)
    prop = DTensor._op_dispatcher.sharding_propagator
    known = (prop.op_strategy_funcs, prop.op_to_rules,
             getattr(prop, "op_single_dim_strategy_funcs", {}))
    for op in REPLICATED_OPS:
        if not any(op in d for d in known):
            register_sharding(op)(_replicated)
    # a single-dim rule takes precedence over a registered strategy
    DTensor._op_dispatcher.sharding_propagator \
        .op_single_dim_strategy_funcs.pop(aten.index.Tensor, None)
    register_sharding(aten.index.Tensor)(_index)
    _registered.append(True)


# ops of the embedding's sorted backward (``models/layers._Gather``) that
# some DTensor releases have no strategy for
REPLICATED_OPS = (torch.ops.aten.searchsorted.Tensor,
                  torch.ops.aten.segment_reduce.default,
                  torch.ops.aten.index_put_.default,
                  torch.ops.aten.index_put.default)


def _index(values, indices):
    """``values[indices]`` (``aten.index.Tensor``), one mesh dim's
    strategies: all replicated; the indices split on one of their
    (broadcast) dims and the values whole, the output split where the
    index dims land; or, only while no index is split, the values split on
    a dim the indices do not index. DTensor's own rule offers the last
    beside the second and picks the cheaper redistribution, so it gathers
    a batch-split token array (small) rather than the embedding table
    (large), and every rank then carries the whole batch; GSPMD keeps the
    batch split (the table's gather is the FSDP weight gather)."""
    slots = [t for t in indices if t is not None]
    dims = [i for i, t in enumerate(indices) if t is not None]
    nd = max(len(t.shape) for t in slots)
    insert = dims[0] if all(b - a == 1 for a, b in zip(dims, dims[1:])) \
        else 0

    def ins(of):       # placements of the indices, None where one is None
        return [None if t is None else of(t) for t in indices]
    out = [([Replicate()], [Replicate(), *ins(lambda t: Replicate())])]
    for bd in range(nd):
        def split(t):
            td = bd - (nd - len(t.shape))
            return Shard(td) if td >= 0 and t.shape[td] > 1 else Replicate()
        if any(isinstance(split(t), Shard) for t in slots):
            out.append(([Shard(bd + insert)], [Replicate(), *ins(split)]))
    if any(isinstance(p, Shard) for t in slots for p in t.placements):
        return out
    for d in range(len(values.shape)):
        if d in dims:
            continue
        od = d if d < insert else d + nd - sum(1 for j in dims if d > j)
        out.append(([Shard(od)], [Shard(d), *ins(lambda t: Replicate())]))
    return out


def _replicated(*args, **kwargs):
    """One strategy: every tensor input and the output replicated."""
    ins = [Replicate() if hasattr(a, "placements") else None
           for a in tree_flatten((args, kwargs))[0]]
    return [([Replicate()], ins)]


# -- FSDP: gather a parameter's data shards where the model reads it -------

class GatherWeights(TorchFunctionMode):
    """The rules' FSDP: a parameter's "data" and "pod" shards are gathered
    where the model reads it, at its cast to the compute dtype (``.to``)
    or to fp32 (``.float``), once a use; autograd sends its gradient back
    through the gather as a reduce-scatter. The rules shard params over
    "data" for storage ("XLA inserts the per-layer all-gathers"); without
    the gather DTensor may instead contract a matmul over the
    data-sharded dim, which leaves the batch whole on every rank.
    ``params`` names the parameters (their local storages: a detached
    alias, as ``grad_and_metrics`` makes, is the same parameter)."""

    def __init__(self, params, mesh):
        super().__init__()
        self.keys = {id(t._local_tensor.untyped_storage())
                     for t in tree_flatten(params)[0]
                     if isinstance(t, DTensor)}
        self.dp = [j for j, n in enumerate(mesh.mesh_dim_names)
                   if n in ("pod", "data")]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.Tensor.to, torch.Tensor.float) \
                and isinstance(out, DTensor) \
                and id(args[0]._local_tensor.untyped_storage()) in self.keys:
            pl = list(out.placements)
            if any(isinstance(pl[j], Shard) for j in self.dp):
                for j in self.dp:
                    pl[j] = Replicate()
                out = out.redistribute(out.device_mesh, pl)
        return out


@contextlib.contextmanager
def sharded(params, mesh):
    """What a step on DTensors runs under: the strategies of
    ``register_strategies``, ``implicit_replication`` (the models make
    plain tensors, positions and masks, which count as replicated) and
    the FSDP gather of ``params``."""
    register_strategies()
    with implicit_replication(), GatherWeights(params, mesh):
        yield


# -- placing structs as DTensors ------------------------------------------

def place(value, placements_, mesh):
    """``value`` as a DTensor with ``placements_`` on ``mesh``, this
    rank's shard as its local tensor: a fresh meta tensor of the shard's
    shape for a meta ``value``, else the rank's slice of ``value`` (the
    tensor itself on a mesh of size 1)."""
    shape, offset = compute_local_shape_and_global_offset(
        value.shape, mesh, placements_)
    local = torch.empty(shape, dtype=value.dtype, device="meta") \
        if value.is_meta else value[tuple(
            slice(o, o + n) for o, n in zip(offset, shape))].contiguous()
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=value.shape, stride=value.stride())


def place_tree(tree, specs, mesh):
    """Each tensor of ``tree`` placed by the spec at its place in
    ``specs``; what is not a tensor (a count, a step) stays as it is."""
    return map_specs(
        lambda value, spec: place(value, placements(spec, mesh), mesh)
        if isinstance(value, torch.Tensor) else value, tree, specs)


def local_bytes(tree) -> int:
    """Bytes of the local shards (plain tensors whole) of every tensor in
    ``tree``, each storage once."""
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            loc = _local(t)
            key = id(loc.untyped_storage())
            if key not in seen:
                seen.add(key)
                total += _nbytes(loc)
    return total


# -- the three steps on a mesh ----------------------------------------------

def build_step(cfg, shape_name, mesh, *, kv_seq_shard=False):
    """(step, its arguments as DTensors placed by the rules) for the step
    kind of ``shape_name``, from meta structs."""
    kind, specs = input_specs(cfg, shape_name)
    if kind == "train":
        state = state_struct(cfg)
        batch = specs["batch"]
        return make_train_step(cfg), (
            place_tree(state, state_pspecs(state, cfg, mesh), mesh),
            place_tree(batch, batch_pspecs(batch, cfg, mesh), mesh))
    params = params_struct(cfg)
    p = place_tree(params, tree_pspecs(params, cfg, mesh), mesh)
    if kind == "prefill":
        batch = specs["batch"]
        return make_prefill_step(cfg), (
            p, place_tree(batch, batch_pspecs(batch, cfg, mesh), mesh))
    cache, token = specs["cache"], specs["token"]
    B = token.shape[0]
    dp = dp_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_dp = math.prod(sizes[a] for a in (dp if isinstance(dp, tuple)
                                        else (dp,)))
    tok_spec = P(dp) if B % n_dp == 0 and B > 1 else P(None)
    return make_serve_step(cfg, ring=specs["ring"]), (
        p, place_tree(cache, cache_pspecs(cache, cfg, mesh, batch=B,
                                          kv_seq_shard=kv_seq_shard), mesh),
        place(token, placements(tok_spec, mesh), mesh),
        place(specs["pos"], placements(tok_spec, mesh), mesh))


def trace(step, args, mesh):
    """Run ``step(*args)`` under ``sharded`` and the recorder. Returns
    (outputs, the account): collectives by op with their output bytes a
    rank, and the argument, output and peak bytes of a rank."""
    rec = Recorder()
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            rec.track(t)
    params = args[0].params if isinstance(args[0], TrainState) else args[0]
    t0 = time.time()
    with sharded(params, mesh), rec:
        out = step(*args)
    account = {
        "trace_s": time.time() - t0,
        "collective_ops": dict(rec.ops),
        "collective_bytes": {**rec.bytes, "total": sum(rec.bytes.values())},
        "argument_bytes_per_rank": local_bytes(args),
        "output_bytes_per_rank": local_bytes(out),
        "peak_bytes_per_rank": rec.peak,
    }
    return out, account


def model_flops(cfg, shape_name: str) -> float:
    """6·N_active·D (training) / 2·N_active·D (per-token inference) — the
    'useful' MFU-accounting FLOPs."""
    shp = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch  # decode: one token per seq


def fake_mesh(dims, names):
    """A ``"cpu"`` DeviceMesh over a ``fake`` process group of
    ``prod(dims)`` ranks, this process rank 0; the caller destroys the
    group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(dims))
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=tuple(names))


def run_one(arch: str, shape_name: str, mesh_kind: str, *, overrides=None,
            mesh_shape=None, kv_seq_shard=False) -> dict:
    from repro_torch.core.planner.cost_model import roofline_terms

    if mesh_shape:  # hillclimb meshes, e.g. "32x8"
        dims = [int(x) for x in mesh_shape.split("x")]
        names = ("pod", "data", "model")[-len(dims):]
    else:
        dims, names = production_shape(multi_pod=mesh_kind == "pod")
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped",
                "reason": "enc-dec (448 decoder positions); see DESIGN.md"}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    mesh = fake_mesh(dims, names)
    try:
        step, args = build_step(cfg, shape_name, mesh,
                                kv_seq_shard=kv_seq_shard)
        _, account = trace(step, args, mesh)
    finally:
        dist.destroy_process_group()

    mesh_shape_d = dict(zip(names, dims))
    rt = roofline_terms(cfg, shape_name, mesh_shape_d,
                        kv_seq_shard=kv_seq_shard)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "n_chips": math.prod(dims),
        **account,
        # analytic roofline (planner cost model, one H100's figures)
        "flops": rt["flops"],
        "hbm_bytes_per_chip": rt["hbm_bytes_per_chip"],
        "collective_bytes_per_chip": rt["collective_bytes_per_chip"],
        "t_compute": rt["t_compute"], "t_memory": rt["t_memory"],
        "t_collective": rt["t_collective"],
        "bottleneck": rt["bottleneck"],
        "model_flops": model_flops(cfg, shape_name),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    rec["useful_flops_ratio"] = rec["model_flops"] / max(rt["flops"], 1.0)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "pod"])
    ap.add_argument("--mesh-shape", default=None,
                    help="hillclimb mesh, e.g. 32x8 (data x model)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override, e.g. --set ssm_chunk=256")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="shard decode KV cache sequence dim over 'model'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.lstrip("-").isdigit() else v
    rec_args = dict(arch=args.arch, shape_name=args.shape,
                    mesh_kind=args.mesh, overrides=overrides or None,
                    mesh_shape=args.mesh_shape,
                    kv_seq_shard=args.kv_seq_shard)
    try:
        rec = run_one(**rec_args)
    except Exception as e:  # record the failure — these are bugs to fix
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    out = json.dumps(rec, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return 0 if rec.get("status") in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
