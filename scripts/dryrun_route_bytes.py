#!/usr/bin/env python3
"""Split a dry run's collective bytes between the kernel wrappers'
DTensor routes (``kernels/_routes.py``: the redistributions to the
placements a kernel takes, and the key-split decode's combine) and the
rest of the step, by op and output shape.

  PYTHONPATH=src python scripts/dryrun_route_bytes.py --arch qwen2_5_7b \
      --shape train_4k --layers 1

Runs on the CPU on meta tensors over a fake process group, as
``repro_torch.launch.dryrun`` does; no card.
"""
import argparse
import collections
import dataclasses
import json

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.kernels import _routes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "pod"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this depth (0: all)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    inside = [False]
    routed = _routes._local

    def local(*a, **kw):
        inside[0] = True
        try:
            return routed(*a, **kw)
        finally:
            inside[0] = False
    _routes._local = local
    seen = collections.Counter()
    record = dryrun.Recorder.__torch_dispatch__

    def dispatch(self, func, types, a=(), kw=None):
        out = record(self, func, types, a, kw)
        if out is not NotImplemented and \
                func._overloadpacket in dryrun.COLLECTIVES:
            where = "routes" if inside[0] else "step"
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    seen[where, func._overloadpacket.__name__,
                         str(tuple(t.shape))] += t.numel() * t.element_size()
        return out
    dryrun.Recorder.__torch_dispatch__ = dispatch
    mesh = dryrun.fake_mesh(*production_shape(
        multi_pod=args.mesh == "pod"))
    try:
        step, step_args = dryrun.build_step(cfg, args.shape, mesh)
        _, account = dryrun.trace(step, step_args, mesh)
    finally:
        dist.destroy_process_group()
    total = collections.Counter()
    for (where, _, _), n in seen.items():
        total[where] += n
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "layers": cfg.num_layers, "bytes": dict(total),
        "total": account["collective_bytes"]["total"],
        "largest": [[*k, n] for k, n in seen.most_common(8)]}, indent=1))


if __name__ == "__main__":
    main()
