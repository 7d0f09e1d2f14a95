"""Weights made on the device from the run's seed, one large draw a leaf.

A leaf's values depend only on the seed and its path, so the reference
and the change readings can make any one leaf again without the others.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

from perfbench.core.traffic import stream_seed


def tree_items(tree, prefix: tuple = ()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) of a nested dict of tensors, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaf(path, shape, init, seed: int, device, dtype=torch.float32):
    """One leaf: ``("normal", mean, std)`` drawn from a generator on the
    device seeded by (seed, path), or ``("log_arange", n)``: log(1..n)
    along the last axis."""
    if init[0] == "log_arange":
        a = torch.log(torch.arange(1, init[1] + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(*shape).to(dtype).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights", *path))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(init[1], init[2], generator=gen)
    return t.to(dtype)


def nest(items) -> dict:
    """The nested dict of (path, leaf) pairs."""
    tree: dict = {}
    for path, value in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def make(layout, seed: int, device, dtype=torch.float32) -> dict:
    """The nested parameter tree of ``layout`` ([(path, shape, init)])."""
    return nest((path, leaf(path, shape, init, seed, device, dtype))
                for path, shape, init in layout)

