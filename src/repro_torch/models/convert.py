"""Carry parameters across between the reference and the port.

A reference param tree (nested dicts/lists of arrays, e.g. after
``jax.tree.map(np.asarray, params)``) maps to the port's tree of tensors
with the same keys and shapes — stacked leading layer axis included, dense
weights ``(d_in, d_out)`` — so nothing is transposed. Values are copied bit
for bit, bfloat16 included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _to_array(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                   # what JAX's numpy bfloat16 is
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_reference(tree, *, device=None):
    """Reference param tree (arrays) → the port's tree of tensors."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _to_tensor(a, dev))


def params_to_reference(params):
    """The port's tree of tensors → a tree of numpy arrays the reference
    takes as params."""
    return _map(params, _to_array)
