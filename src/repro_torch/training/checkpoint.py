"""Checkpointing — save/restore trees of tensors (params, optimizer state)
to an .npz + JSON key-list pair, in the reference's format: ``arrays.npz``
holds the leaves as ``a0 … aN`` and ``meta.json`` holds ``step`` and the
leaves' ``keys``, in the order and with the key strings that JAX's
``tree_flatten_with_path`` gives (dict keys sorted, ``.field`` for a
named tuple's fields, list indices). A checkpoint written by either
package restores into the other.

Device tensors go to the host one leaf at a time, through one pinned
buffer as large as the largest leaf (the archive is streamed, so the host
never holds a second copy of the whole tree), and come back the same way
on the ``like`` tree's device, in its dtype. Python
ints (``TrainState.step``, the optimizer's ``count``) are stored as 0-d
int32 arrays, as the reference's are, and read back as ints.

Saves are crash-atomic: both files are written into a temp directory,
fsynced, and the directory is renamed into place in one step — a process
killed mid-save can never leave a half-written checkpoint that
:func:`restore_checkpoint` would load. When overwriting an existing
checkpoint the old directory is moved aside first, so every observable
state is either the complete old checkpoint, the complete new one, or
(for the instant between the two renames) no checkpoint at all — never
a torn mix of the two.
"""
from __future__ import annotations

import json
import os
import shutil
import uuid
import zipfile
from typing import Any

import numpy as np
import torch


def _children(tree, path):
    """(child path, child) pairs of an inner node, in the node's own order;
    None for a leaf. ``.field`` for a named tuple, the key for a dict, the
    index for a list, as JAX spells a path."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(path + ("." + f,), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(path + (str(k),), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(path + (str(i),), v) for i, v in enumerate(tree)]
    return None


def _walk(tree, path, fn):
    """A tree shaped like ``tree`` (its key order kept) with
    ``fn(key, leaf)`` at each leaf; ``key`` is the leaf's path string."""
    kids = _children(tree, path)
    if kids is None:
        return fn("/".join(path), tree)
    vals = [_walk(v, p, fn) for p, v in kids]
    if isinstance(tree, dict):
        return dict(zip(tree, vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _flatten_with_paths(tree, path=()):
    """(keys, leaves) in JAX's order: dict keys sorted, named-tuple fields
    and list items in order."""
    kids = _children(tree, path)
    if kids is None:
        return ["/".join(path)], [tree]
    if isinstance(tree, dict):
        kids = sorted(kids, key=lambda pv: pv[0][-1])
    keys, vals = [], []
    for p, v in kids:
        k, x = _flatten_with_paths(v, p)
        keys += k
        vals += x
    return keys, vals


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes                # what JAX's numpy bfloat16 is
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    if isinstance(v, (bool, int)) and not isinstance(v, np.ndarray):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _like(a, v):
    """The saved array ``a`` as the kind of leaf ``v`` is."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16 and a.dtype.itemsize == 2 \
                and a.dtype.kind != "f":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
            return t.view(torch.bfloat16).to(v.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=v.device, dtype=v.dtype)
    if isinstance(v, bool):
        return bool(a)
    if isinstance(v, int):
        return int(a)
    if isinstance(v, float):
        return float(a)
    return np.asarray(a).astype(np.asarray(v).dtype)


def fsync_path(path: str) -> None:
    """fsync a file or directory so the rename that follows is durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass        # some filesystems refuse dir fsync; rename still atomic
    finally:
        os.close(fd)


def _write_npy(f, a):
    """``np.lib.format.write_array(f, a)`` for a C-contiguous array, with
    the data handed to the archive in one write instead of copies of
    16 MiB chunks."""
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    header = np.lib.format.header_data_from_array_1_0(a)
    try:
        np.lib.format.write_array_header_1_0(f, header)
    except ValueError:                     # a header past 64 KiB
        np.lib.format.write_array_header_2_0(f, header)
    if a.size:
        f.write(memoryview(a.reshape(-1).view(np.uint8)))


def _read_npy(f, staging=None):
    """``np.lib.format.read_array(f)`` for the members ``_write_npy`` and
    ``np.save`` write, reading the data in one call into a writable array
    (a tensor made from it may be updated in place): a view of the uint8
    array ``staging`` where it is large enough, else a new array."""
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(f)
    order = "F" if fortran else "C"
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if staging is not None and nbytes <= staging.nbytes:
        a = staging[:nbytes].view(dtype).reshape(shape, order=order)
    else:
        a = np.empty(shape, dtype=dtype, order=order)
    buf = memoryview(a.reshape(-1, order="A").view(np.uint8))
    if f.readinto(buf) != buf.nbytes:
        raise ValueError("truncated array in checkpoint")
    return a


def _staging(leaves):
    """One pinned host buffer as large as the largest CUDA tensor among
    ``leaves`` (None without one): the card copies to and from pinned
    memory at the link's rate, and to pageable memory at a fraction of
    it. Leaves pass through it one at a time."""
    sizes = [t.numel() * t.element_size() for t in leaves
             if isinstance(t, torch.Tensor) and t.is_cuda]
    if not sizes:
        return None
    return torch.empty(max(sizes), dtype=torch.uint8, pin_memory=True)


def _to_host(v, staging):
    """Leaf ``v``, with a CUDA tensor copied into ``staging``."""
    if staging is None or not (isinstance(v, torch.Tensor) and v.is_cuda):
        return v
    buf = staging[:v.numel() * v.element_size()].view(v.dtype)
    return buf.view(v.shape).copy_(v.detach())


def _write_npz(path, vals):
    """``np.savez(path, a0=..., a1=...)``, one leaf on the host at a time."""
    staging = _staging(vals)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, v in enumerate(vals):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                _write_npy(f, _to_numpy(_to_host(v, staging)))


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    path = os.path.normpath(path)
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    keys, vals = _flatten_with_paths(tree)
    nonce = uuid.uuid4().hex[:8]
    tmp = f"{path}.tmp-{os.getpid()}-{nonce}"
    os.makedirs(tmp)
    try:
        npz = os.path.join(tmp, "arrays.npz")
        _write_npz(npz, vals)
        fsync_path(npz)
        meta_path = os.path.join(tmp, "meta.json")
        with open(meta_path, "w") as f:
            json.dump({"step": int(step), "keys": keys}, f)
            f.flush()
            os.fsync(f.fileno())
        fsync_path(tmp)
        if os.path.isdir(path):
            old = f"{path}.old-{os.getpid()}-{nonce}"
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, path)
        fsync_path(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` (its key order, devices and
    dtypes), matching leaves by key. Returns (tree, step)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    keys_saved = meta["keys"]
    keys_like, _ = _flatten_with_paths(like)
    if set(keys_saved) != set(keys_like) or \
            len(keys_saved) != len(keys_like):
        extra = sorted(set(keys_saved) - set(keys_like))
        missing = sorted(set(keys_like) - set(keys_saved))
        raise ValueError(
            f"checkpoint structure mismatch (checkpoint saved at step "
            f"{meta.get('step')}): only in checkpoint: {extra}; only in "
            f"target: {missing}")
    slot = {k: i for i, k in enumerate(keys_saved)}
    staging = _staging(_flatten_with_paths(like)[1])
    host = None if staging is None else staging.numpy()

    def leaf(k, v):
        on_card = isinstance(v, torch.Tensor) and v.is_cuda
        with zf.open(f"a{slot[k]}.npy") as f:
            return _like(_read_npy(f, host if on_card else None), v)

    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as zf:
        tree = _walk(like, (), leaf)
    return tree, meta["step"]
