"""Build the CUDA sources in ``src/repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library ``build/kernels/<name>-<hash>.so`` (hash of the source, so
an edited source rebuilds), with a plain C interface loaded through
``ctypes``; a source may export several entries. Every source starts
compiling at once, at first use; nothing is built when a module is
imported. A build that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures by source, then entry: every entry returns
# cudaGetLastError() after its launch. dtype: 0 = float32, 1 = bfloat16.
SIGNATURES = {
    "decode_attention": {
        # q, k, v, valid, part_m, part_l, part_acc, out, B, S, H, KVH, hd,
        # nsplit, chunk, dtype, stream
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P]},
    "flash_attention": {
        # q, k, v, out, B, Sq, Sk, H, KVH, hd, window, dtype, stream
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P]},
    "grpo_logprob": {
        # logits, targets, lp, ent, N, V, dtype, stream
        "grpo_logprob": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "fused_rl_loss": {
        # logits, targets, old, ref, adv, lp, ent, kl, pl, ratio, lse, N, V,
        # clip_eps, dtype, stream
        "fused_rl_loss_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _F, _I, _P],
        # logits, targets, lse, xbar, dlp, g_ent, dx, N, V, dtype, stream
        "fused_rl_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}
_count_lock = threading.Lock()
build_seconds = 0.0           # wall time of the builds in this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel, then load them all."""
    global build_seconds
    with _lock:
        todo = [n for n in SIGNATURES
                if n not in _libs and not _lib_path(n).exists()]
        if todo:
            t0 = time.monotonic()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name in todo:
                tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
                log = open(BUILD_DIR / f"{name}.log", "w")
                procs[name] = (tmp, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT))
            failed = []
            for name, (tmp, log, proc) in procs.items():
                rc = proc.wait()
                log.close()
                if rc:
                    failed.append(name)
                else:
                    os.replace(tmp, _lib_path(name))
            build_seconds += time.monotonic() - t0
            if failed:
                raise RuntimeError(
                    f"nvcc failed for {failed}; see "
                    + ", ".join(str(BUILD_DIR / f"{n}.log") for n in failed))
        for name, entries in SIGNATURES.items():
            if name not in _libs:
                lib = ctypes.CDLL(str(_lib_path(name)))
                for entry, argtypes in entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _entries[entry] = fn
                _libs[name] = lib
        return dict(_libs)


def kernel(entry: str):
    """The C entry ``entry`` (builds every library on first use)."""
    fn = _entries.get(entry)
    if fn is None:
        build_all()
        fn = _entries[entry]
    return fn


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; rollout and trainer threads launch
    kernels concurrently, so the read-modify-write takes a lock."""
    with _count_lock:
        wrapper.launches += 1


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers then run their
    plain versions. Anything else takes the kernel or raises."""
    return all(t.device.type == "cpu" for t in tensors)


def require_no_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a kernel that has no backward: a
    gradient must never go missing silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and autograd is "
            "recording inputs that require grad; call it under "
            "torch.no_grad(), or differentiate the plain route")


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def aligned(t):
    """``t`` as a contiguous tensor on a 16-byte aligned base (a copy only
    where ``t`` is not one already)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_cuda_inputs(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned tensor on
    one CUDA device (a kernel takes nothing else)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: inputs must share one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
