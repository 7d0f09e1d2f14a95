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
_L = ctypes.c_longlong
# C signatures by source, then entry: every entry that launches returns
# the launch's CUDA error (0 for none), every entry an int. dtype: 0 =
# float32, 1 = bfloat16.
SIGNATURES = {
    "decode_attention": {
        # q, k, v, valid, out, B, S, H, KVH, hd, nsplit, chunk, dtype,
        # stream
        "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P],
        # q, k pool, v pool, page table, valid, out, B, S, H, KVH, hd,
        # page_size, nsplit, chunk, dtype, stream
        "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P]},
    "flash_attention": {
        # q, k, v, out, B, Sq, Sk, H, KVH, hd, window, dtype, stream
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P]},
    "grpo_logprob": {
        # logits, targets, out (2, N), N, V, nsplit (0: the entry's
        # choice), dtype, stream
        "grpo_logprob": [_P, _P, _P, _I, _I, _I, _I, _P],
        # N, V, dtype -> the blocks a row both vocab entries choose
        "vocab_nsplit": [_I, _I, _I],
        # nsplit, dtype -> clusters the card holds at once
        "grpo_logprob_clusters": [_I, _I]},
    "fused_rl_loss": {
        # logits, targets, old, ref, adv, out (6, N), N, V, nsplit,
        # clip_eps, dtype, stream
        "fused_rl_loss_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                              _P],
        "fused_rl_loss_fwd_clusters": [_I, _I],
        # logits, targets, lse, xbar, dlp, g_ent, dx, N, V, dtype, stream
        "fused_rl_loss_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "mamba_scan": {
        # x, dt, A, B, C, y, B, S, D, N, B's batch and time strides, C's
        # batch and time strides (elements), path (0: the entry's choice,
        # 1 short, 2 long), stream
        "mamba_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                       _L, _I, _P],
        # B, S, D, SMs of the card -> the path the entry takes (1 short,
        # 2 long)
        "mamba_scan_path": [_I, _I, _I, _I]},
    "rglru_scan": {
        # a, b, h, B, S, W, path (as mamba_scan's), stream
        "rglru_scan": [_P, _P, _P, _I, _I, _I, _I, _P],
        # S -> the path the entry takes
        "rglru_scan_path": [_I]},
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
    for t in tensors:
        if not t.is_cpu:
            return False
    return True


def require_no_grad(name: str, *tensors) -> None:
    """Raise when autograd would record a kernel that has no backward: a
    gradient must never go missing silently."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t.requires_grad:
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward, and autograd is "
                "recording inputs that require grad; call it under "
                "torch.no_grad(), or differentiate the plain route")


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the kernels' entries
    take it (a ``cudaStream_t``), without building a ``torch.cuda.Stream``
    (the getter PyTorch's own generated kernels use)."""
    return torch._C._cuda_getCurrentRawStream(index)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 160, 256)


def aligned(t):
    """``t`` as a contiguous tensor on a 16-byte aligned base (a copy only
    where ``t`` is not one already)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fp32(t):
    """``t`` as float32 (``t`` itself where it is one)."""
    return t if t.dtype == torch.float32 else t.float()


def kernel_inputs(name: str, *tensors):
    """``tensors`` as the kernels take them: contiguous on 16-byte aligned
    bases (a copy only where one is not), all on one CUDA device, else
    ValueError. A few attribute reads a tensor, for wrappers whose host
    time is most of a call."""
    index = tensors[0].get_device()          # -1 on the CPU
    if index < 0 or any(t.get_device() != index for t in tensors[1:]):
        raise ValueError(f"{name}: inputs must share one CUDA device "
                         f"(got {[str(x.device) for x in tensors]})")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            return [x if x.is_contiguous() and not x.data_ptr() % 16
                    else aligned(x) for x in tensors]
    return tensors


def check_cuda_inputs(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned tensor on
    one CUDA device (a kernel takes nothing else)."""
    index = tensors[0].get_device()          # -1 on the CPU
    for t in tensors:
        if t.get_device() != index or not t.is_cuda:
            raise ValueError(f"{name}: inputs must share one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             "16-byte aligned")
