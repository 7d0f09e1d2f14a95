"""Build the CUDA sources in ``src/repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library ``build/kernels/<name>-<hash>.so`` (hash of the source, so
an edited source rebuilds), with a plain C interface loaded through
``ctypes``. Every source starts compiling at once, at first use; nothing
is built when a module is imported. A build that fails raises.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every entry returns cudaGetLastError() after its launch.
SIGNATURES = {
    # q, k, v, valid, part_m, part_l, part_acc, out, B, S, H, KVH, hd,
    # nsplit, chunk, dtype(0=f32,1=bf16), stream
    "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P],
    # q, k, v, out, B, Sq, Sk, H, KVH, hd, window, dtype, stream
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
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
        for name, argtypes in SIGNATURES.items():
            if name not in _libs:
                lib = ctypes.CDLL(str(_lib_path(name)))
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _libs[name] = lib
        return dict(_libs)


def kernel(name: str):
    """The C entry ``name`` (builds every library on first use)."""
    lib = _libs.get(name) or build_all()[name]
    return getattr(lib, name)


def check(name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


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
