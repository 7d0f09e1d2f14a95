"""Wrapper: the CUDA kernel (``csrc/rglru_scan.cu``) for CUDA tensors, the
plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient (the training forward takes
the differentiable associative scan of ``models/rglru.py``).

Inputs are cast to fp32, as the Pallas wrapper casts them. The checks that
raise (device, shape, contiguity and alignment, no-grad) cost a few
attribute reads each, and fp32 inputs that the kernel takes as they are go
to it uncopied. Any B, S and W: the kernel masks ragged tails in place,
where the reference's wrapper falls back to its oracle."""
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, _routes
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

SHORT_MAX = 128            # longest S of the entry's short path


def path_for(S):
    """The path the C entry takes for S steps (``rglru_scan_path`` in
    ``csrc/rglru_scan.cu``): 1, every step's inputs copied into shared
    memory in one round, up to SHORT_MAX steps; else 2, the long path."""
    return 1 if S <= SHORT_MAX else 2


def rglru_scan(a, b, *, path=0):
    """a, b: (B, S, W) -> h (B, S, W) float32, h_t = a_t h_{t-1} + b_t.
    ``path`` forces the entry's path (1 short, 2 long); 0 leaves the
    choice to the entry (``path_for``)."""
    if isinstance(a, DTensor) or a.is_meta:
        return _routes.rglru_scan(rglru_scan, a, b, path=path)
    if _build.on_cpu(a, b):
        return rglru_scan_ref(a, b)
    _build.require_no_grad("rglru_scan", a, b)
    shape = a.shape
    if len(shape) != 3 or b.shape != shape:
        raise ValueError(f"rglru_scan: unsupported shapes a={tuple(shape)}"
                         f" b={tuple(b.shape)} (both (B, S, W))")
    a, b = _build.kernel_inputs("rglru_scan", _build.fp32(a), _build.fp32(b))
    h = torch.empty_like(a)
    B, S, W = shape
    if not B * S * W:
        return h
    _build.check("rglru_scan", _build.kernel("rglru_scan")(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W, path,
        _build.raw_stream(a.get_device())))
    _build.count_launch(rglru_scan)
    return h


rglru_scan.launches = 0
