"""Wrapper: the CUDA kernel (``csrc/rglru_scan.cu``) for CUDA tensors, the
plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient (the training forward takes
the differentiable associative scan of ``models/rglru.py``).

Inputs are cast to fp32, as the Pallas wrapper casts them. Any B, S and W:
the kernel masks ragged tails in place, where the reference's wrapper
falls back to its oracle."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a, b):
    """a, b: (B, S, W) -> h (B, S, W) float32, h_t = a_t h_{t-1} + b_t."""
    if _build.on_cpu(a, b):
        return rglru_scan_ref(a, b)
    _build.require_no_grad("rglru_scan", a, b)
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: unsupported shapes a={tuple(a.shape)}"
                         f" b={tuple(b.shape)} (both (B, S, W))")
    a, b = (_build.aligned(t.float()) for t in (a, b))
    _build.check_cuda_inputs("rglru_scan", a, b)
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    err = _build.kernel("rglru_scan")(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("rglru_scan", err)
    _build.count_launch(rglru_scan)
    return h


rglru_scan.launches = 0
