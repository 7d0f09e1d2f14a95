"""Wrapper: the CUDA kernel (``csrc/mamba_scan.cu``) for CUDA tensors, the
plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient (the training forward takes
the plain, differentiable scan).

Inputs are cast to fp32, as the Pallas body casts them. x, dt and A are
made contiguous; B and C are taken as they come, through their batch and
time strides, since the model hands over ``torch.split`` views of the
x_proj output (a row stride of dt_rank + 2N)."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

STATE_SIZES = (8, 16)


def mamba_scan(x, dt, a, b, c):
    """x, dt: (B,S,D); a: (D,N); b, c: (B,S,N) -> y (B,S,D) float32. Any
    S and D: the kernel masks ragged tails in place; N in (8, 16)."""
    if _build.on_cpu(x, dt, a, b, c):
        return mamba_scan_ref(x, dt, a, b, c)
    _build.require_no_grad("mamba_scan", x, dt, a, b, c)
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba_scan: unsupported shapes x={tuple(x.shape)}"
                         f" a={tuple(a.shape)}")
    B, S, D = x.shape
    N = a.shape[1]
    if (dt.shape != x.shape or a.shape != (D, N) or b.shape != (B, S, N)
            or c.shape != (B, S, N) or N not in STATE_SIZES):
        raise ValueError(
            f"mamba_scan: unsupported shapes x={tuple(x.shape)} "
            f"dt={tuple(dt.shape)} a={tuple(a.shape)} b={tuple(b.shape)} "
            f"c={tuple(c.shape)} (N in {STATE_SIZES})")
    x, dt, a = (t.float().contiguous() for t in (x, dt, a))
    b, c = (t.float() for t in (b, c))
    b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (b, c))
    dev = x.device
    if any(t.device != dev for t in (dt, a, b, c)):
        raise ValueError("mamba_scan: inputs must share one CUDA device "
                         f"(got {[str(t.device) for t in (x, dt, a, b, c)]})")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    err = _build.kernel("mamba_scan")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, D, N, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("mamba_scan", err)
    _build.count_launch(mamba_scan)
    return y


mamba_scan.launches = 0
