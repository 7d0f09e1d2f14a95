"""Wrapper: the CUDA kernel (``csrc/mamba_scan.cu``) for CUDA tensors, the
plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient (the training forward takes
the plain, differentiable scan).

Inputs are cast to fp32, as the Pallas body casts them. The checks that
raise (device, shape, contiguity and alignment, no-grad) cost a few
attribute reads each, and fp32 inputs that the kernel takes as they are go
to it uncopied: x, dt and A contiguous; B and C as they come, through
their batch and time strides, since the model hands over ``torch.split``
views of the x_proj output (a row stride of dt_rank + 2N)."""
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, _routes
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

STATE_SIZES = (8, 16)
CHANNELS = 64              # channels a block
SHORT_MAX = 128            # longest S of the entry's short path
SHORT_BLOCKS = 2           # its grid's blocks an SM at most


def path_for(B, S, D, n_sm):
    """The path the C entry takes for B rows of S steps over D channels on
    a card of ``n_sm`` SMs (``mamba_scan_path`` in ``csrc/mamba_scan.cu``):
    1, every step's inputs copied into shared memory in one round, up to
    SHORT_MAX steps on a grid of at most SHORT_BLOCKS blocks an SM; else
    2, the long path."""
    blocks = B * -(-D // CHANNELS)
    return 1 if S <= SHORT_MAX and blocks <= SHORT_BLOCKS * n_sm else 2


def _rows(t, index):
    """B or C (B, S, N) in fp32 with a contiguous last axis, its batch and
    time strides kept; ValueError off the CUDA device ``index``."""
    if t.get_device() != index:
        raise ValueError("mamba_scan: inputs must share one CUDA device "
                         f"(got {t.device} beside cuda:{index})")
    t = _build.fp32(t)
    return t if t.stride(-1) == 1 else t.contiguous()


def mamba_scan(x, dt, a, b, c, *, path=0):
    """x, dt: (B,S,D); a: (D,N); b, c: (B,S,N) -> y (B,S,D) float32. Any
    S and D: the kernel masks ragged tails in place; N in (8, 16).
    ``path`` forces the entry's path (1 short, 2 long); 0 leaves the
    choice to the entry (``path_for``)."""
    if isinstance(x, DTensor) or x.is_meta:
        return _routes.mamba_scan(mamba_scan, x, dt, a, b, c, path=path)
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
    x, dt, a = _build.kernel_inputs("mamba_scan", _build.fp32(x),
                                    _build.fp32(dt), _build.fp32(a))
    index = x.get_device()
    b, c = _rows(b, index), _rows(c, index)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _build.check("mamba_scan", _build.kernel("mamba_scan")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, D, N, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), path, _build.raw_stream(index)))
    _build.count_launch(mamba_scan)
    return y


mamba_scan.launches = 0
