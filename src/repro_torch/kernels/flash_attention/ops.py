"""Wrapper: the CUDA kernel (``csrc/flash_attention.cu``) for CUDA
tensors, the plain version for CPU tensors, nothing else.

The kernel is forward only, as the reference's Pallas kernel is, and the
ctypes launch records no autograd graph: on CUDA tensors that require grad
under grad mode the wrapper raises instead of returning an output that
would silently drop the gradient of q, k and v. The training forward takes
the plain attention route (``forward(..., use_flash=False)``)."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, window=0):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KVH,hd), Sq <= Sk — causal, optional
    sliding window. Returns (B,Sq,H,hd) in the dtype of q. Masks ragged
    tails in place; there is no fallback for shapes that do not tile."""
    if _build.on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, window=window)
    _build.require_no_grad("flash_attention", q, k, v)
    _build.check_cuda_inputs("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    _, Sk, KVH, _ = k.shape
    if (k.shape != (B, Sk, KVH, hd) or v.shape != k.shape or Sq > Sk
            or H % KVH or hd not in _build.HEAD_DIMS):
        raise ValueError(
            f"flash_attention: unsupported shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)} "
            f"(Sq <= Sk, hd in {_build.HEAD_DIMS})")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q/k/v must share float32 or "
                         "bfloat16")
    out = torch.empty_like(q)
    err = _build.kernel("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KVH, hd, int(window), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
