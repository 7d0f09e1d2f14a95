"""Wrapper: the CUDA kernel (``csrc/decode_attention.cu``) for CUDA
tensors, the plain version for CPU tensors, nothing else."""
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


GMAX = 8           # query heads per block (csrc/decode_attention.cu)
MIN_SPLIT = 64     # keys per S split, at least


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _splits(device, B, S, H, KVH):
    """(nsplit, chunk): cut S so that about two blocks per SM run, each
    over ``chunk`` keys; every split holds at least one key."""
    blocks = B * KVH * -(-(H // KVH) // GMAX)
    n_sm = _num_sms(device.index)
    nsplit = max(1, min(-(-S // MIN_SPLIT), -(-2 * n_sm // blocks)))
    chunk = -(-S // nsplit)
    return -(-S // chunk), chunk


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B,1,H,hd); k/v_cache: (B,S,KVH,hd); valid: (B,S) bool.

    Returns (B,1,H,hd) in the dtype of q. Masks ragged S in place; there
    is no fallback for shapes that do not tile."""
    args = (q, k_cache, v_cache, valid)
    if _build.on_cpu(*args):
        return decode_attention_ref(*args)
    _build.require_no_grad("decode_attention", *args)
    _build.check_cuda_inputs("decode_attention", *args)
    B, one, H, hd = q.shape
    _, S, KVH, _ = k_cache.shape
    if (one != 1 or k_cache.shape != (B, S, KVH, hd)
            or v_cache.shape != k_cache.shape or valid.shape != (B, S)
            or H % KVH or hd not in _build.HEAD_DIMS):
        raise ValueError(
            f"decode_attention: unsupported shapes q={tuple(q.shape)} "
            f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)} "
            f"valid={tuple(valid.shape)} (hd in {_build.HEAD_DIMS})")
    if (q.dtype not in _build.DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype or valid.dtype != torch.bool):
        raise ValueError("decode_attention: q/k/v must share float32 or "
                         "bfloat16 and valid must be bool")
    nsplit, chunk = _splits(q.device, B, S, H, KVH)
    out = torch.empty_like(q)
    part_m = torch.empty((B, H, nsplit), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, nsplit, hd), dtype=torch.float32,
                           device=q.device)
    err = _build.kernel("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, S, H, KVH, hd, nsplit, chunk,
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
