"""Wrapper: the CUDA kernel (``csrc/decode_attention.cu``) for CUDA
tensors, the plain version for CPU tensors, nothing else."""
import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, _routes
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


GROUP = 16         # query heads per block: the tensor-core tile's M
MAX_SPLITS = 8     # S splits of one (batch, KV head, group): one cluster
TILE = 64          # keys per K/V tile; splits are cut at whole tiles


@functools.lru_cache(maxsize=None)
def _num_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _splits(n_sm, B, S, H, KVH):
    """(nsplit, chunk): cut S into at most MAX_SPLITS splits of whole
    tiles so that the blocks come to about two per SM (as many as fit
    there below hd 256); every split holds at least one key."""
    blocks = B * KVH * -(-(H // KVH) // GROUP)
    nsplit = max(1, min(MAX_SPLITS, -(-S // TILE), 2 * n_sm // blocks))
    chunk = TILE * -(-S // (TILE * nsplit))
    return -(-S // chunk), chunk


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B,1,H,hd); k/v_cache: (B,S,KVH,hd); valid: (B,S) bool.

    Returns (B,1,H,hd) in the dtype of q. Masks ragged S in place; there
    is no fallback for shapes that do not tile."""
    args = (q, k_cache, v_cache, valid)
    if isinstance(k_cache, DTensor) or k_cache.is_meta:
        return _routes.decode_attention(decode_attention, *args)
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
    nsplit, chunk = _splits(_num_sms(q.device.index), B, S, H, KVH)
    out = torch.empty_like(q)
    err = _build.kernel("decode_attention")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), out.data_ptr(), B, S, H, KVH, hd, nsplit, chunk,
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err)
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0
