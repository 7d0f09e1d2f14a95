"""Wrappers: the CUDA kernel (``csrc/decode_attention.cu``) for CUDA
tensors, the plain version for CPU tensors, nothing else.
``decode_attention`` reads dense per-row caches; ``paged_decode_attention``
reads one layer's page pool through a page table (the continuous engine's
decode round), in the kernel's paged mode."""
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


def paged_decode_attention(q, k_pool, v_pool, page_table, valid):
    """q: (B,1,H,hd); k/v_pool: one layer's page pools (num_pages,
    page_size, KVH, hd); page_table: (B, P) int64, key j of row b at row
    j % page_size of page ``page_table[b, j // page_size]``; valid:
    (B, P * page_size) bool.

    ``decode_attention`` over the keys the table maps, read in place: the
    kernel's paged mode, at the splits ``decode_attention`` takes for
    S = P * page_size, gives bit for bit what ``decode_attention`` gives on
    the gathered (B, S, KVH, hd) views, and counts its launches on
    ``decode_attention.launches``. On the CPU it gathers the views and runs
    the plain version. Every id in the table must name a page of the pool,
    a masked key's too."""
    _, ps, KVH, hd = k_pool.shape
    B, P = page_table.shape
    S = P * ps
    if _build.on_cpu(q, k_pool, v_pool, page_table, valid):
        return decode_attention_ref(
            q, k_pool[page_table].reshape(B, S, KVH, hd),
            v_pool[page_table].reshape(B, S, KVH, hd), valid)
    args = (q, k_pool, v_pool, page_table, valid)
    _build.require_no_grad("paged_decode_attention", *args)
    _build.check_cuda_inputs("paged_decode_attention", *args)
    H = q.shape[2]
    if (q.shape != (B, 1, H, hd) or v_pool.shape != k_pool.shape
            or valid.shape != (B, S) or H % KVH
            or hd not in _build.HEAD_DIMS):
        raise ValueError(
            f"paged_decode_attention: unsupported shapes q={tuple(q.shape)}"
            f" k_pool={tuple(k_pool.shape)} v_pool={tuple(v_pool.shape)} "
            f"page_table={tuple(page_table.shape)} "
            f"valid={tuple(valid.shape)} (hd in {_build.HEAD_DIMS})")
    if (q.dtype not in _build.DTYPE_CODES or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype or valid.dtype != torch.bool
            or page_table.dtype != torch.int64):
        raise ValueError("paged_decode_attention: q/k/v must share float32 "
                         "or bfloat16, valid must be bool and page_table "
                         "int64")
    nsplit, chunk = _splits(_num_sms(q.device.index), B, S, H, KVH)
    out = torch.empty_like(q)
    err = _build.kernel("paged_decode_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), valid.data_ptr(), out.data_ptr(), B, S, H,
        KVH, hd, ps, nsplit, chunk, _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_decode_attention", err)
    _build.count_launch(decode_attention)
    return out
