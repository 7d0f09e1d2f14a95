"""Plain PyTorch version of decode_attention: the CPU route and the
yardstick the CUDA kernel is held against on the card."""
import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: (B,1,H,hd); caches: (B,S,KVH,hd); valid: (B,S) bool.

    Softmax weights stay fp32 up to the product with V, as in the
    reference kernel's oracle."""
    H, hd = q.shape[2], q.shape[3]
    KVH = k_cache.shape[2]
    if KVH != H:
        k_cache = k_cache.repeat_interleave(H // KVH, dim=2)
        v_cache = v_cache.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) \
        * hd ** -0.5
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache.float()).to(q.dtype)
