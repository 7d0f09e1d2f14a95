"""Plain PyTorch version of flash_attention: the CPU route and the
yardstick the CUDA kernel is held against on the card."""
import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, window=0):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KVH,hd). Causal (+ optional window).

    Softmax weights stay fp32 up to the product with V, as in the
    reference kernel's oracle."""
    Sq, H, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk, KVH = k.shape[1], k.shape[2]
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
