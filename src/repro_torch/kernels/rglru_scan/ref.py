"""Plain PyTorch version of ``csrc/rglru_scan.cu``: the RG-LRU linear
recurrence as a sequential fp32 loop over the sequence, from a zero state,

    h_t = a_t ⊙ h_{t-1} + b_t.
"""
import torch


def rglru_scan_ref(a, b):
    """a, b: (B, S, W) -> h (B, S, W) float32."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
