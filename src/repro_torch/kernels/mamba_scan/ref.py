"""Plain PyTorch version of ``csrc/mamba_scan.cu``: the Mamba-1 selective
scan as a sequential fp32 recurrence over the sequence, differentiable,

    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t,   y_t = h_t · C_t.
"""
import torch


def scan_from(x, dt, a, b, c, h):
    """The recurrence from state ``h`` (B, D, N) over the S steps of x, dt
    (B, S, D) and b, c (B, S, N), all fp32. Returns (y (B, S, D), the last
    state)."""
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t]
        h = torch.exp(dtt[:, :, None] * a) * h \
            + (dtt * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_scan_ref(x, dt, a, b, c):
    """x, dt: (B,S,D); a: (D,N); b, c: (B,S,N) -> y (B,S,D) float32, from
    a zero state."""
    B, _, D = x.shape
    h0 = torch.zeros((B, D, a.shape[1]), dtype=torch.float32,
                     device=x.device)
    return scan_from(x.float(), dt.float(), a.float(), b.float(), c.float(),
                     h0)[0]
