"""Plain PyTorch version of ``csrc/grpo_logprob.cu``: the same one-pass
formula (max, sum of exps, entropy sum, target pick) in fp32."""
import torch


def grpo_logprob_ref(logits, targets):
    """logits (N, V); targets (N,) int -> (logprob (N,), entropy (N,)),
    float32."""
    x = logits.float()
    m = x.max(-1).values
    s = torch.exp(x - m[:, None])
    l = s.sum(-1)
    lse = m + torch.log(l)
    g = x.gather(1, targets.long()[:, None])[:, 0]
    return g - lse, lse - (s * x).sum(-1) / l


def split_bounds(V, nsplit, vec, head=0):
    """The column range [lo, hi) each of ``nsplit`` blocks takes in the
    kernels' vocab pass over a row of V logits: the row's 16-byte vectors
    of ``vec`` elements from column ``head`` on, cut into equal runs; the
    first block also takes the ``head`` columns before them, the last the
    ragged tail after them. A block may get no column."""
    nvec = (V - head) // vec
    per = -(-nvec // nsplit)
    bounds = []
    for s in range(nsplit):
        v0 = min(nvec, s * per)
        v1 = min(nvec, v0 + per)
        lo = 0 if s == 0 else head + v0 * vec
        hi = V if s == nsplit - 1 else head + v1 * vec
        bounds.append((lo, hi))
    return bounds


def grpo_logprob_split(logits, targets, nsplit, vec=8, head=0):
    """The kernels' split pass in plain PyTorch: each block's (m, l, t)
    over its columns (``split_bounds``) and the target logit where its
    columns hold it, merged with weights exp(m_i - M). A block with no
    column adds the empty state (m = -1e30, l = t = 0). Returns (logprob
    (N,), entropy (N,)), float32."""
    x = logits.float()
    N = x.shape[0]
    tg = targets.long()
    M = torch.full((N,), -1e30, device=x.device)
    L, T, G = (torch.zeros(N, device=x.device) for _ in range(3))
    for lo, hi in split_bounds(x.shape[1], nsplit, vec, head):
        if hi <= lo:
            continue
        c = x[:, lo:hi]
        m = c.max(-1).values
        e = torch.exp(c - m[:, None])
        l, t = e.sum(-1), (e * c).sum(-1)
        inside = (tg >= lo) & (tg < hi)
        G = G + torch.where(
            inside, c.gather(1, (tg - lo).clamp(0, hi - lo - 1)[:, None])[:, 0],
            torch.zeros((), device=x.device))
        Mn = torch.maximum(M, m)
        wa, wb = torch.exp(M - Mn), torch.exp(m - Mn)
        L, T, M = L * wa + l * wb, T * wa + t * wb, Mn
    lse = M + torch.log(torch.clamp(L, min=1e-30))
    return G - lse, lse - T / torch.clamp(L, min=1e-30)
