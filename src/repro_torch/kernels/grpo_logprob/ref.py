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
