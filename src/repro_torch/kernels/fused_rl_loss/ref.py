"""Plain PyTorch versions of ``csrc/fused_rl_loss.cu``, and the unfused
oracle.

``fused_rl_loss_fwd_ref`` and ``fused_rl_loss_bwd_ref`` repeat the
kernels' arithmetic (the reference's one-pass forward and its backward
formula, ``src/repro/kernels/fused_rl_loss/ops.py``); the wrappers take
them for CPU tensors. ``fused_rl_loss_oracle`` is the autodiff-able
composition over a materialised log-softmax that both must match, values
and (through ``torch.autograd``) gradients. ``fused_rl_loss_bwd_tolerance``
is the elementwise limit the backward kernel is held to.
"""
import torch


def _epilogue(lp, old, ref, adv, clip_eps):
    ratio = torch.exp(lp - old.float())
    a = adv.float()
    unclipped = ratio * a
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * a
    d = ref.float() - lp
    return torch.exp(d) - d - 1.0, -torch.minimum(unclipped, clipped), ratio


def fused_rl_loss_fwd_ref(logits, targets, old_logprob, ref_logprob,
                          advantage, *, clip_eps=0.2):
    """logits (N, V), the rest (N,) -> (lp, ent, kl, pl, ratio, lse), each
    (N,) float32, by one pass: lse, entropy and the target pick without a
    log-softmax."""
    x = logits.float()
    m = x.max(-1).values
    s = torch.exp(x - m[:, None])
    l = s.sum(-1)
    lse = m + torch.log(l)
    lp = x.gather(1, targets.long()[:, None])[:, 0] - lse
    ent = lse - (s * x).sum(-1) / l
    kl, pl, ratio = _epilogue(lp, old_logprob, ref_logprob, advantage,
                              clip_eps)
    return lp, ent, kl, pl, ratio, lse


def fused_rl_loss_bwd_ref(logits, targets, lse, xbar, dlp, g_ent):
    """dx = dlp*onehot(t) - p*(dlp + g_ent*(x - xbar)), p = exp(x - lse),
    from the (N,) row statistics; in the logits' dtype."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    dx = -p * (dlp[:, None] + g_ent[:, None] * (x - xbar[:, None]))
    rows = torch.arange(x.shape[0], device=x.device)
    dx[rows, targets.long()] += dlp
    return dx.to(logits.dtype)


def fused_rl_loss_bwd_tolerance(logits, targets, lse, xbar, dlp, g_ent,
                                ref, rtol):
    """Elementwise limit on |dx - ref| for a dx of the same inputs computed
    by another fp32 route (``ref`` from ``fused_rl_loss_bwd_ref``):
    ``rtol*|ref|`` for the one rounding to the output dtype and the exp,
    plus 1e-5 of the summed terms' magnitude ``p*(|dlp| + |g_ent*(x -
    xbar)|) (+|dlp| at the target)``, where ``dlp + g_ent*(x - xbar)``
    cancels and fp32 rounding leaves the result no relative accuracy. The
    limit scales with each element, so a dx that is wrong on the many
    columns far below 1 fails it."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    terms = p * (dlp.abs()[:, None]
                 + g_ent.abs()[:, None] * (x - xbar[:, None]).abs())
    rows = torch.arange(x.shape[0], device=x.device)
    terms[rows, targets.long()] += dlp.abs()
    return rtol * ref.float().abs() + 1e-5 * terms


def fused_rl_loss_oracle(logits, targets, old_logprob, ref_logprob,
                         advantage, *, clip_eps=0.2):
    """Unfused: (lp, ent, kl, pl, ratio) over a materialised log-softmax,
    differentiable by autograd."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = logp.gather(1, targets.long()[:, None])[:, 0]
    ent = -(torch.exp(logp) * logp).sum(-1)
    kl, pl, ratio = _epilogue(lp, old_logprob, ref_logprob, advantage,
                              clip_eps)
    return lp, ent, kl, pl, ratio
