"""The fused actor loss as a ``torch.autograd.Function`` over hand-written
CUDA kernels (``csrc/fused_rl_loss.cu``), counterpart of the reference's
``jax.custom_vjp`` (``src/repro/kernels/fused_rl_loss/ops.py``).

Forward: one streamed pass over the (N, V) logits gives lp, entropy, k3
KL, the clipped surrogate, the ratio and lse. Backward: the chain-rule
scalars are plain tensor ops on (N,) vectors, exactly as the reference
computes them; with ``d = ref - lp``, ``sel`` the unclipped branch (ties
pick it, as ``jnp.minimum`` picks its first operand) and ``in_clip`` the
ratio inside the clip interval:

  dpl/dlp = -where(sel, ratio*A, ratio*A*in_clip)
  dlp     = g_pl*dpl/dlp + g_kl*(1 - exp(d)) + g_ratio*ratio + g_lp
  g_old   = -g_pl*dpl/dlp - g_ratio*ratio
  g_ref   = g_kl*(exp(d) - 1)
  g_adv   = -g_pl*where(sel, ratio, clip(ratio))

then one more pass over the logits writes dx in their dtype, recomputing
the softmax from the saved (lse, xbar = lse - ent), so no (N, V) residual
is kept. Both passes are kernels for CUDA tensors and their plain versions
(``ref.py``) for CPU tensors; a failed build or launch raises.
"""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rl_loss.ref import (fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_fwd_ref)


def _check(name, logits, *rows):
    N = logits.shape[0]
    if logits.dim() != 2 or any(r.shape != (N,) for r in rows):
        raise ValueError(f"{name}: unsupported shapes logits="
                         f"{tuple(logits.shape)} rows="
                         f"{[tuple(r.shape) for r in rows]}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: logits must be float32 or bfloat16")


def _f32(t):
    return _build.aligned(t.to(torch.float32))


def fused_rl_loss_fwd(logits, targets, old_logprob, ref_logprob, advantage,
                      *, clip_eps=0.2):
    """(N, V) logits + four (N,) vectors -> (lp, ent, kl, pl, ratio, lse),
    each (N,) float32."""
    args = (logits, targets, old_logprob, ref_logprob, advantage)
    if _build.on_cpu(*args):
        return fused_rl_loss_fwd_ref(*args, clip_eps=clip_eps)
    _build.require_no_grad("fused_rl_loss_fwd", logits, old_logprob,
                           ref_logprob, advantage)
    _check("fused_rl_loss_fwd", *args)
    x = _build.aligned(logits)
    tg = _build.aligned(targets.to(torch.int64))
    old, ref, adv = (_f32(t) for t in args[2:])
    _build.check_cuda_inputs("fused_rl_loss_fwd", x, tg, old, ref, adv)
    N, V = x.shape
    outs = torch.empty((6, N), dtype=torch.float32, device=x.device)
    err = _build.kernel("fused_rl_loss_fwd")(
        x.data_ptr(), tg.data_ptr(), old.data_ptr(), ref.data_ptr(),
        adv.data_ptr(), *(o.data_ptr() for o in outs), N, V,
        float(clip_eps), _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_rl_loss_fwd", err)
    _build.count_launch(fused_rl_loss_fwd)
    return tuple(outs)


def fused_rl_loss_bwd(logits, targets, lse, xbar, dlp, g_ent):
    """dx (N, V) in the logits' dtype from the (N,) row statistics."""
    args = (logits, targets, lse, xbar, dlp, g_ent)
    if _build.on_cpu(*args):
        return fused_rl_loss_bwd_ref(*args)
    _check("fused_rl_loss_bwd", *args)
    x = _build.aligned(logits)
    tg = _build.aligned(targets.to(torch.int64))
    stats = [_f32(t) for t in args[2:]]
    _build.check_cuda_inputs("fused_rl_loss_bwd", x, tg, *stats)
    N, V = x.shape
    dx = torch.empty_like(x)
    err = _build.kernel("fused_rl_loss_bwd")(
        x.data_ptr(), tg.data_ptr(), *(t.data_ptr() for t in stats),
        dx.data_ptr(), N, V, _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("fused_rl_loss_bwd", err)
    _build.count_launch(fused_rl_loss_bwd)
    return dx


fused_rl_loss_fwd.launches = 0
fused_rl_loss_bwd.launches = 0


class FusedRLLoss(torch.autograd.Function):
    """(N, V) logits, (N,) targets/old/ref/adv -> (lp, ent, kl, pl, ratio),
    differentiable w.r.t. logits, old, ref and adv (not targets)."""

    @staticmethod
    def forward(ctx, logits, targets, old_lp, ref_lp, adv, clip_eps):
        lp, ent, kl, pl, ratio, lse = fused_rl_loss_fwd(
            logits, targets, old_lp, ref_lp, adv, clip_eps=clip_eps)
        ctx.save_for_backward(logits, targets, old_lp, ref_lp, adv, lp, ent,
                              lse)
        ctx.clip_eps = clip_eps
        return lp, ent, kl, pl, ratio

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_lp, g_ent, g_kl, g_pl, g_ratio):
        logits, targets, old_lp, ref_lp, adv, lp, ent, lse = \
            ctx.saved_tensors
        eps = ctx.clip_eps
        old, ref, a = old_lp.float(), ref_lp.float(), adv.float()
        ratio = torch.exp(lp - old)
        clip_r = torch.clamp(ratio, 1.0 - eps, 1.0 + eps)
        unclipped = ratio * a
        sel = unclipped <= clip_r * a
        in_clip = (ratio >= 1.0 - eps) & (ratio <= 1.0 + eps)
        dpl_dlp = -torch.where(sel, unclipped, unclipped * in_clip.float())
        expd = torch.exp(ref - lp)
        dlp = g_pl * dpl_dlp + g_kl * (1.0 - expd) + g_ratio * ratio + g_lp
        need = ctx.needs_input_grad
        dx = fused_rl_loss_bwd(logits, targets, lse, lse - ent, dlp, g_ent) \
            if need[0] else None
        g_old = (-g_pl * dpl_dlp - g_ratio * ratio).to(old_lp.dtype) \
            if need[2] else None
        g_ref = (g_kl * (expd - 1.0)).to(ref_lp.dtype) if need[3] else None
        g_adv = (-g_pl * torch.where(sel, ratio, clip_r)).to(adv.dtype) \
            if need[4] else None
        return dx, None, g_old, g_ref, g_adv, None


def fused_rl_loss(logits, targets, old_logprob, ref_logprob, advantage, *,
                  clip_eps=0.2):
    """(..., V) logits + (...) per-token vectors -> (logprob, entropy, kl,
    policy_loss, ratio), each shaped like targets, float32."""
    shape = targets.shape
    V = logits.shape[-1]
    outs = FusedRLLoss.apply(
        logits.reshape(-1, V), targets.reshape(-1),
        old_logprob.reshape(-1), ref_logprob.reshape(-1),
        advantage.reshape(-1), float(clip_eps))
    return tuple(o.reshape(shape) for o in outs)
