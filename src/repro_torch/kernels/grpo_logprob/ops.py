"""Wrapper: the CUDA kernel (``csrc/grpo_logprob.cu``) for CUDA tensors,
the plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient."""
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grpo_logprob.ref import grpo_logprob_ref


def grpo_logprob(logits, targets):
    """logits (N, V) float32 or bfloat16; targets (N,) int ->
    (logprob (N,), entropy (N,)), float32. Any V: the kernel masks the
    ragged tail in place."""
    if _build.on_cpu(logits, targets):
        return grpo_logprob_ref(logits, targets)
    _build.require_no_grad("grpo_logprob", logits)
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"grpo_logprob: unsupported shapes logits="
                         f"{tuple(logits.shape)} targets="
                         f"{tuple(targets.shape)}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise ValueError("grpo_logprob: logits must be float32 or bfloat16")
    logits = _build.aligned(logits)
    targets = _build.aligned(targets.to(torch.int64))
    _build.check_cuda_inputs("grpo_logprob", logits, targets)
    N, V = logits.shape
    lp = torch.empty(N, dtype=torch.float32, device=logits.device)
    ent = torch.empty_like(lp)
    err = _build.kernel("grpo_logprob")(
        logits.data_ptr(), targets.data_ptr(), lp.data_ptr(), ent.data_ptr(),
        N, V, _build.DTYPE_CODES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("grpo_logprob", err)
    _build.count_launch(grpo_logprob)
    return lp, ent


grpo_logprob.launches = 0
