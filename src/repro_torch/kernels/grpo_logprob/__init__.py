from repro_torch.kernels.grpo_logprob.ops import grpo_logprob
from repro_torch.kernels.grpo_logprob.ref import grpo_logprob_ref

__all__ = ["grpo_logprob", "grpo_logprob_ref"]
