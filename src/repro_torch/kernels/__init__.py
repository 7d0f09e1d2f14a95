"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot paths.

Each subpackage ships ``ref.py`` (the plain PyTorch version, which the
wrapper takes for CPU tensors) and ``ops.py`` (the wrapper: checks,
launches the CUDA kernel from ``src/repro_torch/csrc/`` on PyTorch's
current stream, counts launches). ``_build.py`` compiles the sources with
``nvcc`` at first use and loads them through ``ctypes``.

  flash_attention  — causal/sliding-window GQA prefill
  decode_attention — one-query GQA attention over a masked KV cache,
                     dense or read through a page table
  grpo_logprob     — token log-prob and entropy over (N, V) logits
  fused_rl_loss    — the fused actor loss, forward and backward
  mamba_scan       — the Mamba-1 selective scan (ssm family)
  rglru_scan       — the RG-LRU linear recurrence (hybrid family)
"""
