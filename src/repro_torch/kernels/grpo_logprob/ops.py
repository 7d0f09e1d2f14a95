"""Wrapper: the CUDA kernel (``csrc/grpo_logprob.cu``) for CUDA tensors,
the plain version for CPU tensors, nothing else. Forward only, as the
reference's Pallas kernel is: under grad mode, on inputs that require
grad, it raises rather than drop a gradient.

The checks that raise (device, dtype, shape, contiguity and alignment,
no-grad) cost a few attribute reads each; nothing is converted or copied
that the main path's inputs (int64 targets, contiguous logits) do not
need, and the two outputs are rows of one buffer."""
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, _routes
from repro_torch.kernels.grpo_logprob.ref import grpo_logprob_ref

MAX_SPLITS = 8             # blocks a row at most: one cluster
SPLIT_BLOCKS = 4           # blocks an SM the split aims at
MIN_SPLIT_BYTES = 32 * 1024  # of the row a block keeps at least


def nsplit_for(n_sm, N, V, esize):
    """Blocks a row that the vocab entries choose (``choose_nsplit`` in
    ``csrc/vocab_pass.cuh``): the fewest of 1, 2, 4, 8 that give the card
    SPLIT_BLOCKS blocks an SM, while each block keeps MIN_SPLIT_BYTES."""
    s = 1
    while (s < MAX_SPLITS and N * s < SPLIT_BLOCKS * n_sm
           and V * esize // (2 * s) >= MIN_SPLIT_BYTES):
        s *= 2
    return s


def rows_input(name, logits, targets):
    """(logits, int64 targets) if the vocab kernels take their shapes and
    dtype, else ValueError; targets of another int type are converted."""
    if logits.dim() != 2 or targets.shape != logits.shape[:1]:
        raise ValueError(f"{name}: unsupported shapes logits="
                         f"{tuple(logits.shape)} targets="
                         f"{tuple(targets.shape)}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: logits must be float32 or bfloat16")
    return logits, targets if targets.dtype == torch.int64 else \
        targets.long()


def grpo_logprob(logits, targets, *, nsplit=0):
    """logits (N, V) float32 or bfloat16; targets (N,) int ->
    (logprob (N,), entropy (N,)), float32. Any V: the kernel masks the
    ragged tail in place. ``nsplit`` forces the blocks a row (1, 2, 4, 8);
    0 leaves the choice to the kernel's entry (``nsplit_for``)."""
    if isinstance(logits, DTensor) or logits.is_meta:
        return _routes.grpo_logprob(grpo_logprob, logits, targets,
                                    nsplit=nsplit)
    if _build.on_cpu(logits, targets):
        return grpo_logprob_ref(logits, targets)
    _build.require_no_grad("grpo_logprob", logits)
    x, tg = _build.kernel_inputs(
        "grpo_logprob", *rows_input("grpo_logprob", logits, targets))
    N, V = x.shape
    out = torch.empty((2, N), dtype=torch.float32, device=x.device)
    _build.check("grpo_logprob", _build.kernel("grpo_logprob")(
        x.data_ptr(), tg.data_ptr(), out.data_ptr(), N, V, nsplit,
        _build.DTYPE_CODES[x.dtype], _build.raw_stream(x.get_device())))
    _build.count_launch(grpo_logprob)
    return out.unbind(0)


grpo_logprob.launches = 0
