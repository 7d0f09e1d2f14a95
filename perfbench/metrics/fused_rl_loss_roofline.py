"""``fused_rl_loss``'s share of its roofline over the traced step: the
least time of its forward and backward calls (their bytes at the HBM
peak, ``perfbench/core/flops.py``) over their device time, in %. Calls
are taken at their mean, so a trace that misses some launches still
reads right."""
from perfbench.core import flops


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    N, V, elem = ctx["loss_shape"]
    least = used = 0.0
    for pattern, size in ((r"\bfwd_kernel\b", flops.fused_rl_loss_fwd),
                          (r"\bbwd_kernel\b", flops.fused_rl_loss_bwd)):
        times = tr.kernels(pattern, exclude="flash")
        if not times:
            return None
        least += flops.least_seconds(*size(N, V, elem))
        used += sum(times) / len(times)
    return 100.0 * least / used
