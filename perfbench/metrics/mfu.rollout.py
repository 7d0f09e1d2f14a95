"""Model FLOPs of the tokens produced in the window (each request's
prefill with its first token, each decode step with its attention over
the cache; ``perfbench/core/flops.py``) over the window at the bf16
peak, in %."""
from perfbench.core.flops import PEAK_BF16_FLOPS


def read(ctx):
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAK_BF16_FLOPS)
