"""Model FLOPs of the samples trained in the window (generation, the
reference's forward, the actor's forward and backward;
``perfbench/core/flops.py``) over the window at the bf16 peak, in %."""
from perfbench.core.flops import PEAK_BF16_FLOPS


def read(ctx):
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAK_BF16_FLOPS)
