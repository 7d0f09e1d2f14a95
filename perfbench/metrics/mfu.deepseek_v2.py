"""Model FLOPs of the window's work on DeepSeek-V2 (its live tokens,
attention pairs by phase, held picks and appended tokens, as the
program counts them; ``perfbench/core/flops_mla_moe.py``) over the
window at the bf16 peak, in %."""
from perfbench.core.flops_mla_moe import mfu


def read(ctx):
    return mfu(ctx["cell"].config["port"], ctx["delta"], ctx["window_s"])
