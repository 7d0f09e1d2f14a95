"""Actor update seconds (gradients and, once a step, AdamW) per sample
consumed in the window (``stage_batch_seconds`` over
``stage_samples_total``, stage actor_update)."""
from perfbench.core.registry import total


def read(ctx):
    n = total(ctx["delta"], "stage_samples_total", "value",
              stage="actor_update")
    if n <= 0:
        return None
    return total(ctx["delta"], "stage_batch_seconds", "sum",
                 stage="actor_update") / n
