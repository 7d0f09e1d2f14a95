"""Generate stage busy seconds per sample it produced in the window
(``stage_batch_seconds`` over ``stage_samples_total``, stage generate)."""
from perfbench.core.registry import total


def read(ctx):
    n = total(ctx["delta"], "stage_samples_total", "value", stage="generate")
    if n <= 0:
        return None
    return total(ctx["delta"], "stage_batch_seconds", "sum",
                 stage="generate") / n
