"""Share of the generate stage's busy time in the window that its calls
spent waiting for the continuous engine's lock
(``rollout_engine_wait_seconds_total`` over the generate stage's
``stage_batch_seconds``), in %."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    if not any(n == "rollout_engine_wait_seconds_total" for n, _ in d):
        return None
    busy = total(d, "stage_batch_seconds", "sum", stage="generate")
    if busy <= 0:
        return None
    return 100.0 * total(d, "rollout_engine_wait_seconds_total",
                         "value") / busy
