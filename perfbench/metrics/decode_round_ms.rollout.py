"""Mean continuous-batching decode round in the window
(``rollout_decode_step_seconds``), in ms."""
from perfbench.core.registry import total


def read(ctx):
    n = total(ctx["delta"], "rollout_decode_step_seconds", "count")
    if n <= 0:
        return None
    return 1e3 * total(ctx["delta"], "rollout_decode_step_seconds",
                       "sum") / n
