"""Mean prefill dispatch (one length bucket) in the window
(``rollout_prefill_seconds``), in ms."""
from perfbench.core.registry import total


def read(ctx):
    n = total(ctx["delta"], "rollout_prefill_seconds", "count")
    if n <= 0:
        return None
    return 1e3 * total(ctx["delta"], "rollout_prefill_seconds", "sum") / n
