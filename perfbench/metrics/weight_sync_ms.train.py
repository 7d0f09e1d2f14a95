"""Mean weight publish or swap in the window (``weight_sync_seconds``,
every role: the trainer's publish and each receiver's swap), in ms."""
from perfbench.core.registry import total


def read(ctx):
    n = total(ctx["delta"], "weight_sync_seconds", "count")
    if n <= 0:
        return None
    return 1e3 * total(ctx["delta"], "weight_sync_seconds", "sum") / n
