"""Share of the window the actor update's consumer spent blocked on the
TransferQueue (``tq_blocked_wait_seconds_total`` of the actor_update
task), in %."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    if not any(n == "tq_blocked_wait_seconds_total" for n, _ in d):
        return None
    wait = total(d, "tq_blocked_wait_seconds_total", "value",
                 task="actor_update")
    return 100.0 * wait / ctx["window_s"]
