"""Rate of the weight trees' copies between device and host in the
window, the trainer's publish and the receivers' swaps together
(``weight_copy_bytes_total`` over the ``weight_copy_seconds`` sum, each
covering the copy alone), in GB/s."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    seconds = total(d, "weight_copy_seconds", "sum")
    if seconds <= 0:
        return None
    return total(d, "weight_copy_bytes_total", "value") / seconds / 1e9
