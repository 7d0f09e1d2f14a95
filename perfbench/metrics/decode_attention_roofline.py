"""``decode_attention``'s share of its roofline over the traced stretch:
the least time of a call (q, out, the mask and the valid keys' K and V
rows at the HBM peak, or its FLOPs at the bf16 peak, whichever is
larger; ``perfbench/core/flops.py``) over its device time, both at their
mean over the stretch's calls, in %."""
from perfbench.core import flops


def read(ctx):
    tr = ctx["trace"]
    rounds = ctx.get("decode_rounds") or []
    if tr is None or not rounds:
        return None
    times = tr.kernels(r"\bdecode_kernel\b")
    if not times:
        return None
    B, S, H, KV, hd, elem, _layers = ctx["decode_shape"]
    least = sum(flops.least_seconds(*flops.decode_attention(
        B, S, H, KV, hd, sum(keys), elem)) for keys in rounds) / len(rounds)
    return 100.0 * least / (sum(times) / len(times))
