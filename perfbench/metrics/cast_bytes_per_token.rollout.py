"""Bytes the model's dtype conversions in ``dense`` and ``unembed`` read
and write (``model_cast_bytes_total``) per token the continuous engine
appended (``rollout_tokens_total``) in the window, in MB/token."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    tokens = total(d, "rollout_tokens_total", "value")
    if tokens <= 0:
        return None
    return total(d, "model_cast_bytes_total", "value") / tokens / 1e6
