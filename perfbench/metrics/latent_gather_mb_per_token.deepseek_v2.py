"""Bytes of latent rows the decode rounds gathered through the page table
(``rollout_kv_gather_bytes_total`` of kind latent) per token the engine
appended (``rollout_tokens_total``) in the window, in MB/token. A
latent-attention kernel that reads the pool in place takes it to 0."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    if not any(n == "rollout_kv_gather_bytes_total"
               and ("kind", "latent") in labels for n, labels in d):
        return None
    tokens = total(d, "rollout_tokens_total", "value")
    if tokens <= 0:
        return None
    return total(d, "rollout_kv_gather_bytes_total", "value",
                 kind="latent") / tokens / 1e6
