"""Rows the expert products computed (``moe_expert_rows_total``) per
pick of a live token routed to a held expert (``moe_held_picks_total``)
in the window, both phases, all layers: 1.0 means the products compute
no padding (nor idle slots' picks)."""
from perfbench.core.registry import total


def read(ctx):
    d = ctx["delta"]
    picks = total(d, "moe_held_picks_total", "value")
    if picks <= 0:
        return None
    return total(d, "moe_expert_rows_total", "value") / picks
