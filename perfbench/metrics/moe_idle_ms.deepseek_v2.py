"""SM-idle ms a decode round of the traced serving stretch under the
round's ``moe.ffn`` spans (the expert layers: routing, dispatch, the
grouped products, the combine), over the rounds wholly inside the
stretch: a dispatch that blocks the host shows here."""
from perfbench.core.program_spans import events, idle_ns, rounds


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    evs = events(tr)
    if evs is None:
        return None
    rs = rounds(tr, evs)
    if not rs:
        return None
    ids = {r.span_id for r in rs}
    parent = {e.span_id: e.parent for e in evs}

    def in_round(e):
        p = e.parent
        while p and p not in ids:
            p = parent.get(p, 0)
        return bool(p)
    spans = [(e.start_ns, e.end_ns) for e in evs
             if e.kind == "moe.ffn" and in_round(e)]
    if not spans:
        return None
    return idle_ns(tr, spans) / len(rs) / 1e6
