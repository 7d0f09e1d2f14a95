"""Differences of the program's metrics registry between two moments.

The program's counters and histograms only grow (sums and counts), so a
window's share of any of them is its value at the window's end less its
value at the start.
"""
from __future__ import annotations

from typing import Dict, Tuple

Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def read(registry) -> Dict[Key, Dict[str, float]]:
    """{(metric, labels): {"sum", "count"} or {"value"}} of every series."""
    out = {}
    for name, fam in registry.snapshot().items():
        for s in fam["values"]:
            labels = tuple(sorted((str(k), str(v))
                                  for k, v in s.get("labels", {}).items()))
            if "count" in s:
                out[(name, labels)] = {"sum": float(s["sum"]),
                                       "count": float(s["count"])}
            elif "value" in s:
                out[(name, labels)] = {"value": float(s["value"])}
    return out


def delta(a: dict, b: dict) -> Dict[Key, Dict[str, float]]:
    """b - a, series by series (a series absent from ``a`` counts from 0)."""
    out = {}
    for k, vb in b.items():
        va = a.get(k, {})
        out[k] = {f: vb[f] - va.get(f, 0.0) for f in vb}
    return out


def total(d: dict, name: str, field: str, **labels) -> float:
    """Sum of ``field`` over the series of ``name`` whose labels include
    ``labels``."""
    want = {(str(k), str(v)) for k, v in labels.items()}
    return sum(v.get(field, 0.0) for (n, lab), v in d.items()
               if n == name and want <= set(lab))
