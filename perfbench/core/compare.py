"""The comparisons that decide ``correct``; each number has its limit in
``perfbench/cells/<cell>.json``, set from the readings ``PERF.md`` gives."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# A leaf whose reference gradient is under this share of the median
# leaf's is moved by round-off alone (a key projection's bias under the
# softmax): its change is left out of the change comparison.
ZERO_GRAD_SHARE = 1e-3


def max_abs_gap(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> float:
    gap = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return math.inf
        if a.size:
            d = np.abs(a - b)
            if not np.all(np.isfinite(d)):
                return math.inf
            gap = max(gap, float(d.max()))
    return gap


def norm_gap(prog: Dict[tuple, float], ref: Dict[tuple, float],
             keep: Optional[set] = None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; and that leaf's name."""
    leaves = [k for k in ref if keep is None or k in keep]
    if not leaves or set(prog) != set(ref):
        return math.inf, "leaves differ"
    med = float(np.median([ref[k] for k in leaves]))
    worst, name = 0.0, ""
    for k in leaves:
        p, r = prog[k], ref[k]
        g = abs(p - r) / max(r, med, 1e-30)
        if not math.isfinite(g):
            return math.inf, "/".join(k)
        if g >= worst:
            worst, name = g, "/".join(k)
    return worst, name


def moving_leaves(ref_grad: Dict[tuple, float]) -> set:
    med = float(np.median(list(ref_grad.values())))
    return {k for k, v in ref_grad.items() if v >= ZERO_GRAD_SHARE * med}


def judge(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
