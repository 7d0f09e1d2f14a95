"""The run's last lines: the numbers compared on standard error, and the
result as one JSON object on standard output."""
from __future__ import annotations

import json
import math
import sys
from typing import Optional

# Top-level module names that must not be loaded in the process that
# prints a result: JAX and the JAX package the port was made from. Names
# are compared whole, since the port's own name begins with the latter's.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _finite(v):
    """A number JSON can hold: a non-finite reading prints as 1e308."""
    if isinstance(v, float) and not math.isfinite(v):
        return 1e308
    return v


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(torch, count: int, peak: int, trace=None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    return d


def emit(*, correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown: Optional[dict] = None,
         out=None) -> int:
    """Print the checks and the result; returns the exit code (1, and no
    result, if a forbidden module is loaded)."""
    out = out or sys.stdout
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules {bad} are loaded in the process that "
              "measured; the port must run without JAX", file=sys.stderr)
        return 1
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {f: _finite(v) for f, v in c.items()}
                      for k, c in checks.items()}
    print(json.dumps(line), file=out, flush=True)
    return 0
