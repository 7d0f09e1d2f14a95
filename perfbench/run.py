"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``, on a
machine with as many CUDA devices as the cell asks for. The last line of
standard output is the result (JSON); the numbers compared with the
reference, each beside its limit, are the last lines of standard error.
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from one more stretch run under
the profiler after the window.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_line(cell, res, trace: bool) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or the per-layer ones
    its readers find something for (``--trace 1``)."""
    from perfbench.core.spec import load_module
    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": res["e2e"][m["name"]],
                              "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = load_module("metrics", m["name"]).read(res["ctx"])
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = _args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: src/repro_torch is missing from this checkout",
              file=sys.stderr)
        return 2
    from perfbench.core import compare, profiling, result
    from perfbench.core.spec import load_cell, load_module
    cell = load_cell(args.workload, ROOT)

    # the trainer's threads allocate and free large blocks side by side;
    # growable segments keep the freed room usable
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the program's kernels build under build/kernels/ in this checkout;
    # keep any other cache a library writes inside it too
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    driver = load_module("drivers", cell.traffic["entry"])
    res = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda",
                     t_process=T_PROCESS)
    tr = res["trace"] if args.trace else None
    breakdown = profiling.summary(tr).get("breakdown") if tr else None
    return result.emit(
        correct=compare.judge(res["checks"]), attempted=res["attempted"],
        failed=res["failed"], metrics=metrics_line(cell, res, args.trace),
        device=result.device_info(torch, cell.chips, res["peak"], tr),
        checks=res["checks"], breakdown=breakdown)


if __name__ == "__main__":
    sys.exit(main())
