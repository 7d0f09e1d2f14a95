"""The readings each limit in ``perfbench/cells/<cell>.json`` is set from.

    python3 perfbench/limits.py --workload <cell> --seeds 11 12 13 \
        [--seconds 3]

For each seed, one run of the cell (set-up, a short window at the cell's
own load, the comparison with the reference) gives the program's
readings; then, on the same prompts, samples and micro-batches, the
reference is put in the program's place with a fault planted, and read
by the same comparison:

- ``control``: the reference at the next precision down (fp8 products;
  ``reference/precision.py``);
- ``half_batch`` (training cells): each micro-batch's loss leaves out
  half of its rows, the mean taken over the rest;
- ``token_altered``: one token of each compared sample replaced after
  its logprob was taken, where it is produced;
- ``receiver_not_swapped``, ``receiver_stale`` (training cells): the
  rollout workers' weights left as they were, or of the version before
  the one they claim, at each receiver's reading.

Each entry's driver (``perfbench/drivers/<entry>.py``) reads them, in its
``readings``. A state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run. The benchmark's own runs never run this.
Prints one JSON line per seed. Needs the card.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    from perfbench.core.spec import load_cell, load_module
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("perfbench/limits.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = load_module("drivers", cell.traffic["entry"])
    for seed in args.seeds:
        t0 = time.monotonic()
        res = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         device="cuda", t_process=t0)
        line = {"workload": args.workload, "seed": seed,
                "peak_bytes": res["peak"],
                **driver.readings(cell, res, seed, "cuda")}
        line["seconds"] = time.monotonic() - t0
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
